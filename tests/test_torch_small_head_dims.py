"""head_dims 1, 2, 4 and 8 in ``lis_attention_fused`` and ``fused_vit_layer``:
the divisors of 128 below 16, which JAX's assert (``d % 128 == 0 or
128 % d == 0``) admits. The per-item body pads head_dim to 32 with zero
codes; the port serves them as JAX does.

On the same seeded numpy inputs: the plain ``lis_attention_fused`` against
the JAX kernel (interpret) at d = 8, 4, 2 and 1, bit for bit with LIS on;
``serving_forward(fuse_layer=True)`` at a two-layer ViT of width 64 with 8
and 16 heads against JAX's Pallas path (interpret), bit for bit with LIS on,
LIS off rel < 0.05 with argmax equal (the fp32 softmax,
tests/test_torch_staged_lisoff.py); and ``check_fits`` over the new shapes.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu.ops.attention_lis import lis_attention_fused as j_fused
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.ops import attention_lis, launch_counts, layer_fused, reset_launch_counts


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("heads", [4, 8, 16, 32])
def test_lis_attention_fused_plain_vs_jax_small_head_dims(heads):
    """TINY's geometry (2 images, 17 tokens, C = 32) at head_dims 8, 4, 2
    and 1: the plain version equals the JAX kernel (interpret) bit for bit;
    the wrapper takes it on CPU tensors."""
    qkv = np.random.RandomState(heads).randint(-128, 128, (2, 17, 96)).astype(np.int8)
    sr, sa, ro = 2.0**-11, 0.0625, 0.25
    t = attention_lis.lis_attention_fused_plain(T(qkv), heads, sr, sa, ro)
    j = np.asarray(j_fused(qkv, heads, sr, sa, ro, interpret=True))
    assert t.shape == (2, 17, 32) and len(np.unique(t.numpy())) > 10
    np.testing.assert_array_equal(t.numpy(), j)
    assert torch.equal(attention_lis.lis_attention_fused(T(qkv), heads, sr, sa, ro), t)


@pytest.mark.parametrize("dims", [(65, 64, 8, 256), (65, 64, 16, 256), (65, 64, 32, 256), (65, 64, 64, 256),
                                  (197, 384, 48, 1536), (197, 384, 96, 1536)])
def test_check_fits_takes_small_head_dims(dims):
    """C = 64 at head_dims 8, 4, 2 and 1; DeiT-S width at 8 and 4."""
    layer_fused.check_fits(*dims)
    assert attention_lis.FUSED_HEAD_DIMS == (1, 2, 4, 8, 16, 32, 64, 128)


@pytest.mark.parametrize("dims,why", [((197, 192, 64, 768), "head_dim 3"), ((65, 64, 5, 256), "head_dim 12.8"),
                                      ((17, 992, 31, 4000), "multiples of 64")])
def test_check_fits_still_refuses(dims, why):
    """A head_dim that is no divisor of 128, a fractional one, and C = 992,
    whose tiles padded to 1024 overflow shared memory (C = 32 is served,
    padded to 64: tests/test_torch_shape_faults.py)."""
    with pytest.raises(ValueError, match=f"{why}.*fuse_layer=False"):
        layer_fused.check_fits(*dims)


WIDE = {heads: ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=64, depth=2, num_heads=heads)
        for heads in (8, 16)}


@pytest.fixture(scope="module", params=[8, 16], ids=["d8", "d4"])
def state(request):
    cfg = WIDE[request.param]
    params = vit.init_params(jax.random.PRNGKey(5), cfg)
    x = np.random.RandomState(6).randn(3, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, cfg, make_policy(), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    bc = ([4, 8] * cfg.num_matmuls)[:cfg.num_matmuls]
    tcfg = tcommon.ViTConfig(**dataclasses.asdict(cfg))
    js = jserving.convert(params, calib.qstate, cfg, make_policy(), bc)
    ts = tserving.convert(tp, tq, tcfg, tmake_policy(), bc)
    return dict(cfg=cfg, tcfg=tcfg, js=js, ts=ts, x=x)


@pytest.mark.parametrize("lis", [True, False])
def test_serving_fuse_layer_small_head_dims_vs_jax(state, lis):
    """``serving_forward(fuse_layer=True)`` at width 64, head_dims 8 and 4,
    mixed bits, against JAX's Pallas path (interpret): bit for bit with LIS
    on; LIS off rel < 0.05, argmax equal. On the CPU the port's path equals
    its default path and counts no launch."""
    cfg, tcfg, x = state["cfg"], state["tcfg"], state["x"]
    layer_fused.check_fits(cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.hidden_dim)
    j = np.asarray(jserving.serving_forward(state["js"], cfg, jnp.asarray(x), use_pallas=True, interpret=True,
                                            lis=lis, fuse_layer=True))
    reset_launch_counts()
    t = tserving.serving_forward(state["ts"], tcfg, T(x), lis=lis, fuse_layer=True)
    assert set(launch_counts().values()) == {0}
    assert t.shape == (3, 16) and bool(torch.isfinite(t).all())
    assert torch.equal(t, tserving.serving_forward(state["ts"], tcfg, T(x), lis=lis))
    if lis:
        np.testing.assert_array_equal(t.numpy(), j)
    else:
        assert np.linalg.norm(t.numpy() - j) / max(np.linalg.norm(j), 1e-9) < 0.05
        assert (t.numpy().argmax(1) == j.argmax(1)).all()

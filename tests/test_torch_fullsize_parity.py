"""Full-size serving parity: the port's plain serving path against the JAX
package's ``serving_forward(use_pallas=False)`` on the same converted state,
at full width and depth, on the CPU: DeiT-S and Swin-T, and DeiT-B, ViT-L
and Swin-B, the zoo members that ``chip_smoke.py``'s zoo paths serve on the
card.

Marked ``slow`` (Tier-1 runs ``-m 'not slow'``): run it with
``python -m pytest tests/test_torch_fullsize_parity.py -m "slow and not xslow"``
(~10 min: ViT-L ~3.5 min, Swin-B ~2.5 min, DeiT-B and DeiT-S ~1 min each).

JAX draws the seeded params and calibrates on 4 seeded images; the params
and the quant state cross to the port through ``interop``. Both sides
convert the same bit config and serve the same 2 images. The logits are held
bit for bit, and so are the weight codes ``convert`` froze. This pins the
gap between serving and the fake-quant simulation at full size (rel
0.069-0.081 on DeiT-S, ROADMAP queue 3) on the JAX package's own design,
not on the port.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu import serving_swin as jserving_swin
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import SWIN_ZOO, VIT_ZOO, swin, vit
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch import serving_swin as tserving_swin
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin

pytestmark = pytest.mark.slow


def _to_port(tree):
    return jax.tree.map(np.asarray, tree)


def _images(seed, n, size):
    return np.random.RandomState(seed).randn(n, 3, size, size).astype(np.float32)


def _vit_parity(name, eager=False):
    """JAX's seeded params calibrated on 4 images, W4A8 ``[4]*num_matmuls``
    on both sides, 2 images served: the weight codes and the logits bit for
    bit. ``eager``: JAX serves op by op (``jax.disable_jit``), its own
    sequence of operations, and the logits of its jitted forward are
    returned beside the port's."""
    cfg = VIT_ZOO[name]
    tcfg = tcommon.ViTConfig(**dataclasses.asdict(cfg))
    policy = make_policy()
    params = vit.init_params(jax.random.PRNGKey(0), cfg)
    calib = vit.calibrate(params, cfg, policy, jnp.asarray(_images(1, 4, cfg.img_size)))
    bits = [4] * cfg.num_matmuls
    x = _images(2, 2, cfg.img_size)
    js = jserving.convert(params, calib.qstate, cfg, policy, bits)
    j = np.asarray(jserving.serving_forward(js, cfg, jnp.asarray(x), use_pallas=False))
    j_jit = j
    if eager:
        with jax.disable_jit():
            j = np.asarray(jserving.serving_forward(js, cfg, jnp.asarray(x), use_pallas=False, scan_layers=False))
    tp = interop.params_from_numpy(_to_port(params), device="cpu")
    tq = interop.qstate_from_numpy(_to_port(calib.qstate), device="cpu")
    ts = tserving.convert(tp, tq, tcfg, tmake_policy(), bits)
    for blk_j, blk_t in zip(js["blocks"], ts["blocks"]):
        for layer in ("qkv", "proj", "mlp_fc1", "fc2"):
            np.testing.assert_array_equal(blk_t[layer]["w_q"].numpy(), np.asarray(blk_j[layer]["w_q"]))
    t = tserving.serving_forward(ts, tcfg, torch.from_numpy(x), use_kernels=False).numpy()
    assert t.shape == j.shape == (2, cfg.num_classes)
    assert int((t != j).sum()) == 0
    return t, j_jit


def test_deit_s_fullsize_serving_bitwise_vs_jax():
    """DeiT-S, W4A8 ``[4]*50``: 0 of 2,000 logits differ (no traced flip
    reaches the logits on these images)."""
    _vit_parity("deit_small_patch16_224")


def test_deit_b_fullsize_serving_bitwise_vs_jax():
    """DeiT-B (C = 768, 12 heads), W4A8: 0 of 2,000 logits differ."""
    _vit_parity("deit_base_patch16_224")


def test_vit_l_fullsize_serving_bitwise_vs_jax_op_by_op():
    """ViT-L (C = 1024, 16 heads, depth 24), W4A8: 0 of 2,000 logits differ
    from JAX's forward op by op. JAX's jitted forward is no reference at
    this depth: XLA:CPU compiles the whole forward and rewrites its float
    arithmetic, and the moved codes compound over 24 layers. Its default
    form past depth 12 (``scan_layers``) differs from JAX's own op-by-op
    forward in 1,270 of 2,000 logits (up to 4 codes of s_out), its unrolled
    form in 874 (up to 2), and the two jitted forms from each other in
    1,285; at depth 13 all three agree."""
    t, j_jit = _vit_parity("vit_large_patch16_224", eager=True)
    print(f"ViT-L: the port against JAX's jitted forward: {int((t != j_jit).sum())} of {t.size} logits differ")


def _swin_parity(name):
    """JAX's seeded params calibrated on 4 images, W4 ``convert(4)`` on both
    sides, 2 images served: the logits bit for bit."""
    cfg = SWIN_ZOO[name]
    tcfg = tswin.SwinConfig(**dataclasses.asdict(cfg))
    policy = make_policy()
    params = swin.init_params(jax.random.PRNGKey(0), cfg)
    calib = swin.calibrate(params, cfg, policy, jnp.asarray(_images(1, 4, cfg.img_size)))
    x = _images(2, 2, cfg.img_size)
    js = jserving_swin.convert(params, calib.qstate, cfg, policy, 4)
    j = np.asarray(jserving_swin.serving_forward(js, calib.qstate, cfg, policy, jnp.asarray(x),
                                                 use_pallas=False))
    tp = interop.params_from_numpy(_to_port(params), device="cpu")
    tq = interop.qstate_from_numpy(_to_port(calib.qstate), device="cpu")
    ts = tserving_swin.convert(tp, tq, tcfg, tmake_policy(), 4)
    t = tserving_swin.serving_forward(ts, tq, tcfg, tmake_policy(), torch.from_numpy(x),
                                      use_kernels=False).numpy()
    assert t.shape == j.shape == (2, cfg.num_classes)
    assert int((t != j).sum()) == 0


def test_swin_t_fullsize_serving_bitwise_vs_jax():
    """Swin-T, W4 ``convert(4)``: 0 of 2,000 logits differ (the int-LN flips
    at 4C = 1536, 2 of 393,216 codes on random rows, do not occur on this
    calibrated state)."""
    _swin_parity("swin_tiny_patch4_window7_224")


def test_swin_b_fullsize_serving_bitwise_vs_jax():
    """Swin-B (C = 128, depths (2, 2, 18, 2), heads 4–32), W4: 0 of 2,000
    logits differ."""
    _swin_parity("swin_base_patch4_window7_224")

"""uint8 ingestion in the port: raw images against the host-normalized
float32 path, and against the JAX package's uint8 serving entry.

The host pipeline emits ``(u/255 − mean)/std`` in float32; the port replays
that op sequence on the device (``serving.attach_u8_ingest``). The input
domain is 256 values × 3 channels, so ``u8_ingest_exact`` proves the
ingestion by enumeration; the logits checks cover the wiring around it.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu import serving_swin as jss
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import swin, vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch import serving_swin as tss
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin

MEAN = (0.485, 0.456, 0.406)
STD = (0.229, 0.224, 0.225)
TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TTINY = tcommon.ViTConfig(**dataclasses.asdict(TINY))
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                        depths=(2, 2), num_heads=(2, 2), window_size=4)
TSTINY = tswin.SwinConfig(**dataclasses.asdict(STINY))
# (fuse_embed and fuse_qkv, lis)
FLAGS = {"fused": (True, True), "staged": (False, True), "fused_lisoff": (True, False),
         "staged_lisoff": (False, False)}


def _host_normalize(u8):
    """The host transform's tail: uint8 CHW → /255 → normalize, float32."""
    mean = np.asarray(MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(STD, np.float32).reshape(3, 1, 1)
    return (u8.astype(np.float32) / np.float32(255.0) - mean) / std


def _u8_batch(shape, seed=0):
    u8 = np.random.RandomState(seed).randint(0, 256, shape, dtype=np.uint8)
    u8[0, :, 0, 0] = 0  # the clip corners
    u8[0, :, 0, 1] = 255
    return u8


@pytest.fixture(scope="module")
def vit_setup():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    bits = [8] * TINY.num_matmuls
    js = jserving.attach_u8_ingest(jserving.convert(params, calib.qstate, TINY, make_policy(), bits),
                                   MEAN, STD)
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    ts = tserving.convert(interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"), tq, TTINY,
                          tmake_policy(), bits)
    tserving.attach_u8_ingest(ts, MEAN, STD)
    return js, ts


def test_u8_consts_equal_jax(vit_setup):
    js, ts = vit_setup
    for key in ("mean", "std", "a", "b", "lut"):
        np.testing.assert_array_equal(ts["u8"][key].numpy(), np.asarray(js["u8"][key]), err_msg=key)
    assert ts["u8"]["lut"].shape == (256, 3) and ts["u8"]["lut"].dtype == torch.int8
    np.testing.assert_array_equal(ts["u8"]["host"].numpy()[:, :, None, None],
                                  _host_normalize(np.arange(256, dtype=np.uint8)[:, None, None, None]
                                                  .repeat(3, 1)))


def test_u8_exact_proven_by_enumeration(vit_setup):
    _, ts = vit_setup
    assert tserving.u8_ingest_exact(ts)


def test_u8_affine_claim_is_the_enumeration(vit_setup):
    """``u8_ingest_exact(affine=True)`` reports whether u·a + b, rounded as
    two float32 operations, hits the golden table on all 768 cases."""
    _, ts = vit_setup
    u8 = ts["u8"]
    v = np.arange(256, dtype=np.float32)[:, None]
    two_roundings = np.clip(np.round(v * u8["a"].numpy()[None] + u8["b"].numpy()[None]), -128, 127)
    want = bool((two_roundings == u8["lut"].numpy()).all())
    got = tserving.u8_ingest_exact(ts, affine=True)
    print(f"u8 affine ingest exact on the CPU: {got}")
    assert got == want


@pytest.mark.parametrize("flags", list(FLAGS))
def test_u8_serving_logits_bit_equal(vit_setup, flags):
    """uint8 logits equal the logits of the same images normalized on the
    host, at the fused and staged flags, LIS on and off."""
    _, ts = vit_setup
    fuse, lis = FLAGS[flags]
    kw = dict(fuse_embed=fuse, fuse_qkv=fuse, lis=lis)
    u8 = _u8_batch((2, 3, 32, 32))
    a = tserving.serving_forward(ts, TTINY, torch.from_numpy(_host_normalize(u8)), **kw)
    b = tserving.serving_forward(ts, TTINY, torch.from_numpy(u8), **kw)
    assert torch.equal(a, b)


def test_u8_serving_bitwise_vs_jax(vit_setup):
    """The port's uint8 entry against JAX's (use_pallas=False)."""
    js, ts = vit_setup
    u8 = _u8_batch((2, 3, 32, 32), seed=3)
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(u8), use_pallas=False))
    t = tserving.serving_forward(ts, TTINY, torch.from_numpy(u8)).numpy()
    np.testing.assert_array_equal(t, j)


def test_u8_affine_codes_follow_the_claim(vit_setup):
    """Where the affine is proven exact its codes are the literal ones; where
    not, some input code differs, which is why it stays off by default."""
    _, ts = vit_setup
    u8 = torch.from_numpy(_u8_batch((2, 3, 32, 32), seed=4))
    same = torch.equal(tserving._input_codes(ts, u8, u8_affine=True), tserving._input_codes(ts, u8))
    if tserving.u8_ingest_exact(ts, affine=True):
        assert same
    else:
        full = torch.arange(256, dtype=torch.uint8)[None, None, :, None].expand(1, 3, 256, 1)
        assert not torch.equal(tserving._input_codes(ts, full, u8_affine=True),
                               tserving._input_codes(ts, full))


def test_u8_without_attach_raises():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    ts = tserving.convert(interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
                          interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu"), TTINY,
                          tmake_policy(), [8] * TINY.num_matmuls)
    with pytest.raises(ValueError, match="attach_u8_ingest"):
        tserving.serving_forward(ts, TTINY, torch.from_numpy(_u8_batch((1, 3, 32, 32))))


@pytest.fixture(scope="module")
def swin_setup():
    params = swin.init_params(jax.random.PRNGKey(0), STINY)
    x = np.random.RandomState(1).randn(2, 3, 32, 32).astype(np.float32)
    calib = swin.calibrate(params, STINY, make_policy(), jnp.asarray(x))
    js = jss.attach_u8_ingest(jss.convert(params, calib.qstate, STINY, make_policy(), 8), MEAN, STD)
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    ts = tss.convert(interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"), tq, TSTINY,
                     tmake_policy(), 8)
    return js, ts, calib.qstate, tq


@pytest.mark.parametrize("lis", [True, False])
def test_u8_swin_serving_logits_bit_equal(swin_setup, lis):
    _, ts, _, tq = swin_setup
    u8 = _u8_batch((2, 3, 32, 32), seed=2)
    with pytest.raises(ValueError, match="attach_u8_ingest"):
        tss.serving_forward(ts, tq, TSTINY, tmake_policy(), torch.from_numpy(u8))
    s8 = tss.attach_u8_ingest(dict(ts), MEAN, STD)
    assert tserving.u8_ingest_exact(s8)
    with pytest.raises(ValueError, match="affine"):
        tserving.u8_ingest_exact(s8, affine=True)
    a = tss.serving_forward(s8, tq, TSTINY, tmake_policy(), torch.from_numpy(_host_normalize(u8)),
                            lis=lis)
    b = tss.serving_forward(s8, tq, TSTINY, tmake_policy(), torch.from_numpy(u8), lis=lis)
    assert torch.equal(a, b)


def test_u8_swin_dequant_vs_jax(swin_setup):
    """The Swin uint8 replay equals JAX's ``_u8_dequant`` value for value."""
    js, ts, _, _ = swin_setup
    s8 = tss.attach_u8_ingest(dict(ts), MEAN, STD)
    u8 = _u8_batch((2, 3, 32, 32), seed=5)
    np.testing.assert_array_equal(tss._u8_dequant(s8, torch.from_numpy(u8)).numpy(),
                                  np.asarray(jss._u8_dequant(js, jnp.asarray(u8))))
    np.testing.assert_array_equal(tss._u8_dequant(s8, torch.from_numpy(u8)).numpy(),
                                  _host_normalize(u8))

"""The port's ViT model (init, fp forward, calibrate, quant_forward) against
the JAX package at TINY geometry, on the same numpy parameters and images."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.config import make_policy
from p2vit_tpu.models import vit
from p2vit_tpu.models.common import ViTConfig, extract_patches, vit_flops
from p2vit_tpu_torch import interop
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import VIT_ZOO
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import vit as tvit

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TTINY = tcommon.ViTConfig(**dataclasses.asdict(TINY))


@pytest.fixture(scope="module")
def setup():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(1).randn(4, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    pn = jax.tree.map(np.asarray, params)
    tp = interop.params_from_numpy(pn, device="cpu")
    tcal = tvit.calibrate(tp, TTINY, tmake_policy(), torch.from_numpy(x))
    return dict(params=params, pn=pn, tp=tp, x=x, calib=calib, tcal=tcal)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda v: isinstance(v, torch.Tensor))[0]


def test_interop_params(setup):
    jl, tl = _leaves(setup["pn"]), _leaves(setup["tp"])
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        assert isinstance(b, torch.Tensor) and b.dtype == torch.float32
        np.testing.assert_array_equal(a, b.numpy())
    qs = interop.qstate_from_numpy(jax.tree.map(np.asarray, setup["calib"].qstate), device="cpu")
    assert len(_leaves(qs)) == len(_leaves(setup["calib"].qstate))


def test_config_and_zoo():
    assert TTINY.num_matmuls == TINY.num_matmuls and TTINY.seq_len == TINY.seq_len
    s = VIT_ZOO["deit_small_patch16_224"]
    assert (s.embed_dim, s.depth, s.num_heads, s.seq_len, s.hidden_dim) == (384, 12, 6, 197, 1536)
    assert tcommon.vit_flops(s) == vit_flops(ViTConfig(embed_dim=384, depth=12, num_heads=6))


def test_extract_patches_layout():
    x = np.random.RandomState(2).randn(2, 3, 16, 16).astype(np.float32)
    np.testing.assert_array_equal(np.asarray(extract_patches(jnp.asarray(x), 8)),
                                  tcommon.extract_patches(torch.from_numpy(x), 8).numpy())


def test_fp_forward_close(setup):
    j = np.asarray(vit.fp_forward(setup["params"], TINY, jnp.asarray(setup["x"])))
    t = tvit.fp_forward(setup["tp"], TTINY, torch.from_numpy(setup["x"])).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_calibrate_decisions_equal(setup):
    """Every quantization decision is equal: PoT scales (activations and
    every weight-scale row), PTF masks, SmoothQuant channel scales. The PTF
    nodes' base scale is max|x|/127.5/8, a float of the fp activations,
    whose summation order differs between the frameworks: those agree to
    1e-6 relative (measured ≤ 2.3e-7), their masks exactly."""
    jl = _leaves(setup["calib"].qstate)
    tl = _leaves(setup["tcal"].qstate)
    assert len(jl) == len(tl) == 77
    n_exact = 0
    for (pa, a), (pb, b) in zip(jl, tl):
        key = jax.tree_util.keystr(pa)
        assert key == jax.tree_util.keystr(pb)
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, key
        ptf_float = key.endswith("['scale']") and a.ndim == 1 and "qact0" not in key
        if ptf_float:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)
            n_exact += 1
    assert n_exact >= 60
    np.testing.assert_allclose(setup["tcal"].global_distance.numpy(),
                               np.asarray(setup["calib"].global_distance), rtol=1e-5)
    assert setup["tcal"].flops == setup["calib"].flops


@pytest.mark.parametrize("bits", [[8], [4], [4, 8]])
def test_quant_forward_matches_jax(setup, bits):
    """Same qstate (the JAX calibration through interop) in both packages:
    the simulated logits agree within 1e-5 relative."""
    n = TINY.num_matmuls
    bc = (bits * n)[:n]
    j = np.asarray(vit.quant_forward(setup["params"], setup["calib"].qstate, TINY, make_policy(),
                                     jnp.asarray(setup["x"]), vit.bits_to_idx(bc)))
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, setup["calib"].qstate), device="cpu")
    t = tvit.quant_forward(setup["tp"], tq, TTINY, tmake_policy(), torch.from_numpy(setup["x"]),
                           tvit.bits_to_idx(bc)).numpy()
    rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-9)
    assert rel < 1e-5, rel
    assert (t.argmax(1) == j.argmax(1)).all()


def test_bits_to_idx():
    assert tvit.bits_to_idx([4, 8, 4]).tolist() == [0, 1, 0]
    with pytest.raises(ValueError, match="unsupported bit widths"):
        tvit.bits_to_idx([4, 6])


def test_init_params_seeded():
    a = tvit.init_params(3, TTINY, device="cpu")
    b = tvit.init_params(3, TTINY, device="cpu")
    torch.testing.assert_close(a["blocks"][1]["fc2"]["w"], b["blocks"][1]["fc2"]["w"], rtol=0, atol=0)
    w = a["blocks"][0]["qkv"]["w"]
    assert w.shape == (96, 32) and float(w.abs().max()) <= 0.04 + 1e-7

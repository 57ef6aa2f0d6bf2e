"""The port's Swin model (window helpers, init, fp forward, calibrate,
quant_forward) against the JAX package at TINY geometry, on the same numpy
parameters and images."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.config import make_policy
from p2vit_tpu.models import SWIN_ZOO as JSWIN_ZOO
from p2vit_tpu.models import swin
from p2vit_tpu.models.vit import bits_to_idx
from p2vit_tpu_torch import interop
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import SWIN_ZOO
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models.vit import bits_to_idx as tbits_to_idx

TINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                       depths=(2, 2), num_heads=(2, 2), window_size=4)
TTINY = tswin.SwinConfig(**dataclasses.asdict(TINY))
MIXED = ([8] + [4, 8, 8, 4] * 5)[:TINY.num_matmuls]


@pytest.fixture(scope="module")
def setup():
    params = swin.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(1).randn(3, 3, 32, 32).astype(np.float32)
    calib = swin.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    pn = jax.tree.map(np.asarray, params)
    tp = interop.params_from_numpy(pn, device="cpu")
    tcal = tswin.calibrate(tp, TTINY, tmake_policy(), torch.from_numpy(x))
    return dict(params=params, pn=pn, tp=tp, x=x, calib=calib, tcal=tcal)


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda v: isinstance(v, torch.Tensor))[0]


@pytest.mark.parametrize("h,ws,shift", [(8, 4, 2), (56, 7, 3), (28, 7, 3)])
def test_window_helpers_exact(h, ws, shift):
    """window_partition/reverse move the same elements; the rel-pos index and
    the shift mask are the JAX package's arrays exactly."""
    x = np.random.RandomState(h).randn(2, h, h, 6).astype(np.float32)
    tw = tswin.window_partition(torch.from_numpy(x), ws)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(swin.window_partition(jnp.asarray(x), ws)))
    np.testing.assert_array_equal(tswin.window_reverse(tw, ws, h, h).numpy(), x)
    np.testing.assert_array_equal(tswin.relative_position_index(ws), swin.relative_position_index(ws))
    m = tswin.shift_attn_mask(h, h, ws, shift)
    np.testing.assert_array_equal(m, swin.shift_attn_mask(h, h, ws, shift))
    assert m.dtype == np.float32 and m.shape == ((h // ws) ** 2, ws * ws, ws * ws)


def test_config_zoo_flops_and_layout():
    for name, jc in JSWIN_ZOO.items():
        tc = SWIN_ZOO[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.num_matmuls == jc.num_matmuls and tc.num_features == jc.num_features
        assert tswin.swin_flops(tc) == swin.swin_flops(jc)
        assert tswin.mixed_layout(tc) == swin.mixed_layout(jc)
    t = SWIN_ZOO["swin_tiny_patch4_window7_224"]
    assert [t.window(i) for i in range(4)] == [7, 7, 7, 7]
    assert [t.shift(i, 1) for i in range(4)] == [3, 3, 3, 0]  # stage 3 is one 7×7 window


def test_interop_swin_trees(setup):
    """Swin pytrees convert leaf for leaf; the bias-free reductions stay None."""
    jl, tl = _leaves(setup["pn"]), _leaves(setup["tp"])
    assert [jax.tree_util.keystr(p) for p, _ in jl] == [jax.tree_util.keystr(p) for p, _ in tl]
    for (_, a), (_, b) in zip(jl, tl):
        np.testing.assert_array_equal(a, b.numpy())
    assert setup["tp"]["stages"][0]["downsample"]["reduction"]["b"] is None
    qs = interop.qstate_from_numpy(jax.tree.map(np.asarray, setup["calib"].qstate), device="cpu")
    assert len(_leaves(qs)) == len(_leaves(setup["calib"].qstate)) == 144


def test_fp_forward_close(setup):
    j = np.asarray(swin.fp_forward(setup["params"], TINY, jnp.asarray(setup["x"])))
    t = tswin.fp_forward(setup["tp"], TTINY, torch.from_numpy(setup["x"])).numpy()
    assert t.shape == (3, 10)
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_calibrate_decisions_equal(setup):
    """Every quantization decision is equal: PoT activation scales, every
    weight-scale row, zero points, PTF masks. The PTF (channel-wise) base
    scales are floats of the fp activations, whose summation order differs
    between the frameworks: within 1e-6 relative (measured ≤ 2.3e-7)."""
    jl, tl = _leaves(setup["calib"].qstate), _leaves(setup["tcal"].qstate)
    assert len(jl) == len(tl) == 144
    n_exact = 0
    for (pa, a), (pb, b) in zip(jl, tl):
        key = jax.tree_util.keystr(pa)
        assert key == jax.tree_util.keystr(pb)
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, key
        if key.endswith("['scale']") and a.ndim == 1:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)
            n_exact += 1
    assert n_exact >= 120
    np.testing.assert_allclose(setup["tcal"].global_distance.numpy(),
                               np.asarray(setup["calib"].global_distance), rtol=1e-5)
    assert setup["tcal"].flops == setup["calib"].flops


@pytest.mark.parametrize("bits", ["w8", "w4", "mixed"])
def test_quant_forward_matches_jax(setup, bits):
    """Same qstate (JAX's, through interop) in both packages: the simulated
    logits agree within 1e-5 relative (measured: equal)."""
    x = setup["x"]
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, setup["calib"].qstate), device="cpu")
    if bits == "mixed":
        j = swin.quant_forward_mixed(setup["params"], setup["calib"].qstate, TINY, make_policy(),
                                     jnp.asarray(x), bits_to_idx(MIXED))
        t = tswin.quant_forward_mixed(setup["tp"], tq, TTINY, tmake_policy(), torch.from_numpy(x),
                                      tbits_to_idx(MIXED))
    else:
        wb = int(bits[1:])
        j = swin.quant_forward(setup["params"], setup["calib"].qstate, TINY, make_policy(),
                               jnp.asarray(x), wb)
        t = tswin.quant_forward(setup["tp"], tq, TTINY, tmake_policy(), torch.from_numpy(x), wb)
    j, t = np.asarray(j), t.numpy()
    assert np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-9) < 1e-5
    assert (t.argmax(1) == j.argmax(1)).all()


def test_init_params_seeded():
    a = tswin.init_params(3, TTINY, device="cpu")
    b = tswin.init_params(3, TTINY, device="cpu")
    for (_, u), (_, v) in zip(_leaves(a), _leaves(b)):
        assert torch.equal(u, v)
    blk = a["stages"][1]["blocks"][0]
    assert blk["qkv"]["w"].shape == (96, 32) and blk["bias_table"].shape == (49, 2)
    assert float(blk["qkv"]["w"].abs().max()) <= 0.04 + 1e-7
    assert a["stages"][0]["downsample"]["reduction"]["b"] is None
    assert "downsample" not in a["stages"][1]

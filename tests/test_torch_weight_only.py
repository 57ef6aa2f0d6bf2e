"""Weight-only serving: the port's ``serving.weight_only_params`` and
``serving_swin.weight_only_params`` against the JAX package's, at TINY, on
the same params and quant state (JAX's calibration carried across by
``interop``).

The effective weights are bit for bit JAX's (w_q·sw, and w_q·sw/cs on the
SmoothQuant layers: powers of two, so every operation is exact); requantizing
them gives ``convert``'s codes; every other leaf is the caller's tensor; and
the float32 ``fp_forward`` on them agrees with JAX's at the tolerance of the
port's ``fp_forward`` tests (rtol 1e-5, atol 1e-6).
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
from p2vit_tpu.models import swin, vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch import serving_swin as tserving_swin
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models import vit as tvit

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TTINY = tcommon.ViTConfig(**dataclasses.asdict(TINY))
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 2), window_size=4)
TSTINY = tswin.SwinConfig(**dataclasses.asdict(STINY))


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda v: isinstance(v, torch.Tensor))[0]


def _same_tree(t, j):
    tl, jl = _leaves(t), _leaves(j)
    assert [p for p, _ in tl] == [p for p, _ in jl]
    for (path, a), (_, b) in zip(tl, jl):
        assert a.dtype == torch.float32, path
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=str(path))


def _requant(w_eff, layer, lo, hi, smooth):
    if smooth:
        w_eff = w_eff * layer["cs"][None, :]
    codes = torch.clamp(torch.round(w_eff / layer["sw"][:, None]), lo, hi).to(torch.int8)
    assert torch.equal(codes, layer["w_q"])


def _bounds(bit):
    return (-8, 7) if bit == 4 else (-128, 127)


@pytest.fixture(scope="module")
def vit_state():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(11).randn(4, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    n = TINY.num_matmuls
    bits = ([4, 8] * n)[:n]
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    jw = jserving.weight_only_params(params, calib.qstate, TINY, make_policy(), bits)
    tw = tserving.weight_only_params(tp, tq, TTINY, tmake_policy(), bits)
    return dict(params=params, tp=tp, tq=tq, x=x, bits=bits, jw=jw, tw=tw)


def test_vit_weight_only_params_bitwise_vs_jax(vit_state):
    _same_tree(vit_state["tw"], jax.tree.map(np.asarray, vit_state["jw"]))


def test_vit_weight_only_params_roundtrip_to_convert_codes(vit_state):
    """Requantizing each effective weight with the serving scales gives
    convert()'s codes bit for bit, the SmoothQuant fold included."""
    tw, bits = vit_state["tw"], vit_state["bits"]
    s = tserving.convert(vit_state["tp"], vit_state["tq"], TTINY, tmake_policy(), bits)
    _requant(tw["patch_embed"]["w"], s["patch"], *_bounds(bits[0]), False)
    _requant(tw["head"]["w"], s["head"], *_bounds(bits[-1]), False)
    for i, (nb, sb) in enumerate(zip(tw["blocks"], s["blocks"])):
        bq, bp, b1, b2 = bits[1 + 4 * i: 5 + 4 * i]
        _requant(nb["qkv"]["w"], sb["qkv"], *_bounds(bq), True)
        _requant(nb["proj"]["w"], sb["proj"], *_bounds(bp), False)
        _requant(nb["fc1"]["w"], sb["mlp_fc1"], *_bounds(b1), True)
        _requant(nb["fc2"]["w"], sb["fc2"], *_bounds(b2), False)


def test_vit_weight_only_params_leaves_the_rest_untouched(vit_state):
    tp, tw = vit_state["tp"], vit_state["tw"]
    for key in ("cls_token", "pos_embed", "norm"):
        assert tw[key] is tp[key]
    assert tw["head"]["b"] is tp["head"]["b"]
    for nb, blk in zip(tw["blocks"], tp["blocks"]):
        assert nb["norm1"] is blk["norm1"] and nb["qkv"]["b"] is blk["qkv"]["b"]
        assert not torch.equal(nb["qkv"]["w"], blk["qkv"]["w"])
    assert not torch.equal(tw["patch_embed"]["w"], tp["patch_embed"]["w"])


def test_vit_weight_only_fp_forward_vs_jax(vit_state):
    x = vit_state["x"]
    j = np.asarray(vit.fp_forward(vit_state["jw"], TINY, jnp.asarray(x)))
    t = tvit.fp_forward(vit_state["tw"], TTINY, torch.from_numpy(x)).numpy()
    assert t.shape == (4, TINY.num_classes) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_vit_weight_only_params_rejects_ptf_false(vit_state):
    with pytest.raises(ValueError, match="weight-only serving"):
        tserving.weight_only_params(vit_state["tp"], {}, TTINY, tmake_policy(ptf=False),
                                    [8] * TINY.num_matmuls)


@pytest.fixture(scope="module")
def swin_state():
    params = swin.init_params(jax.random.PRNGKey(0), STINY)
    x = np.random.RandomState(1).randn(3, 3, 32, 32).astype(np.float32)
    calib = swin.calibrate(params, STINY, make_policy(), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    jw = jserving_swin.weight_only_params(params, calib.qstate, STINY, make_policy(), 4)
    tw = tserving_swin.weight_only_params(tp, tq, TSTINY, tmake_policy(), 4)
    return dict(tp=tp, tq=tq, x=x, jw=jw, tw=tw)


def test_swin_weight_only_params_bitwise_vs_jax(swin_state):
    _same_tree(swin_state["tw"], jax.tree.map(np.asarray, swin_state["jw"]))


def test_swin_weight_only_params_roundtrip_and_rest_untouched(swin_state):
    """Every effective weight, the PatchMerging reduction included,
    requantizes to convert()'s codes; the other leaves are the caller's."""
    tp, tw = swin_state["tp"], swin_state["tw"]
    s = tserving_swin.convert(tp, swin_state["tq"], TSTINY, tmake_policy(), 4)
    _requant(tw["patch_embed"]["w"], s["patch"], -8, 7, False)
    _requant(tw["head"]["w"], s["head"], -8, 7, False)
    for stage, st, orig in zip(tw["stages"], s["stages"], tp["stages"]):
        for blk, sb, ob in zip(stage["blocks"], st["blocks"], orig["blocks"]):
            for key in ("qkv", "proj", "fc1", "fc2"):
                _requant(blk[key]["w"], sb[key], -8, 7, False)
                assert blk[key]["b"] is ob[key]["b"]
            assert blk["bias_table"] is ob["bias_table"] and blk["norm1"] is ob["norm1"]
        if "downsample" in stage:
            _requant(stage["downsample"]["reduction"]["w"], st["downsample"]["red"], -8, 7, False)
            assert stage["downsample"]["norm"] is orig["downsample"]["norm"]
    assert tw["patch_norm"] is tp["patch_norm"] and tw["norm"] is tp["norm"]


def test_swin_weight_only_fp_forward_vs_jax(swin_state):
    x = swin_state["x"]
    j = np.asarray(swin.fp_forward(swin_state["jw"], STINY, jnp.asarray(x)))
    t = tswin.fp_forward(swin_state["tw"], TSTINY, torch.from_numpy(x)).numpy()
    assert t.shape == (3, STINY.num_classes) and np.isfinite(t).all()
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)


def test_swin_weight_only_params_inherits_convert_preconditions(swin_state):
    with pytest.raises(ValueError, match="PTF"):
        tserving_swin.weight_only_params(swin_state["tp"], swin_state["tq"], TSTINY,
                                         tmake_policy(ptf=False), 4)

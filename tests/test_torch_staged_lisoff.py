"""The staged ViT serving path, ``lis_attention_fused`` and ``lis_attention``,
and every LIS-off attention arm of the port against the JAX package, on the
same seeded numpy inputs: the Pallas kernels run with ``interpret=True``, the
jnp twins as they are.

Stated bounds, measured on these inputs:
* LIS on, both new kernels' plain versions equal the JAX kernels bit for bit
  at TINY and DeiT-S width, at s_attn = 2^-11 too;
* the staged path equals the port's fused path and JAX's staged Pallas path
  bit for bit at TINY, W8, W4 and mixed;
* LIS off, the port's fp32 softmax (float64 exp rounded once, float64 sums
  rounded once; ops/attention_lis.py) against JAX's (float32 exp and sums):
  |Δcode| ≤ 1 on at most 0.1 % of the codes, each count stated below;
* LIS-off serving end to end: rel < 0.05 and argmax equal;
* LIS-off calibration: every PoT and bit decision equal to JAX's, the float
  scales within 1e-6 relative.
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
from p2vit_tpu.ops.attention_lis import lis_attention as j_split
from p2vit_tpu.ops.attention_lis import lis_attention_fused as j_fused
from p2vit_tpu.ops.attention_lis import lis_attention_qkv_fused as j_qkv_fused
from p2vit_tpu.ops.attention_lis import lis_attention_ref
from p2vit_tpu.ops.attention_lis import swin_lis_attention as j_swin
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch import serving_swin as tss
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.ops import attention_lis, launch_counts, reset_launch_counts

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TTINY = tcommon.ViTConfig(**dataclasses.asdict(TINY))
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                        depths=(2, 2), num_heads=(2, 2), window_size=4)
TSTINY = tswin.SwinConfig(**dataclasses.asdict(STINY))
BITS = {"w8": [8], "w4": [4], "mixed": [4, 8]}
# (images, tokens, width, heads): TINY's, and DeiT-S's N = 197, C = 384, 6 heads
GEOM = {"tiny": (2, 17, 32, 2), "deit_s": (2, 197, 384, 6)}
# (score_requant, s_attn, out_requant); s_attn = 2^-11 is the scale random-init
# DeiT-S calibrates to, where the LIS exp_sum passes 2^63
SCALES = {"s11": (2.0**-12, 2.0**-11, 1.0), "s4": (2.0**-11, 0.0625, 0.25)}


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


def _flips(j, t):
    """(count, share, max |Δ|) of the codes in which ``t`` differs from ``j``."""
    d = np.abs(np.asarray(j).astype(np.int32) - np.asarray(t).astype(np.int32))
    return int((d != 0).sum()), float((d != 0).mean()), int(d.max())


def _qkv_codes(seed, b, n, c):
    return np.random.RandomState(seed).randint(-128, 128, (b, n, 3 * c)).astype(np.int8)


def _split(qkv, heads):
    """(B, N, 3C) → q, k, v of (B·H, N, d), as numpy."""
    b, n, c3 = qkv.shape
    d = c3 // 3 // heads
    parts = qkv.reshape(b, n, 3, heads, d).transpose(2, 0, 3, 1, 4).reshape(3, b * heads, n, d)
    return parts[0], parts[1], parts[2]


# ---------------------------------------------------------------------------
# LIS on: the two new kernels' plain versions, bit for bit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scales", list(SCALES))
@pytest.mark.parametrize("geom", list(GEOM))
def test_lis_attention_fused_plain_vs_jax(geom, scales):
    """Against the JAX kernel (interpret: rows padded to 32, keys masked)."""
    b, n, c, heads = GEOM[geom]
    qkv = _qkv_codes(1, b, n, c)
    sr, sa, ro = SCALES[scales]
    t = attention_lis.lis_attention_fused_plain(T(qkv), heads, sr, sa, ro)
    j = j_fused(qkv, heads, sr, sa, ro, interpret=True)
    assert t.shape == (b, n, c) and t.dtype == torch.int8
    assert len(np.unique(t.numpy())) > 10
    assert n_diff(j, t) == 0
    # the wrapper takes the plain version on CPU tensors
    assert torch.equal(attention_lis.lis_attention_fused(T(qkv), heads, sr, sa, ro), t)


@pytest.mark.parametrize("scales", list(SCALES))
@pytest.mark.parametrize("geom", list(GEOM))
def test_lis_attention_plain_vs_jax(geom, scales):
    """Split (B·H, N, d) q/k/v against the JAX kernel (interpret: rows and
    head dims padded to 128) and its jnp twin."""
    b, n, c, heads = GEOM[geom]
    q, k, v = _split(_qkv_codes(2, b, n, c), heads)
    sr, sa, ro = SCALES[scales]
    t = attention_lis.lis_attention_plain(T(q), T(k), T(v), sr, sa, ro)
    assert t.shape == q.shape and t.dtype == torch.int8
    assert n_diff(j_split(q, k, v, sr, sa, ro, interpret=True), t) == 0
    assert n_diff(lis_attention_ref(q, k, v, sr, sa, ro), t) == 0
    assert torch.equal(attention_lis.lis_attention(T(q), T(k), T(v), sr, sa, ro), t)


# ---------------------------------------------------------------------------
# LIS off: every arm, within one code on a stated count
# ---------------------------------------------------------------------------

# (score_requant, s_attn, out_requant): scores spread the logits over ±8
LISOFF = (2.0**-11, 0.0625, 2.0)


def _check_lisoff(name, j, t, stated):
    count, share, worst = _flips(j, t)
    print(f"LIS-off {name}: {count} of {t.numel()} codes differ from JAX ({share:.2e}), max |d| {worst}")
    assert worst <= 1 and share <= 1e-3
    assert count == stated


@pytest.mark.parametrize("arm,stated", [("qkv_fused", 0), ("fused", 1), ("split", 0)])
def test_lisoff_vit_arms_vs_jax(arm, stated):
    """The three ViT LIS-off plain versions at DeiT-S width (2 images, 151k
    codes) against the JAX kernels (interpret) and, for the split form, the
    jnp twin ``lis_attention_ref(lis=False)``."""
    b, n, c, heads = GEOM["deit_s"]
    sr, sa, ro = LISOFF
    if arm == "qkv_fused":
        rng = np.random.RandomState(3)
        h = rng.randint(-128, 128, (b, n, c)).astype(np.int8)
        w = rng.randint(-128, 128, (3 * c, c)).astype(np.int8)
        rv = (2.0 ** rng.randint(-13, -10, 3 * c)).astype(np.float32)
        bv = rng.randn(3 * c).astype(np.float32)
        t = attention_lis.lis_attention_qkv_fused_plain(T(h), T(w), T(rv), T(bv), heads, sr, sa, ro,
                                                        lis=False)
        j = j_qkv_fused(h, w, rv, bv, heads, sr, sa, ro, lis=False, images_per_step=2, interpret=True)
    elif arm == "fused":
        qkv = _qkv_codes(4, b, n, c)
        t = attention_lis.lis_attention_fused_plain(T(qkv), heads, sr, sa, ro, lis=False)
        j = j_fused(qkv, heads, sr, sa, ro, lis=False, interpret=True)
    else:
        q, k, v = _split(_qkv_codes(5, b, n, c), heads)
        t = attention_lis.lis_attention_plain(T(q), T(k), T(v), sr, sa, ro, lis=False)
        j = lis_attention_ref(q, k, v, sr, sa, ro, lis=False)
    assert len(np.unique(t.numpy())) > 20
    _check_lisoff(arm, j, t, stated)


@pytest.mark.parametrize("mask_kind,stated", [(None, 0), ("shift", 0)])
def test_lisoff_swin_vs_jax(mask_kind, stated):
    """Swin's 7×7 windows (N = 49, d = 32), with and without the shift mask,
    against the JAX kernel (interpret) at s2 = 2^-4."""
    rng = np.random.RandomState(6)
    heads, n_win, images = 2, 4, 2
    qkv = rng.randint(-128, 128, (images * n_win, 49, 3 * 32 * heads)).astype(np.int8)
    bias = (rng.randn(heads, 49, 49) * 0.3).astype(np.float32)
    s2 = np.float32(2.0**-4)
    mask = None if mask_kind is None else swin.shift_attn_mask(14, 14, 7, 3) / s2
    args = (heads, n_win, 2.0**-9, np.float32(2.0**-4), s2, np.float32(2.0))
    t = attention_lis.swin_lis_attention_plain(T(qkv), T(bias), None if mask is None else T(mask),
                                               *args, lis=False)
    j = j_swin(qkv, bias, mask, *args, lis=False, interpret=True)
    assert len(np.unique(t.numpy())) > 20
    _check_lisoff(f"swin mask={mask_kind}", j, t, stated)


def test_lisoff_swin_skips_the_lis_scale_bound():
    """The LIS exact-sum bound (s ≥ 2^-20) holds the LIS arm only."""
    qkv = np.zeros((4, 49, 192), np.int8)
    bias = np.zeros((2, 49, 49), np.float32)
    args = (T(qkv), T(bias), None, 2, 4, 2.0**-9, 2.0**-4, 2.0**-21, 1.0)
    with pytest.raises(ValueError, match="2\\^-20"):
        attention_lis.swin_lis_attention(*args)
    assert attention_lis.swin_lis_attention(*args, lis=False).shape == (4, 49, 64)


# ---------------------------------------------------------------------------
# The staged path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def vit_state():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(11).randn(4, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    return dict(params=params, calib=calib, tp=tp, tq=tq, x=x)


def _bit_config(name):
    n = TINY.num_matmuls
    return (BITS[name] * n)[:n]


@pytest.mark.parametrize("bits", list(BITS))
def test_staged_path_bitwise_vs_fused_and_jax(vit_state, bits):
    """``fuse_embed=False, fuse_qkv=False``: equal to the port's default path
    and to JAX's staged Pallas path (interpret) bit for bit, prologue codes
    and logits; the staged forward makes the stated plain calls."""
    bc = _bit_config(bits)
    js = jserving.convert(vit_state["params"], vit_state["calib"].qstate, TINY, make_policy(), bc)
    ts = tserving.convert(vit_state["tp"], vit_state["tq"], TTINY, tmake_policy(), bc)
    x = T(vit_state["x"])
    staged = dict(fuse_embed=False, fuse_qkv=False)
    h_s, xc_s = tserving.embed_codes(ts, TTINY, x, fuse_embed=False)
    h_f, xc_f = tserving.embed_codes(ts, TTINY, x)
    assert torch.equal(h_s, h_f) and torch.equal(xc_s, xc_f)
    reset_launch_counts()
    t = tserving.serving_forward(ts, TTINY, x, **staged)
    assert set(launch_counts().values()) == {0}
    np.testing.assert_array_equal(t.numpy(), tserving.serving_forward(ts, TTINY, x).numpy())
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(vit_state["x"]), use_pallas=True,
                                            interpret=True, **staged))
    np.testing.assert_array_equal(t.numpy(), j)
    assert tserving.launches_per_forward(TTINY, **staged) == {
        "int8_matmul_res_ln": 4, "int8_matmul_requant": 6, "int_ln_requant": 1,
        "lis_attention_fused": 2}


def test_staged_lisoff_equals_fused_lisoff(vit_state):
    """LIS off, the staged and the fused flags run the same plain arithmetic:
    equal logits (the kernels are held to the same on the card)."""
    ts = tserving.convert(vit_state["tp"], vit_state["tq"], TTINY, tmake_policy(), _bit_config("w4"))
    x = T(vit_state["x"])
    a = tserving.serving_forward(ts, TTINY, x, lis=False)
    b = tserving.serving_forward(ts, TTINY, x, lis=False, fuse_embed=False, fuse_qkv=False)
    assert torch.equal(a, b) and bool(torch.isfinite(a).all())


# ---------------------------------------------------------------------------
# LIS-off calibration and serving end to end
# ---------------------------------------------------------------------------


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda v: isinstance(v, torch.Tensor))[0]


def _pin_decisions(jq, tq, n_leaves, min_exact):
    """Every leaf equal but the channel-wise (PTF) float scales, which agree
    within 1e-6 relative (maxes of fp activations summed in another order)."""
    jl, tl = _leaves(jq), _leaves(tq)
    assert len(jl) == len(tl) == n_leaves
    n_exact = 0
    for (pa, a), (pb, b) in zip(jl, tl):
        key = jax.tree_util.keystr(pa)
        assert key == jax.tree_util.keystr(pb)
        a, b = np.asarray(a), b.numpy()
        assert a.shape == b.shape, key
        if key.endswith("['scale']") and a.ndim == 1 and "qact0" not in key:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)
            n_exact += 1
    assert n_exact >= min_exact


@pytest.fixture(scope="module")
def vit_lisoff(vit_state):
    x = vit_state["x"]
    jcal = vit.calibrate(vit_state["params"], TINY, make_policy(lis=False), jnp.asarray(x))
    tcal = tvit.calibrate(vit_state["tp"], TTINY, tmake_policy(lis=False), T(x))
    return jcal, tcal


def test_lisoff_vit_calibration_decisions_equal(vit_lisoff):
    jcal, tcal = vit_lisoff
    _pin_decisions(jcal.qstate, tcal.qstate, 77, 60)
    np.testing.assert_allclose(tcal.global_distance.numpy(), np.asarray(jcal.global_distance),
                               rtol=1e-5)


@pytest.mark.parametrize("flags", ["fused", "staged"])
def test_lisoff_vit_serving_end_to_end(vit_state, vit_lisoff, flags):
    """make_policy(lis=False) → calibrate → convert(W4A8) → serving_forward
    (lis=False): against JAX's Pallas path (interpret) on JAX's calibration,
    and against the port's simulation on the port's: rel < 0.05, argmax equal."""
    jcal, tcal = vit_lisoff
    bc = _bit_config("w4")
    kw = {} if flags == "fused" else dict(fuse_embed=False, fuse_qkv=False)
    x = vit_state["x"]
    js = jserving.convert(vit_state["params"], jcal.qstate, TINY, make_policy(lis=False), bc)
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(x), interpret=True, lis=False, **kw))
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, jcal.qstate), device="cpu")
    ts = tserving.convert(vit_state["tp"], tq, TTINY, tmake_policy(lis=False), bc)
    t = tserving.serving_forward(ts, TTINY, T(x), lis=False, **kw).numpy()
    ts2 = tserving.convert(vit_state["tp"], tcal.qstate, TTINY, tmake_policy(lis=False), bc)
    srv = tserving.serving_forward(ts2, TTINY, T(x), lis=False, **kw).numpy()
    sim = tvit.quant_forward(vit_state["tp"], tcal.qstate, TTINY, tmake_policy(lis=False), T(x),
                             tvit.bits_to_idx(bc)).numpy()
    for got, want in ((t, j), (srv, sim)):
        assert np.isfinite(got).all()
        assert np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-9) < 0.05
        assert (got.argmax(1) == want.argmax(1)).all()


@pytest.fixture(scope="module")
def swin_lisoff():
    params = swin.init_params(jax.random.PRNGKey(0), STINY)
    x = np.random.RandomState(11).randn(4, 3, 32, 32).astype(np.float32)
    jcal = swin.calibrate(params, STINY, make_policy(lis=False), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tcal = tswin.calibrate(tp, TSTINY, tmake_policy(lis=False), T(x))
    return dict(params=params, tp=tp, x=x, jcal=jcal, tcal=tcal)


def test_lisoff_swin_calibration_decisions_equal(swin_lisoff):
    _pin_decisions(swin_lisoff["jcal"].qstate, swin_lisoff["tcal"].qstate, 144, 120)


def test_lisoff_swin_serving_end_to_end(swin_lisoff):
    """make_policy(lis=False) → calibrate → convert(4) → serving_forward:
    against JAX's Pallas path (interpret) on the same state, and against the
    port's simulation on the port's calibration: rel < 0.05, argmax equal."""
    st = swin_lisoff
    x = st["x"]
    pol, tpol = make_policy(lis=False), tmake_policy(lis=False)
    js = jss.convert(st["params"], st["jcal"].qstate, STINY, pol, 4)
    j = np.asarray(jss.serving_forward(js, st["jcal"].qstate, STINY, pol, jnp.asarray(x),
                                       interpret=True))
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, st["jcal"].qstate), device="cpu")
    t = tss.serving_forward(tss.convert(st["tp"], tq, TSTINY, tpol, 4), tq, TSTINY, tpol, T(x)).numpy()
    tcal = st["tcal"]
    srv = tss.serving_forward(tss.convert(st["tp"], tcal.qstate, TSTINY, tpol, 4), tcal.qstate,
                              TSTINY, tpol, T(x)).numpy()
    sim = tswin.quant_forward(st["tp"], tcal.qstate, TSTINY, tpol, T(x), 4).numpy()
    for got, want in ((t, j), (srv, sim)):
        assert np.isfinite(got).all()
        assert np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-9) < 0.05
        assert (got.argmax(1) == want.argmax(1)).all()

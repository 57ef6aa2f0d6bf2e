"""The port's Swin int8 serving path and its three new kernels' plain
versions against the JAX package at TINY geometry, on the same seeded numpy
inputs: the Pallas kernels run with ``interpret=True``, the jnp twins as
they are.

Stated bounds, all measured on these inputs:
* every kernel's plain version equals the JAX kernel and twin bit for bit;
* the int-LN at 4C = 1536 channels (Swin-T's widest PatchMerging row), whose
  float32 row sums in JAX pass 2^24 on every row while the port's are exact
  integers: 2 flipped codes in 393,216, both traced to JAX's float32 Σx²;
* the fp patch stem: 0 flipped codes. Its float32 matmul is exact in any
  summation order (products of int8 codes and power-of-two scales, sums
  below 2^20 units), and the bias add and the PoT divide round once alike;
* serving logits from identical stem codes: bit for bit, W8, W4 and mixed.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving_swin as jss
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import swin
from p2vit_tpu.ops.attention_lis import swin_lis_attention as j_swin_attn
from p2vit_tpu.ops.intln import int_ln_requant as j_ln
from p2vit_tpu.ops.intln import int_res_ln_requant as j_res_ln
from p2vit_tpu.ops.intln import int_res_ln_requant_ref
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving_swin as tss
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.ops import _lib, attention_lis, intln, launch_counts, reset_launch_counts

TINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                       depths=(2, 2), num_heads=(2, 2), window_size=4)
TTINY = tswin.SwinConfig(**dataclasses.asdict(TINY))
BITS = {"w8": 8, "w4": 4, "mixed": ([8] + [4, 8, 8, 4] * 5)[:TINY.num_matmuls]}
# Swin-T's window (7×7, shift 3) and its final 49-token mean, at TINY width
WIN7 = swin.SwinConfig(img_size=56, patch_size=4, num_classes=10, embed_dim=16,
                       depths=(2, 2), num_heads=(2, 2), window_size=7)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


def _ptf(rng, n, base):
    """PTF scale vector base·2^k, k ∈ {0..3}: LN masks {1, 2, 4, 8}."""
    return (base * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)


# ---------------------------------------------------------------------------
# int_ln_requant
# ---------------------------------------------------------------------------


def _ln_inputs(seed, m, c):
    rng = np.random.RandomState(seed)
    codes = rng.randint(-128, 128, (m, c)).astype(np.int8)
    s_in = _ptf(rng, c, 0.013)
    return (codes, np.round(s_in / s_in.min()).astype(np.float32), s_in.min(),
            rng.randn(c).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32),
            (np.abs(rng.randn(c)) * 0.03 + 0.01).astype(np.float32),
            (2.0 ** rng.randint(-1, 2, c)).astype(np.float32))


@pytest.mark.parametrize("m,c", [(70, 16), (300, 96)])
def test_int_ln_requant_plain_vs_jax(m, c):
    """Against the JAX kernel (interpret) at TINY and Swin-T patch-norm width."""
    args = _ln_inputs(c, m, c)
    t = intln.int_ln_requant_plain(*map(T, args))
    j = j_ln(*args, interpret=True)
    assert t.dtype == torch.int8 and t.shape == (m, c)
    assert n_diff(j, t) == 0


def _ln_with_jax_sums(x, s1, ln_w, ln_b, out_scale, ratio=1.0):
    """The port's LN chain on aligned codes ``x`` (numpy float32), fed the
    float32 row sums JAX forms instead of its own exact ones."""
    c = x.shape[-1]
    sx = T(np.asarray(jnp.sum(jnp.asarray(x), axis=1)))[:, None]
    sxx = T(np.asarray(jnp.sum(jnp.asarray(x) * jnp.asarray(x), axis=1)))[:, None]
    vecs, s1v = intln.ln_requant_consts(c, torch.device("cpu"), 1.0, s1, T(ln_w), T(ln_b),
                                        T(out_scale), T(ratio))
    y = intln.ln_mn_chain(T(x), sx, sxx, s1v[0], float(c), vecs[1][None], vecs[2][None])
    return torch.clamp(torch.round(y * vecs[3][None]), -128, 127)


def test_int_ln_requant_4c_flips_traced():
    """4C = 1536 (Swin-T's widest PatchMerging LN), 256 rows, PTF masks
    {1, 2, 4, 8}. Every row's Σx² passes 2^24 (about 2^27), where the JAX
    kernel's float32 sum is off the exact one on 122 of 256 rows. Stated
    count: 2 flipped codes of 393,216, both traced to that sum: the port's
    chain fed the float32 sums JAX forms gives JAX's codes bit for bit."""
    m, c = 256, 1536
    args = _ln_inputs(c, m, c)
    t = intln.int_ln_requant_plain(*map(T, args))
    j = np.asarray(j_ln(*args, interpret=True))
    x = args[0].astype(np.float32) * args[1]
    xi = x.astype(np.int64)
    assert ((xi * xi).sum(1) > 2**24).all()
    assert n_diff(j, t) == 2
    f_sxx = T(np.asarray(jnp.sum(jnp.asarray(x) * jnp.asarray(x), axis=1)))[:, None]
    assert (f_sxx != intln.row_sums(T(x))[1]).sum() == 122
    assert n_diff(j, _ln_with_jax_sums(x, *args[2:])) == 0


def test_iln_expand4_vs_jax():
    """The PatchMerging LN: the producer's (C,) PTF scale tiled ×4 over the
    4C concat, through both packages' ``_iln``."""
    rng = np.random.RandomState(5)
    c = 32
    codes = rng.randint(-128, 128, (2, 16, 4 * c)).astype(np.int8)
    s_in = _ptf(rng, c, 0.011)
    lnp = {"w": rng.randn(4 * c).astype(np.float32), "b": (rng.randn(4 * c) * 0.1).astype(np.float32)}
    out_scale = np.float32(2.0**-4)
    j = jss._iln(jnp.asarray(codes), s_in, lnp, out_scale, expand=4, interpret=True)
    jr = jss._iln(jnp.asarray(codes), s_in, lnp, out_scale, expand=4, use_pallas=False)
    t = tss._iln(T(codes), T(s_in), {k: T(v) for k, v in lnp.items()}, T(out_scale), expand=4,
                 use_kernels=False)
    assert t.shape == codes.shape
    assert n_diff(j, t) == 0 and n_diff(jr, t) == 0


# ---------------------------------------------------------------------------
# int_res_ln_requant
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,fma_flips", [(16, 1), (96, 10), (384, 25)])
def test_int_res_ln_requant_plain_vs_ref(c, fma_flips):
    """The Swin junction with the serving path's scale kinds: a per-channel
    PTF (non-PoT) shortcut scale, a PoT scalar branch scale, a PTF s_out.

    Bit for bit against the jnp twin ``int_res_ln_requant_ref`` run op by
    op: a·s_a and b·s_b are rounded on their own, then added. The JAX
    kernel (interpret) and the jitted twin differ from it in
    ``fma_flips`` residual codes of 200·C (stated count): XLA:CPU contracts
    the add into a fused multiply-add, so their sum is rounded once. Traced:
    their residual codes equal the once-rounded sum exactly, and every LN
    code they differ in lies in a row holding such a residual flip (0, 3
    and 5 LN codes at C = 16, 96, 384)."""
    rng = np.random.RandomState(c)
    m = 200
    args = (rng.randint(-128, 128, (m, c)).astype(np.int8), _ptf(rng, c, 0.011),
            rng.randint(-128, 128, (m, c)).astype(np.int8), np.float32(2.0**-5),
            _ptf(rng, c, 0.017), rng.randn(c).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32), np.float32(2.0**-4), 1.0)
    t = intln.int_res_ln_requant_plain(*(T(a) if isinstance(a, np.ndarray) else a for a in args))
    jr = int_res_ln_requant_ref(*args)
    for i in range(2):
        assert t[i].dtype == torch.int8 and t[i].shape == (m, c)
        assert n_diff(jr[i], t[i]) == 0
    j = j_res_ln(*args, interpret=True)
    assert n_diff(j[0], t[0]) == n_diff(jax.jit(int_res_ln_requant_ref)(*args)[0], t[0]) == fma_flips
    a, sa, b, sb, so = args[:5]
    once = (a.astype(np.float64) * sa + b.astype(np.float64) * np.float64(sb)).astype(np.float32)
    inv = np.float32(1.0) / np.maximum(so, np.float32(1e-30))
    assert n_diff(j[0], np.clip(np.round(once * inv), -128, 127)) == 0
    res_rows = set(np.nonzero(np.asarray(j[0]) != t[0].numpy())[0])
    assert set(np.nonzero(np.asarray(j[1]) != t[1].numpy())[0]) <= res_rows


# ---------------------------------------------------------------------------
# swin_lis_attention
# ---------------------------------------------------------------------------


def _attn_inputs(seed, images, n_win, heads, mask_kind, ws=7):
    rng = np.random.RandomState(seed)
    n, c = ws * ws, 32 * heads
    qkv = rng.randint(-128, 128, (images * n_win, n, 3 * c)).astype(np.int8)
    bias = (rng.randn(heads, n, n) * 0.3).astype(np.float32)
    s2 = np.float32(2.0**-4)
    mask = None
    if mask_kind == "shift":
        res = int(round(n_win**0.5)) * ws
        mask = swin.shift_attn_mask(res, res, ws, ws // 2) / s2
    elif mask_kind == "distinct":  # one mask per window of the image
        mask = (-100.0 * (rng.rand(n_win, n, n) < 0.3)).astype(np.float32) / s2
    # the node scales serving hands the kernel: s_qkv = 2^-6, s_attn1 = 2^-4,
    # s_qact3 = 2^-4; rq and ro formed in float32 as serving_forward forms them
    s_qkv, s_attn1, s3 = np.float32(2.0**-6), np.float32(2.0**-4), np.float32(2.0**-4)
    rq = s_qkv**2 * np.float32(32**-0.5) / s_attn1
    return qkv, bias, mask, heads, n_win, rq, s_attn1, s2, s_qkv / s3


@pytest.mark.parametrize("case", ["no_mask", "shift_mask", "mask_chunks"])
def test_swin_lis_attention_plain_vs_jax(case):
    """N = 49, d = 32 against the JAX kernel (interpret, which pads rows to
    56 and keys to 64) and the jnp twin ``_window_attention_codes_vals``.
    ``mask_chunks``: 64 windows per image with a distinct mask each, so a
    wrong ``i % n_windows`` pick changes the output."""
    images, n_win, heads, kind = {"no_mask": (1, 4, 2, None), "shift_mask": (2, 4, 2, "shift"),
                                  "mask_chunks": (2, 64, 1, "distinct")}[case]
    qkv, bias, mask, heads, n_win, rq, s1, s2, ro = _attn_inputs(7, images, n_win, heads, kind)
    t = attention_lis.swin_lis_attention_plain(T(qkv), T(bias), None if mask is None else T(mask),
                                               heads, n_win, rq, s1, s2, ro)
    j = j_swin_attn(qkv, bias, mask, heads, n_win, rq, s1, s2, ro, interpret=True)
    s_qkv = np.float32(2.0**-6)  # the twin takes the node scales (_attn_inputs)
    jt = jss._window_attention_codes_vals(jnp.asarray(qkv), bias, None if mask is None else mask * s2,
                                          True, heads, s_qkv, s1, s2, s_qkv / ro)
    assert t.shape == (images * n_win, 49, 32 * heads) and t.dtype == torch.int8
    assert len(np.unique(t.numpy())) > 20  # the LIS chain was exercised
    assert n_diff(j, t) == 0 and n_diff(jt, t) == 0


def test_swin_lis_attention_checks_the_lis_scale():
    qkv, bias, _, heads, n_win, rq, s1, _, ro = _attn_inputs(8, 1, 4, 2, None)
    with pytest.raises(ValueError, match="2\\^-20"):
        attention_lis.swin_lis_attention(T(qkv), T(bias), None, heads, n_win, rq, s1, 2.0**-21, ro)


# ---------------------------------------------------------------------------
# The serving path
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def state():
    params = swin.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(11).randn(4, 3, 32, 32).astype(np.float32)
    calib = swin.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    return dict(params=params, calib=calib, tp=tp, tq=tq, x=x)


@functools.partial(jax.jit, static_argnums=3)
def _jax_stem(js, qstate, x, cfg=TINY):
    """The JAX package's default fp patch stem (serving_swin.serving_forward,
    ``int_stem=False, fuse_stem=False``), up to the patch-norm codes."""
    q0 = jnp.clip(jnp.round(x / js["s_input"] + js["zp_input"]), -128, 127)
    x = (q0 - js["zp_input"]) * js["s_input"]
    pw = js["patch"]["w_q"].astype(jnp.float32) * js["patch"]["sw"][:, None]
    px = swin._patches(x, cfg.patch_size)
    sq_bn = qstate["patch_qact_bn"]["scale"]
    xc = jnp.clip(jnp.round((px @ pw.T + js["patch_b"]) / sq_bn), -128, 127).astype(jnp.int8)
    return jss._iln(xc, sq_bn, js["patch_norm"], qstate["patch_qact"]["scale"], use_pallas=False)


def _converted(state, bits):
    js = jss.convert(state["params"], state["calib"].qstate, TINY, make_policy(), BITS[bits])
    ts = tss.convert(state["tp"], state["tq"], TTINY, tmake_policy(), BITS[bits])
    return js, ts


def test_stem_codes_vs_jax(state):
    """Stated tolerance of the fp stem: 0 flipped codes (module docstring)."""
    js, ts = _converted(state, "w8")
    j = np.asarray(_jax_stem(js, state["calib"].qstate, jnp.asarray(state["x"])))
    t = tss.stem_codes(ts, state["tq"], TTINY, T(state["x"]), use_kernels=False)
    assert t.shape == (4, 64, 16) and j.shape == t.shape
    assert n_diff(j, t) == 0


@pytest.mark.parametrize("bits", list(BITS))
def test_serving_bitwise_vs_jax_from_identical_stem_codes(state, bits, monkeypatch):
    """The port's serving_forward, fed JAX's stem codes, equals JAX's
    serving_forward(use_pallas=False) and its Pallas path (interpret) bit
    for bit; the frozen weight codes are equal."""
    js, ts = _converted(state, bits)
    x = jnp.asarray(state["x"])
    qs = state["calib"].qstate
    j = np.asarray(jss.serving_forward(js, qs, TINY, make_policy(), x, use_pallas=False))
    stem = T(np.asarray(_jax_stem(js, qs, x)))
    monkeypatch.setattr(tss, "stem_codes", lambda *a, **k: stem)
    t = tss.serving_forward(ts, state["tq"], TTINY, tmake_policy(), T(state["x"]))
    assert t.dtype == torch.float32 and t.shape == (4, 10)
    np.testing.assert_array_equal(t.numpy(), j)
    if bits == "w8":
        jp = np.asarray(jss.serving_forward(js, qs, TINY, make_policy(), x, interpret=True))
        np.testing.assert_array_equal(t.numpy(), jp)
    for st_j, st_t in zip(js["stages"], ts["stages"]):
        for b_j, b_t in zip(st_j["blocks"], st_t["blocks"]):
            for layer in ("qkv", "proj", "fc1", "fc2"):
                np.testing.assert_array_equal(b_t[layer]["w_q"].numpy(), np.asarray(b_j[layer]["w_q"]))
        if "downsample" in st_j:
            np.testing.assert_array_equal(st_t["downsample"]["red"]["w_q"].numpy(),
                                          np.asarray(st_j["downsample"]["red"]["w_q"]))


def test_serving_bitwise_vs_jax_at_window7():
    """Swin-T's 7×7 windows (49-token panels, shift 3 with 4 masks) and its
    final 49-token mean, at TINY width: bit for bit against JAX's default
    path (Pallas kernels, interpret) from identical stem codes."""
    cfg, tcfg = WIN7, tswin.SwinConfig(**dataclasses.asdict(WIN7))
    params = swin.init_params(jax.random.PRNGKey(2), cfg)
    x = np.random.RandomState(12).randn(2, 3, 56, 56).astype(np.float32)
    calib = swin.calibrate(params, cfg, make_policy(), jnp.asarray(x))
    js = jss.convert(params, calib.qstate, cfg, make_policy(), 4)
    j = np.asarray(jss.serving_forward(js, calib.qstate, cfg, make_policy(), jnp.asarray(x),
                                       interpret=True))
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    ts = tss.convert(interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"), tq, tcfg,
                     tmake_policy(), 4)
    stem = np.asarray(_jax_stem(js, calib.qstate, jnp.asarray(x), cfg))
    assert n_diff(stem, tss.stem_codes(ts, tq, tcfg, T(x))) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tss, "stem_codes", lambda *a, **k: T(stem))
        t = tss.serving_forward(ts, tq, tcfg, tmake_policy(), T(x)).numpy()
    assert tcfg.stage_res(1) ** 2 == 49 and tcfg.shift(0, 1) == 3
    np.testing.assert_array_equal(t, j)


def test_token_mean_codes_vs_jax():
    """The final token mean over Swin-T's 49 tokens → qact3 codes, against
    the JAX package's expression (XLA's mean is sum·fl(1/49)). At
    s2/s3 = 1/2, sums that are odd multiples of 49 put the mean on a rounding
    tie; there the quotient is an integer, and sum·fl(1/49) hits it for
    every multiple of 49 a row of int8 codes can sum to."""
    codes = np.random.RandomState(13).randint(-128, 128, (512, 49, 96)).astype(np.int8)
    s2, s3 = np.float32(2.0**-6), np.float32(2.0**-5)
    j = jnp.clip(jnp.round(jnp.asarray(codes).astype(jnp.float32).mean(axis=1) * s2 / s3), -128, 127)
    t = tss._mean_codes(T(codes), T(s2), T(s3))
    ties = (codes.astype(np.int64).sum(1) % 98 == 49).sum()
    assert ties > 300 and t.shape == (512, 96)
    assert n_diff(j, t) == 0
    k = np.arange(-128, 128)
    assert ((49 * k).astype(np.float32) * (np.float32(1) / np.float32(49)) == k).all()


def test_serving_lis_off_plain_path_vs_jax(state):
    """The LIS-off fp softmax (float64 exp and sums, each rounded once, in
    the plain version and the kernel): equal to JAX's at this seed."""
    js, ts = _converted(state, "w8")
    j = np.asarray(jss.serving_forward(js, state["calib"].qstate, TINY, make_policy(),
                                       jnp.asarray(state["x"]), use_pallas=False, lis=False))
    t = tss.serving_forward(ts, state["tq"], TTINY, tmake_policy(), T(state["x"]), lis=False).numpy()
    assert np.isfinite(t).all()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("w_bit", [8, 4])
def test_serving_matches_port_simulation(state, w_bit):
    """Port serving against the port's quant_forward on the port's own
    calibration: inside the JAX package's envelope (rel < 0.05, argmax equal)."""
    x = T(state["x"])
    calib = tswin.calibrate(state["tp"], TTINY, tmake_policy(), x)
    sim = tswin.quant_forward(state["tp"], calib.qstate, TTINY, tmake_policy(), x, w_bit).numpy()
    ts = tss.convert(state["tp"], calib.qstate, TTINY, tmake_policy(), w_bit)
    srv = tss.serving_forward(ts, calib.qstate, TTINY, tmake_policy(), x).numpy()
    assert np.linalg.norm(srv - sim) / max(np.linalg.norm(sim), 1e-9) < 0.05
    assert (sim.argmax(1) == srv.argmax(1)).all()


def test_kernel_and_plain_paths_agree_on_cpu_with_the_stated_calls(state, monkeypatch):
    """On CPU tensors the wrappers take their plain versions: the two paths
    agree, no launch is counted, nothing is built, and one forward makes the
    plain calls ``launches_per_forward`` states."""
    ts = tss.convert(state["tp"], state["tq"], TTINY, tmake_policy(), 4)
    x = T(state["x"])
    calls = {}
    for mod, name in ((attention_lis, "swin_lis_attention_plain"), (intln, "int_ln_requant_plain"),
                      (intln, "int_res_ln_requant_plain"), (tss.matmul_ln, "int8_matmul_res_ln_plain"),
                      (tss.matmul_int8, "int8_matmul_requant_plain")):
        for entry in (name, name.replace("_plain", "_prepared_plain")):
            fn = getattr(mod, entry)

            def rec(*a, _fn=fn, _k=name.replace("_plain", ""), **k):
                calls[_k] = calls.get(_k, 0) + 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, entry, rec)
    reset_launch_counts()
    a = tss.serving_forward(ts, state["tq"], TTINY, tmake_policy(), x)
    assert set(launch_counts().values()) == {0}
    assert calls == tss.launches_per_forward(TTINY)
    assert torch.equal(a, tss.serving_forward(ts, state["tq"], TTINY, tmake_policy(), x,
                                              use_kernels=False))
    assert _lib.library.cache_info().currsize == 0


def test_unported_inputs_and_settings_raise(state):
    ts = tss.convert(state["tp"], state["tq"], TTINY, tmake_policy(), 8)
    with pytest.raises(ValueError, match="attach_u8_ingest"):
        tss.serving_forward(ts, state["tq"], TTINY, tmake_policy(),
                            torch.zeros(1, 3, 32, 32, dtype=torch.uint8))
    with pytest.raises(ValueError, match="integer-LN"):
        tss.convert(state["tp"], state["tq"], TTINY, tmake_policy(ptf=False), 8)
    with pytest.raises(ValueError, match="entries"):
        tss.convert(state["tp"], state["tq"], TTINY, tmake_policy(), [8, 4])
    with pytest.raises(KeyError, match="qact_input"):
        tss.convert(state["tp"], {k: v for k, v in state["tq"].items() if k != "qact_input"},
                    TTINY, tmake_policy(), 8)

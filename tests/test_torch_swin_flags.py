"""The port's Swin serving flags (``fuse_stem``, ``int_stem``,
``fold_windows``, ``fuse_res=False``) and their two kernels' plain versions
(``fused_swin_stem_plain``, ``swin_lis_attention_folded_plain``) against the
JAX package at TINY geometry, on the same seeded numpy inputs. The Pallas
kernels run with ``interpret=True`` where a flag needs one; elsewhere JAX runs
``use_pallas=False``.

Stated counts, all measured on these inputs:
* ``fused_swin_stem_plain``: 0 flipped codes against the JAX kernel and its
  twin on power-of-two inputs (every partial sum of the dot is exact) and on
  random-normal inputs at TINY width (32 × 16); at Swin-T width on 4096
  random-normal rows, 2 of 393,216 codes against the JAX kernel and 1
  against its twin, whose two float32 dot orders differ from each other in
  3. The port sums k = 0..47 in order, each product and add rounded alone.
* ``swin_lis_attention_folded_plain``: 0 flips against the JAX kernel, LIS
  on and off, with and without the shift mask, at 4×4 and 7×7 windows.
* serving with each flag against JAX with the same flag: logits bit for bit
  (0 differing) for ``fold_windows``, ``fuse_stem``, ``int_stem`` (input zero
  point 0 and +3) and ``fuse_res=False``. The unfused junction's
  a·s_a + b·s_b can round once in XLA:CPU's jitted forward (FMA contraction)
  and twice in the port; on this seed no code differs.
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
from p2vit_tpu.ops.attention_lis import swin_lis_attention_folded as j_folded
from p2vit_tpu.ops.swin_stem import fused_swin_stem as j_stem
from p2vit_tpu.ops.swin_stem import fused_swin_stem_ref as j_stem_ref
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving_swin as tss
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import SWIN_ZOO
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.ops import (
    _lib, attention_lis, intln, launch_counts, matmul_int8, reset_launch_counts, swin_stem,
)

TINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16,
                       depths=(2, 2), num_heads=(2, 2), window_size=4)
TTINY = tswin.SwinConfig(**dataclasses.asdict(TINY))
WIN7 = tswin.SwinConfig(img_size=56, patch_size=4, num_classes=10, embed_dim=16,
                        depths=(2, 2), num_heads=(2, 2), window_size=7)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


def rel(a, b):
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-9)


# ---------------------------------------------------------------------------
# fused_swin_stem
# ---------------------------------------------------------------------------


def _stem_inputs(case):
    """(patches, w, bias, s_bn, ln_w, ln_b, out_scale) as numpy float32."""
    m, c = {"tiny_randn": (32, 16), "swin_t_randn": (4096, 96), "swin_t_pot": (4096, 96)}[case]
    rng = np.random.RandomState(c)
    bias = (rng.randn(c) * 0.05).astype(np.float32)
    ln_w, ln_b = rng.randn(c).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32)
    if case.endswith("randn"):  # tests/test_swin_serving.py's kernel test, from numpy
        return (rng.randn(m, 48).astype(np.float32), (rng.randn(c, 48) * 0.2).astype(np.float32),
                bias, np.float32(0.04), ln_w, ln_b, np.float32(0.03))
    # a calibrated state's kinds: int8 input codes × a PoT scale, int4 weight
    # codes × PoT per-channel scales, PTF s_bn (masks 1, 2, 4), PoT out scale
    sw = (2.0 ** rng.randint(-9, -6, c)).astype(np.float32)
    return ((rng.randint(-128, 128, (m, 48)) * 2.0**-5).astype(np.float32),
            (rng.randint(-8, 8, (c, 48)) * sw[:, None]).astype(np.float32), bias,
            (2.0**-3 * 2.0 ** rng.randint(0, 3, c)).astype(np.float32), ln_w, ln_b,
            np.float32(2.0**-4))


@pytest.mark.parametrize("case,vs_kernel,vs_ref", [("tiny_randn", 0, 0), ("swin_t_randn", 2, 1),
                                                   ("swin_t_pot", 0, 0)])
def test_fused_swin_stem_plain_vs_jax(case, vs_kernel, vs_ref):
    """Stated flip counts against the JAX kernel (interpret) and its twin
    ``fused_swin_stem_ref`` (module docstring)."""
    args = _stem_inputs(case)
    t = swin_stem.fused_swin_stem_plain(*map(T, args))
    j = j_stem(*args, interpret=True)
    assert t.dtype == torch.int8 and t.shape == (args[0].shape[0], args[1].shape[0])
    assert len(np.unique(t.numpy())) > 50
    assert n_diff(j, t) == vs_kernel and n_diff(j_stem_ref(*args), t) == vs_ref


def test_fused_swin_stem_wrapper_takes_the_plain_version_on_cpu():
    args = tuple(map(T, _stem_inputs("tiny_randn")))
    reset_launch_counts()
    assert torch.equal(swin_stem.fused_swin_stem(*args), swin_stem.fused_swin_stem_plain(*args))
    assert swin_stem.fused_swin_stem.launches == 0


# ---------------------------------------------------------------------------
# swin_lis_attention_folded
# ---------------------------------------------------------------------------


def _folded_inputs(geometry, masked):
    """tests/test_swin_serving.py's folded-kernel geometry (2 images, 8×8
    grid of 4×4 windows, 2 heads of 16), or Swin-T's 7×7 windows (2 heads
    of 32 on a 14×14 grid)."""
    b, res, ws, heads, c = {"tiny": (2, 8, 4, 2, 32), "win7": (2, 14, 7, 2, 64)}[geometry]
    n = ws * ws
    rng = np.random.RandomState(0)
    qkv4 = rng.randint(-128, 128, (b, res, res, 3 * c)).astype(np.int8)
    bias = (rng.randn(heads, n, n) * 0.3).astype(np.float32)
    s2 = np.float32(2.0**-4)
    mask = swin.shift_attn_mask(res, res, ws, ws // 2) / s2 if masked else None
    return qkv4, bias, mask, heads, ws, 2.0**-9, 2.0**-4, s2, 2.0**-2


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("geometry", ["tiny", "win7"])
def test_swin_lis_attention_folded_plain_vs_jax(geometry, lis, masked):
    """0 flips against the JAX kernel (interpret), LIS on and off; and
    window_reverse of the panel version on the partitioned windows."""
    qkv4, bias, mask, heads, ws, *scales = _folded_inputs(geometry, masked)
    tmask = None if mask is None else T(mask)
    t = attention_lis.swin_lis_attention_folded_plain(T(qkv4), T(bias), tmask, heads, ws, *scales,
                                                      lis=lis)
    j = j_folded(qkv4, bias, mask, heads, ws, *scales, lis=lis, interpret=True)
    b, res = qkv4.shape[:2]
    assert t.shape == (b, res, res, qkv4.shape[-1] // 3) and t.dtype == torch.int8
    assert len(np.unique(t.numpy())) > 20
    assert n_diff(j, t) == 0
    panels = tswin.window_partition(T(qkv4), ws)
    two_step = attention_lis.swin_lis_attention_plain(panels, T(bias), tmask, heads,
                                                      (res // ws) ** 2, *scales, lis=lis)
    assert torch.equal(tswin.window_reverse(two_step, ws, res, res), t)
    assert torch.equal(attention_lis.swin_lis_attention_folded(T(qkv4), T(bias), tmask, heads, ws,
                                                               *scales, lis=lis), t)


def test_swin_folded_shape_guards_are_valueerrors():
    """The JAX kernel's guards, with its wording (tests/test_robustness.py)."""
    bias = torch.zeros(2, 49, 49)
    with pytest.raises(ValueError, match="square grid"):
        attention_lis.swin_lis_attention_folded(torch.zeros(1, 14, 7, 96, dtype=torch.int8), bias,
                                                None, 2, 7, 1.0, 2.0**-4, 1.0, 1.0)
    with pytest.raises(ValueError, match="square grid"):  # one window is no grid
        attention_lis.swin_lis_attention_folded(torch.zeros(1, 7, 7, 96, dtype=torch.int8), bias,
                                                None, 2, 7, 1.0, 2.0**-4, 1.0, 1.0)
    with pytest.raises(ValueError, match="mask shape"):
        attention_lis.swin_lis_attention_folded(torch.zeros(1, 14, 14, 96, dtype=torch.int8), bias,
                                                torch.zeros(3, 49, 49), 2, 7, 1.0, 2.0**-4, 1.0, 1.0)


# ---------------------------------------------------------------------------
# The serving flags
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def state():
    params = swin.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(11).randn(4, 3, 32, 32).astype(np.float32)
    calib = swin.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    js = jss.convert(params, calib.qstate, TINY, make_policy(), 8)
    ts = tss.convert(tp, tq, TTINY, tmake_policy(), 8)
    return dict(qs=calib.qstate, tq=tq, js=js, ts=ts, x=x, tp=tp)


@functools.partial(jax.jit, static_argnums=3)
def _jax_stem(js, qstate, x, cfg=TINY):
    """The JAX package's default fp patch stem, up to the patch-norm codes."""
    q0 = jnp.clip(jnp.round(x / js["s_input"] + js["zp_input"]), -128, 127)
    x = (q0 - js["zp_input"]) * js["s_input"]
    pw = js["patch"]["w_q"].astype(jnp.float32) * js["patch"]["sw"][:, None]
    px = swin._patches(x, cfg.patch_size)
    sq_bn = qstate["patch_qact_bn"]["scale"]
    xc = jnp.clip(jnp.round((px @ pw.T + js["patch_b"]) / sq_bn), -128, 127).astype(jnp.int8)
    return jss._iln(xc, sq_bn, js["patch_norm"], qstate["patch_qact"]["scale"], use_pallas=False)


def _jax(state, **kw):
    return np.asarray(jss.serving_forward(state["js"], state["qs"], TINY, make_policy(),
                                          jnp.asarray(state["x"]), **kw))


def _port(state, s=None, **kw):
    return tss.serving_forward(state["ts"] if s is None else s, state["tq"], TTINY, tmake_policy(),
                               T(state["x"]), **kw).numpy()


def _port_from_jax_stem(state, monkeypatch, **kw):
    stem = T(np.asarray(_jax_stem(state["js"], state["qs"], jnp.asarray(state["x"]))))
    monkeypatch.setattr(tss, "stem_codes", lambda *a, **k: stem)
    return _port(state, **kw)


@pytest.mark.parametrize("lis", [True, False])
def test_fold_windows_vs_jax(state, lis, monkeypatch):
    """From identical stem codes, bit for bit against JAX's folded path
    (Pallas kernels, interpret)."""
    j = _jax(state, interpret=True, lis=lis, fold_windows=True)
    t = _port_from_jax_stem(state, monkeypatch, lis=lis, fold_windows=True)
    assert t.shape == (4, 10) and np.isfinite(t).all()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("geometry", ["tiny", "win7"])
def test_fold_windows_equals_the_default_path(state, geometry, lis):
    """The port's folded path against its own two-step path, bit for bit:
    at TINY (stage 0 folded, shifted block included; stage 1 one window) and
    at Swin-T's 7×7 windows (shift 3, 4 masks; stage 1 res 7 = ws)."""
    if geometry == "tiny":
        s, tq, cfg, x = state["ts"], state["tq"], TTINY, T(state["x"])
    else:
        cfg = WIN7
        params = tswin.init_params(2, cfg, device="cpu")
        x = T(np.random.RandomState(12).randn(2, 3, 56, 56).astype(np.float32))
        tq = tswin.calibrate(params, cfg, tmake_policy(), x).qstate
        s = tss.convert(params, tq, cfg, tmake_policy(), 4)
        assert cfg.shift(0, 1) == 3 and cfg.stage_res(1) == cfg.window(1)
    fold = tss.serving_forward(s, tq, cfg, tmake_policy(), x, lis=lis, fold_windows=True)
    assert torch.equal(fold, tss.serving_forward(s, tq, cfg, tmake_policy(), x, lis=lis))
    assert torch.equal(fold, tss.serving_forward(s, tq, cfg, tmake_policy(), x, lis=lis,
                                                 fold_windows=True, use_kernels=False))


def test_fuse_stem_vs_jax(state):
    """The fused stem: its codes equal the JAX kernel's (interpret) on the
    serving path's patches, the logits equal JAX's ``fuse_stem`` path, and,
    with a power-of-two s_bn, the port's fp stem."""
    s, tq = state["ts"], state["tq"]
    assert float(tq["patch_qact_bn"]["scale"]).hex().startswith("0x1.0000")  # PoT
    x = T(state["x"])
    q0 = tss._input_codes(s, x)
    px = tswin._patches((q0 - s["zp_input"]) * s["s_input"], TTINY.patch_size).reshape(-1, 48)
    pw = s["patch"]["w_q"].to(torch.float32) * s["patch"]["sw"][:, None]
    args = (px, pw, s["patch_b"], tq["patch_qact_bn"]["scale"], s["patch_norm"]["w"],
            s["patch_norm"]["b"], tq["patch_qact"]["scale"])
    t = swin_stem.fused_swin_stem_plain(*args)
    assert n_diff(j_stem(*(a.numpy() for a in args), interpret=True), t) == 0
    assert torch.equal(t.reshape(4, 64, 16), tss.stem_codes(s, tq, TTINY, x, fuse_stem=True))
    assert torch.equal(t.reshape(4, 64, 16), tss.stem_codes(s, tq, TTINY, x))
    np.testing.assert_array_equal(_port(state, fuse_stem=True),
                                  _jax(state, interpret=True, fuse_stem=True))


@pytest.mark.parametrize("dzp", [0.0, 3.0])
def test_int_stem_vs_jax(state, dzp):
    """The int8 stem with the input zero point as calibrated (0) and moved
    by +3 (tests/test_swin_serving.py's zero-point fold): bit for bit
    against JAX's ``int_stem`` path, and inside JAX's envelope of the fp
    stem (rel < 5e-2, argmax equal)."""
    js, ts = dict(state["js"]), dict(state["ts"])
    js["zp_input"] = js["zp_input"] + dzp
    ts["zp_input"] = ts["zp_input"] + dzp
    j = np.asarray(jss.serving_forward(js, state["qs"], TINY, make_policy(),
                                       jnp.asarray(state["x"]), use_pallas=False, int_stem=True))
    t = _port(state, ts, int_stem=True)
    np.testing.assert_array_equal(t, j)
    assert np.array_equal(_port(state, ts, int_stem=True, fuse_stem=True), t)  # int_stem wins
    fp = _port(state, ts)
    assert np.isfinite(t).all() and (t.argmax(1) == fp.argmax(1)).all() and rel(t, fp) < 5e-2


def test_fuse_res_false_vs_jax(state, monkeypatch):
    """Unfused junctions and standalone LNs, from identical stem codes: bit
    for bit against JAX's jitted ``fuse_res=False`` path (module docstring:
    0 codes differ at this seed), and inside JAX's envelope of the fused
    junctions (rel < 0.02, argmax equal)."""
    j = _jax(state, use_pallas=False, fuse_res=False)
    t = _port_from_jax_stem(state, monkeypatch, fuse_res=False)
    np.testing.assert_array_equal(t, j)
    fused = _port(state)
    assert (t.argmax(1) == fused.argmax(1)).all() and rel(t, fused) < 0.02


@pytest.mark.parametrize("lis", [True, False])
def test_all_flags_combined(state, lis):
    """fold_windows + int_stem + fuse_res (tests/test_swin_serving.py's
    combined case), LIS on and off: bit for bit against JAX's combined path
    (interpret), and inside its envelope of the default path."""
    flags = dict(lis=lis, fold_windows=True, int_stem=True, fuse_res=True)
    j = _jax(state, interpret=True, **flags)
    t = _port(state, **flags)
    np.testing.assert_array_equal(t, j)
    base = _port(state, lis=lis)
    assert (t.argmax(1) == base.argmax(1)).all() and rel(t, base) < 5e-2


# ---------------------------------------------------------------------------
# Launch counts and the LIS scale bound
# ---------------------------------------------------------------------------

FLAGS = {"default": {}, "fold_windows": dict(fold_windows=True), "fuse_stem": dict(fuse_stem=True),
         "int_stem": dict(int_stem=True), "unfused": dict(fuse_res=False),
         "all": dict(fold_windows=True, fuse_stem=True, int_stem=True, fuse_res=False)}
ORDER = ("int_ln_requant", "swin_lis_attention", "swin_lis_attention_folded", "int_res_ln_requant",
         "int8_matmul_res_ln", "int8_matmul_requant", "fused_swin_stem")


@pytest.mark.parametrize("flags,want", [
    ("default", (8, 12, 0, 12, 9, 43, 0)), ("fold_windows", (8, 2, 10, 12, 9, 43, 0)),
    ("fuse_stem", (7, 12, 0, 12, 9, 43, 1)), ("int_stem", (8, 12, 0, 12, 9, 44, 0)),
    ("unfused", (29, 12, 0, 0, 0, 52, 0)), ("all", (29, 2, 10, 0, 0, 53, 0))])
def test_launches_per_forward_swin_t(flags, want):
    cfg = SWIN_ZOO["swin_tiny_patch4_window7_224"]
    got = tss.launches_per_forward(cfg, **FLAGS[flags])
    assert got == {k: v for k, v in zip(ORDER, want) if v}


@pytest.mark.parametrize("use_kernels", [True, False])
@pytest.mark.parametrize("flags", list(FLAGS))
def test_launches_per_forward_counts_the_plain_calls(state, flags, use_kernels, monkeypatch):
    """One CPU forward with each flag set makes the plain calls
    ``launches_per_forward`` states, launches nothing and builds nothing."""
    calls = {}
    for mod, name in ((attention_lis, "swin_lis_attention_plain"),
                      (attention_lis, "swin_lis_attention_folded_plain"),
                      (intln, "int_ln_requant_plain"), (intln, "int_res_ln_requant_plain"),
                      (tss.matmul_ln, "int8_matmul_res_ln_plain"),
                      (matmul_int8, "int8_matmul_requant_plain"),
                      (swin_stem, "fused_swin_stem_plain")):
        # the plain version and, where the kernel has one, its entry on prepared constants
        for entry in (name, name.replace("_plain", "_prepared_plain")):
            if not hasattr(mod, entry):
                continue
            fn = getattr(mod, entry)

            def rec(*a, _fn=fn, _k=name.replace("_plain", ""), **k):
                calls[_k] = calls.get(_k, 0) + 1
                return _fn(*a, **k)

            monkeypatch.setattr(mod, entry, rec)
    reset_launch_counts()
    _port(state, use_kernels=use_kernels, **FLAGS[flags])
    assert set(launch_counts().values()) == {0}
    assert calls == tss.launches_per_forward(TTINY, **FLAGS[flags])
    assert _lib.library.cache_info().currsize == 0


def test_lis_scale_bound_is_checked_from_the_state(state):
    """convert records the smallest qact2 scale on the host; a LIS forward
    below the exact-sum bound raises, LIS off does not."""
    assert state["ts"]["min_s2"] == min(float(bq["attn"]["qact2"]["scale"])
                                        for sq in state["tq"]["stages"] for bq in sq["blocks"])
    low = dict(state["ts"], min_s2=2.0**-21)
    with pytest.raises(ValueError, match="2\\^-20"):
        _port(state, low)
    assert np.isfinite(_port(state, low, lis=False)).all()


# ---------------------------------------------------------------------------
# The entry points' default device
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("entry", ["vit.init_params", "swin.init_params", "params_from_numpy",
                                   "qstate_from_numpy"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """Without a device argument the entry points build on the card; with no
    CUDA device that raises instead of running on the CPU, which a caller
    asks for with device="cpu"."""
    from p2vit_tpu_torch.models import VIT_ZOO, vit as tvit

    vcfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], img_size=32, patch_size=16,
                               embed_dim=64, depth=1, num_heads=1, num_classes=10)
    tree = {"a": np.ones((2, 3), np.float32), "b": [np.zeros(4, np.float32), None]}
    call = {"vit.init_params": lambda **k: tvit.init_params(0, vcfg, **k),
            "swin.init_params": lambda **k: tswin.init_params(0, TTINY, **k),
            "params_from_numpy": lambda **k: interop.params_from_numpy(tree, **k),
            "qstate_from_numpy": lambda **k: interop.qstate_from_numpy(tree, **k)}[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
    out = call(device="cpu")
    leaves = [t for t in jax.tree_util.tree_leaves(out) if isinstance(t, torch.Tensor)]
    assert leaves and all(t.device.type == "cpu" for t in leaves)

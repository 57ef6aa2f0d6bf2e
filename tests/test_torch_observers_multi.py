"""The rest of calibration against the JAX package, on the same numpy inputs:
the ema, percentile and omse observers, every ``solve_act`` method with
multi-batch statistics, and ``collect_stats`` → ``calibrate(stats=)`` over
two batches for TINY ViT and TINY Swin.

Function level (JAX eager, no model jit): statistics and decisions (zero
points, PTF masks, PoT exponents, the omse candidate) bit for bit. Float
scales within 1e-6 relative: omse's candidate scale is (max − min)·step /
255, which XLA computes inside ``lax.map`` as an fma times the rounded
reciprocal of 255, 1 ulp from the division the port does (traced in
``test_omse_decisions_equal``). ``jnp.quantile`` is jitted, and the port
replays its fma in float64: percentile ranges are bit for bit, and past
2^24 elements equal a numpy replay of JAX's arithmetic.

Model level (JAX's jitted calibration): the statistics are ranges of fp
activations that the frameworks sum in different orders (within 1e-4
relative, measured ≤ 2.1e-5), the decisions bit for bit, the float scales
(PTF base scales, and every activation scale of ema/percentile/omse)
within 1e-6 relative (measured ≤ 3.9e-7). Serving an omse state (non-PoT
activation scales) on the port's plain path gives JAX's serving logits bit
for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import swin, vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu.quant import observers as jobs
from p2vit_tpu.quant import solve as jsolve
from p2vit_tpu.quant.bit_type import BIT_TYPE_DICT as JBT
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.quant import observers as tobs
from p2vit_tpu_torch.quant import solve as tsolve
from p2vit_tpu_torch.quant.bit_type import BIT_TYPE_DICT as TBT

METHODS = ("minmax", "ema", "percentile", "omse", "ptf")
FLOAT_METHODS = ("ema", "percentile", "omse")
VTINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 2), window_size=4)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _batches(shape, seed, mults=(5.0, 2.0, 1.0)):
    """Batches of descending range, so merged statistics differ from the
    last batch's; per-channel spreads so PTF masks vary."""
    rng = np.random.RandomState(seed)
    spread = 2.0 ** rng.randint(-2, 3, shape[-1])
    return [(rng.randn(*shape) * m * spread).astype(np.float32) for m in mults]


# ---------------------------------------------------------------------------
# Function level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("method", METHODS)
def test_accumulated_stats_bitwise(method):
    """Three batches through accumulate_act_stats: each running range is
    JAX's, bit for bit (ema and percentile merge by EMA)."""
    sj = st = None
    for x in _batches((4, 17, 40), 1):
        sj = jsolve.accumulate_act_stats(method, jnp.asarray(x), sj)
        st = tsolve.accumulate_act_stats(method, T(x), st)
        np.testing.assert_array_equal(st.min_val.numpy(), np.asarray(sj.min_val))
        np.testing.assert_array_equal(st.max_val.numpy(), np.asarray(sj.max_val))


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("shape", [(4, 17, 40), (3, 50, 7)])
def test_solve_act_with_merged_stats(method, shape):
    """solve_act on the last batch with the merged range: zero points and
    masks bit for bit; scales bit for bit but for omse's (1e-6)."""
    xs = _batches(shape, 2)
    sj = st = None
    for x in xs:
        sj = jsolve.accumulate_act_stats(method, jnp.asarray(x), sj)
        st = tsolve.accumulate_act_stats(method, T(x), st)
    oj = jsolve.solve_act(method, jnp.asarray(xs[-1]), JBT["int8"], stats=sj)
    ot = tsolve.solve_act(method, T(xs[-1]), TBT["int8"], stats=st)
    assert len(oj) == len(ot) == (3 if method == "ptf" else 2)
    np.testing.assert_array_equal(ot[1].numpy(), np.asarray(oj[1]))  # zero point
    if method == "ptf":
        np.testing.assert_array_equal(ot[2].numpy(), np.asarray(oj[2]))
    if method == "omse":
        np.testing.assert_allclose(ot[0].numpy(), np.asarray(oj[0]), rtol=1e-6)
    else:
        np.testing.assert_array_equal(ot[0].numpy(), np.asarray(oj[0]))
    # single-batch calibration (stats=None) takes the same path
    oj1 = jsolve.solve_act(method, jnp.asarray(xs[0]), JBT["int8"])
    ot1 = tsolve.solve_act(method, T(xs[0]), TBT["int8"])
    np.testing.assert_allclose(ot1[0].numpy(), np.asarray(oj1[0]), rtol=1e-6 if method == "omse" else 0)


@pytest.mark.parametrize("bt", ["int8", "uint4"])
@pytest.mark.parametrize("symmetric", [True, False])
def test_float_scale_params_bitwise(bt, symmetric):
    rng = np.random.RandomState(3)
    mn, mx = -rng.rand(64).astype(np.float32) * 9, rng.rand(64).astype(np.float32) * 9
    mn[:3] = mx[:3] = 0.0  # all-zero ranges clamp to eps
    sj, zj = jobs.float_scale_params(jobs.MinMaxStats(jnp.asarray(mn), jnp.asarray(mx)), JBT[bt], symmetric)
    st, zt = tobs.float_scale_params(tobs.MinMaxStats(T(mn), T(mx)), TBT[bt], symmetric)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(zt.numpy(), np.asarray(zj))


def test_omse_decisions_equal():
    """40 seeded ranges and tensors: omse picks JAX's candidate every time
    (the same zero point and shrink step), its scale within 1e-6. The
    scales differ in the last bit on most draws; a replay of XLA's
    arithmetic, fma(max, step, −min·step) times float32(1/255), matches
    JAX's candidate scales exactly."""
    rng = np.random.RandomState(4)
    bt_j, bt_t = JBT["int8"], TBT["int8"]
    steps = 1.0 - np.float32(0.01) * np.arange(90, dtype=np.float32)
    n_ulp = 0
    for _ in range(40):
        x = (rng.randn(128) * rng.uniform(0.1, 10)).astype(np.float32)
        mn, mx = np.float32(x.min() * rng.uniform(1, 1.5)), np.float32(x.max() * rng.uniform(1, 1.5))
        sj, zj = jobs.omse_params(jobs.MinMaxStats(jnp.asarray(mn), jnp.asarray(mx)), jnp.asarray(x), bt_j)
        st, zt = tobs.omse_params(tobs.MinMaxStats(T(mn), T(mx)), T(x), bt_t)
        assert float(zt) == float(zj)
        np.testing.assert_allclose(float(st), float(sj), rtol=1e-6)
        n_ulp += float(st) != float(sj)
        # the candidate JAX chose, replayed with XLA's fma and reciprocal
        xla = [np.float32(np.float32(np.float64(mx) * np.float64(s) - np.float64(np.float32(mn * s)))
                          * np.float32(1 / 255.0)) for s in steps.astype(np.float32)]
        port = [np.float32(np.float32(mx * s) - np.float32(mn * s)) / np.float32(255.0) for s in steps]
        assert float(sj) in xla and float(st) in port
        assert xla.index(float(sj)) == port.index(float(st))
    assert n_ulp > 0  # the stated 1-ulp scale difference is real


def _quantile_replay(x, q):
    """jnp.quantile's arithmetic in numpy: the float32 index q·(float32(n) −
    1), floor and ceil, and XLA:CPU's fma(hi, w, lo·(1 − w))."""
    n1 = np.float32(x.size) - np.float32(1)
    pos = np.float32(q) * n1
    lo, hi = np.floor(pos), np.ceil(pos)
    w = np.float32(pos - lo)
    part = np.partition(x.reshape(-1), sorted({int(lo), int(hi)}))
    low = np.float32(part[int(lo)] * np.float32(np.float32(1) - w))
    return np.float32(np.float64(part[int(hi)]) * np.float64(w) + np.float64(low))


def test_percentile_quantile_bitwise_and_past_2_24():
    """collect_percentile against jnp.quantile on 60 seeded draws of six
    sizes, and against a numpy replay of jnp.quantile's arithmetic (equal to
    JAX on those draws) on 2^24 + 3 elements, where float32(n − 1) rounds
    and XLA:CPU takes ~10 s a quantile (torch.quantile refuses that input)."""
    rng = np.random.RandomState(5)
    for i in range(60):
        n = (1, 2, 6, 99, 1001, 2997)[i % 6]
        kind = "activation" if n % 3 == 0 else "weight"  # activations (…, 3): a transposed view in JAX
        x = (rng.randn(n) * rng.uniform(0.1, 10)).astype(np.float32).reshape(-1, 3 if n % 3 == 0 else n)
        j, t = jobs.collect_percentile(jnp.asarray(x), kind), tobs.collect_percentile(T(x), kind)
        assert (float(t.min_val), float(t.max_val)) == (float(j.min_val), float(j.max_val))
        assert (_quantile_replay(x, 1.0 - 0.99999), _quantile_replay(x, 0.99999)) == \
            (float(j.min_val), float(j.max_val))
    x = rng.randn(2**24 + 3).astype(np.float32)
    assert np.float32(x.size) - np.float32(1) != x.size - 1
    t = tobs.collect_percentile(T(x), "weight")
    assert (float(t.min_val), float(t.max_val)) == (_quantile_replay(x, 1.0 - 0.99999), _quantile_replay(x, 0.99999))


# ---------------------------------------------------------------------------
# Model level: collect_stats over one batch, calibrate(stats=) on the next
# ---------------------------------------------------------------------------

CASES = {
    "vit_minmax": ("vit", "minmax", {}),
    "vit_omse": ("vit", "omse", {}),
    "vit_no_smoothquant": ("vit", "minmax", {"smoothquant": False}),
    "swin_minmax": ("swin", "minmax", {}),
}


def _policies(method, kw):
    return (dataclasses.replace(make_policy(quant_method=method), **kw),
            dataclasses.replace(tmake_policy(quant_method=method), **kw))


@pytest.fixture(scope="module")
def calibrations():
    """Per case, JAX's and the port's two-batch calibration on the same
    numpy params and batches (one JAX jit per case), and JAX's one-batch
    calibration of the last batch."""
    out = {}

    def get(case):
        if case not in out:
            fam, method, kw = CASES[case]
            cfg, jm, tm = (VTINY, vit, tvit) if fam == "vit" else (STINY, swin, tswin)
            tcfg = (tcommon.ViTConfig if fam == "vit" else tswin.SwinConfig)(**dataclasses.asdict(cfg))
            params = jm.init_params(jax.random.PRNGKey(0), cfg)
            tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
            xs = _batches((4, 3, 32, 32), 6, mults=(4.0, 1.0))
            jp, tpol = _policies(method, kw)
            js = jm.collect_stats(params, cfg, jp, jnp.asarray(xs[0]))
            jc = jm.calibrate(params, cfg, jp, jnp.asarray(xs[1]), stats=js)
            ts = tm.collect_stats(tp, tcfg, tpol, T(xs[0]))
            tc = tm.calibrate(tp, tcfg, tpol, T(xs[1]), stats=ts)
            t1 = tm.calibrate(tp, tcfg, tpol, T(xs[1]))
            out[case] = dict(cfg=cfg, tcfg=tcfg, params=params, tp=tp, xs=xs, jp=jp, tpol=tpol, js=js, jc=jc,
                             ts=ts, tc=tc, t1=t1)
        return out[case]

    return get


def _flat(tree):
    return jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda v: v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v), tree,
                     is_leaf=lambda v: isinstance(v, torch.Tensor)))[0]


def _float_scale(key, a, method):
    """The leaves that are floats of fp activations rather than decisions:
    PTF base scales, and every activation scale of the float observers."""
    if not key.endswith("['scale']") and not key.endswith("['qact0_scale']"):
        return False
    return method in FLOAT_METHODS or (a.ndim == 1 and "qact0" not in key)


@pytest.mark.parametrize("case", list(CASES))
def test_collect_stats_then_calibrate_equal_jax(calibrations, case):
    c = calibrations(case)
    method = CASES[case][1]
    js, ts = _flat(c["js"]), _flat(c["ts"])
    assert [jax.tree_util.keystr(p) for p, _ in js] == [jax.tree_util.keystr(p) for p, _ in ts]
    for (p, a), (_, b) in zip(js, ts):
        np.testing.assert_allclose(b, a, rtol=1e-4, atol=1e-6, err_msg=jax.tree_util.keystr(p))
    jl, tl = _flat(c["jc"].qstate), _flat(c["tc"].qstate)
    assert len(jl) == len(tl) > 60
    n_exact = 0
    for (pa, a), (pb, b) in zip(jl, tl):
        key = jax.tree_util.keystr(pa)
        assert key == jax.tree_util.keystr(pb) and a.shape == b.shape, key
        if _float_scale(key, a, method):
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)
            n_exact += 1
    assert n_exact >= 40
    np.testing.assert_allclose(c["tc"].global_distance.numpy(), np.asarray(c["jc"].global_distance), rtol=1e-5)
    # the first batch's statistics reached the solve: some decision differs from one-batch calibration
    one = _flat(c["t1"].qstate)
    assert any(not np.array_equal(a, b) for (_, a), (_, b) in zip(tl, one))


def test_no_smoothquant_state_and_simulation(calibrations):
    """Without SmoothQuant the qkv/fc1 caches carry unit channel scales and
    one weight solve repeated per eval bit; quant_forward on JAX's state
    agrees with JAX's within 1e-5 relative, argmax equal."""
    c = calibrations("vit_no_smoothquant")
    for blk in c["tc"].qstate["blocks"]:
        for part in ("attn", "mlp"):
            st = blk[part]
            assert torch.equal(st["channel_scale"], torch.ones_like(st["channel_scale"]))
            assert torch.equal(st["wscale"][0], st["wscale"][1])
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, c["jc"].qstate), device="cpu")
    n = VTINY.num_matmuls
    jfwd = jax.jit(lambda p, q, x, bi: vit.quant_forward(p, q, VTINY, c["jp"], x, bi))
    for bits in ([4] * n, [8] * n, ([4, 8] * n)[:n]):
        j = np.asarray(jfwd(c["params"], c["jc"].qstate, jnp.asarray(c["xs"][0]), vit.bits_to_idx(bits)))
        t = tvit.quant_forward(c["tp"], tq, c["tcfg"], c["tpol"], T(c["xs"][0]), tvit.bits_to_idx(bits)).numpy()
        assert np.linalg.norm(t - j) / np.linalg.norm(j) < 1e-5
        assert (t.argmax(1) == j.argmax(1)).all()


@pytest.mark.parametrize("bits", ["w4", "mixed"])
def test_omse_state_serves_as_jax(calibrations, bits):
    """JAX's two-batch omse state (non-PoT activation scales, nonzero zero
    points in the state) converted by both packages: the port's plain
    serving path gives JAX's serving logits bit for bit."""
    c = calibrations("vit_omse")
    n = VTINY.num_matmuls
    bc = [4] * n if bits == "w4" else ([8, 4] * n)[:n]
    scales = [float(v) for v in jax.tree.leaves(c["jc"].qstate) if np.ndim(v) == 0]
    assert any(s > 0 and np.log2(s) != np.round(np.log2(s)) for s in scales)
    js = jserving.convert(c["params"], c["jc"].qstate, VTINY, c["jp"], bc)
    j = np.asarray(jserving.serving_forward(js, VTINY, jnp.asarray(c["xs"][0]), use_pallas=False))
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, c["jc"].qstate), device="cpu")
    ts = tserving.convert(c["tp"], tq, c["tcfg"], c["tpol"], bc)
    t = tserving.serving_forward(ts, c["tcfg"], T(c["xs"][0]), use_kernels=False)
    np.testing.assert_array_equal(t.numpy(), j)

"""The port's quantization core against the JAX package, bit for bit.

Same seeded numpy inputs through ``p2vit_tpu`` and ``p2vit_tpu_torch``:
fastmath, fake-quant, the integer LN / Log-Int-Softmax simulation, the
minmax-PoT and PTF observers, the per-node solvers and SmoothQuant. Every
comparison is exact, including the argmin decisions of the searches.
"""

import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.ops import fastmath as jfm
from p2vit_tpu.quant import intops as jio
from p2vit_tpu.quant import observers as jobs
from p2vit_tpu.quant import smoothquant as jsq
from p2vit_tpu.quant import solve as jsolve
from p2vit_tpu.quant.bit_type import BIT_TYPE_DICT as JBT
from p2vit_tpu.quant.bit_type import WEIGHT_CALIB_BIT_TYPES as JWB
from p2vit_tpu_torch import models as tmodels
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.ops import fastmath as tfm
from p2vit_tpu_torch.quant import intops as tio
from p2vit_tpu_torch.quant import observers as tobs
from p2vit_tpu_torch.quant import smoothquant as tsq
from p2vit_tpu_torch.quant import solve as tsolve
from p2vit_tpu_torch.quant.bit_type import BIT_TYPE_DICT as TBT
from p2vit_tpu_torch.quant.bit_type import WEIGHT_CALIB_BIT_TYPES as TWB

# the quant packages re-export the function ``fake_quant``, which shadows the
# submodule of the same name as a package attribute
jfq = importlib.import_module("p2vit_tpu.quant.fake_quant")
tfq = importlib.import_module("p2vit_tpu_torch.quant.fake_quant")


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def assert_same(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy() if isinstance(t, torch.Tensor) else t)


def test_bit_types_match():
    assert [dataclasses.astuple(b) for b in JWB] == [dataclasses.astuple(b) for b in TWB]
    for name in JBT:
        assert dataclasses.astuple(JBT[name]) == dataclasses.astuple(TBT[name])


def test_fastmath_bitwise():
    rng = np.random.RandomState(0)
    x = np.concatenate([
        np.float32(2.0) ** rng.uniform(-140, 128, 5000).astype(np.float32),
        np.float32(2.0) ** np.arange(-126, 128, dtype=np.float32),
        np.array([0.0, np.inf, 1e-45, 3.0, 0.75], np.float32),
    ])
    assert_same(jfm.floor_log2i(jnp.asarray(x)), tfm.floor_log2i(T(x)))
    k = np.arange(-127, 129, dtype=np.int32)
    got = tfm.exp2i(T(k)).view(torch.int32).numpy()
    want = np.asarray(jfm.exp2i(jnp.asarray(k))).view(np.int32)
    np.testing.assert_array_equal(got, want)


def test_sqrt_exp_rn_are_correctly_rounded():
    rng = np.random.RandomState(1)
    x = np.abs(rng.randn(100000)).astype(np.float32) * 100
    np.testing.assert_array_equal(tfm.sqrt_rn(T(x)).numpy(), np.sqrt(x))
    y = (-x / 50).astype(np.float32)
    np.testing.assert_array_equal(tfm.exp_rn(T(y)).numpy(), np.exp(y.astype(np.float64)).astype(np.float32))


def test_log2_floor_agrees_in_band_and_pins_xla_outliers():
    """floor(log2 x) at powers of two and their ±1-ulp neighbours: the port
    (torch.log2, exact there) and XLA:CPU's log2 agree for every 2^k with
    k ∈ [-12, 12]; outside that band XLA's log2 is off at some of them (it
    gives log2(8192) = 12.999999). The values the raw floor(log2) sites see
    are pinned to agree in the calibration test below."""
    k = np.arange(-126, 128)
    p = (2.0**k).astype(np.float32)
    xs = {"pow2": p, "up": np.nextafter(p, np.float32(np.inf)), "down": np.nextafter(p, np.float32(0))}
    band = (k >= -12) & (k <= 12)
    outliers = set()
    for v in xs.values():
        jl = np.floor(np.asarray(jnp.log2(v)))
        tl = torch.floor(torch.log2(T(v))).numpy()
        assert (jl == tl)[band].all()
        outliers |= set(k[jl != tl].tolist())
    assert 13 in outliers  # XLA: floor(log2(8192.)) == 12


def test_log2_sites_see_only_agreeing_values(monkeypatch):
    """Record every input of the port's raw floor(log2) sites during a TINY
    calibration + quant_forward and check XLA agrees on each of them."""
    seen = []

    def spy(mod, name):
        fn = getattr(mod, name)

        def wrapped(x, *a, **k):
            seen.append(x.detach().reshape(-1).clone())
            return fn(x, *a, **k)

        monkeypatch.setattr(mod, name, wrapped)

    import p2vit_tpu_torch.quant.smoothquant as sq_mod

    spy(sq_mod, "round_to_pot")
    spy(tio, "get_mn")
    orig_cand = tobs._pot_candidate_scales
    monkeypatch.setattr(tobs, "_pot_candidate_scales",
                        lambda s0: (seen.append(torch.clamp(s0, min=tobs.EPS).reshape(-1)), orig_cand(s0))[1])
    cfg = dataclasses.replace(tmodels.ViTConfig(), img_size=32, patch_size=8, num_classes=16,
                              embed_dim=32, depth=2, num_heads=2)
    params = tvit.init_params(0, cfg, device="cpu")
    x = T(np.random.RandomState(0).randn(4, 3, 32, 32).astype(np.float32))
    policy = tmake_policy()
    calib = tvit.calibrate(params, cfg, policy, x)
    tvit.quant_forward(params, calib.qstate, cfg, policy, x, tvit.bits_to_idx([4] * cfg.num_matmuls))
    v = torch.cat(seen).numpy()
    assert v.size > 1000
    np.testing.assert_array_equal(np.floor(np.asarray(jnp.log2(v))), np.floor(np.log2(v.astype(np.float64))))
    np.testing.assert_array_equal(torch.floor(torch.log2(T(v))).numpy(), np.floor(np.log2(v.astype(np.float64))))


@pytest.mark.parametrize("bt", ["int8", "int4", "uint4", "uint3"])
def test_fake_quant_bitwise(bt):
    rng = np.random.RandomState(2)
    x = (rng.randn(64, 48) * 3).astype(np.float32)
    s = np.float32(2.0**-4)
    assert_same(jfq.quantize(x, s, 0.0, JBT[bt]), tfq.quantize(T(x), T(s), 0.0, TBT[bt]))
    assert_same(jfq.fake_quant(x, s, 0.0, JBT[bt]), tfq.fake_quant(T(x), T(s), 0.0, TBT[bt]))
    sc = (2.0 ** rng.randint(-6, 0, 48)).astype(np.float32)
    assert_same(jfq.fake_quant(x, sc[None], 0.0, JBT[bt]), tfq.fake_quant(T(x), T(sc)[None], 0.0, TBT[bt]))
    p = np.abs(rng.rand(1000)).astype(np.float32) + 1e-3
    assert_same(jfq.fake_quant_log2(p, JBT["uint4"]), tfq.fake_quant_log2(T(p), TBT["uint4"]))
    pos = (np.abs(rng.randn(5000)) * 4 + 1e-3).astype(np.float32)
    assert_same(jfq.round_to_pot(pos), tfq.round_to_pot(T(pos)))
    # a float mean: its summation order differs, so ulps (never a decision)
    np.testing.assert_allclose(np.asarray(jfq.lp_loss(x, x * 0.9)),
                               tfq.lp_loss(T(x), T(x) * 0.9).numpy(), rtol=1e-6)


def test_intops_bitwise():
    rng = np.random.RandomState(3)
    a = (np.abs(rng.randn(5000)) * 2.0 ** rng.randint(-8, 6, 5000)).astype(np.float32) + 1e-6
    m_j, n_j = jio.get_mn(jnp.asarray(a))
    m_t, n_t = tio.get_mn(T(a))
    assert_same(m_j, m_t)
    assert_same(n_j, n_t)
    n = np.arange(-160, 140).astype(np.float32)
    assert_same(jio._pow2(jnp.asarray(n)), tio._pow2(T(n)))
    v = np.concatenate([rng.randint(1, 1 << 20, 5000).astype(np.float32),
                        np.array([0.0, 1.0, 1.5, 3 * 2.0**12, np.inf], np.float32)])
    assert_same(jio.log_round(jnp.asarray(v)), tio.log_round(T(v)))

    # integer LN with a PTF input scale and a per-channel output scale
    c = 48
    mask = 2.0 ** rng.randint(0, 4, c)
    in_scale = (0.013 * mask).astype(np.float32)
    x = (rng.randint(-100, 100, (2, 9, c)) * in_scale).astype(np.float32)
    w = rng.randn(c).astype(np.float32)
    b = (rng.randn(c) * 0.1).astype(np.float32)
    out_scale = (2.0**-5 * 2.0 ** rng.randint(-1, 2, c)).astype(np.float32)
    assert_same(jio.int_layernorm(x, w, b, in_scale, out_scale),
                tio.int_layernorm(T(x), T(w), T(b), T(in_scale), T(out_scale)))

    # Log-Int-Softmax on quantized attention logits
    s = np.float32(2.0**-5)
    logits = (rng.randint(-128, 128, (2, 3, 17, 17)) * s).astype(np.float32)
    e_j, sum_j = jio.int_softmax(jnp.asarray(logits), s)
    e_t, sum_t = tio.int_softmax(T(logits), T(s))
    assert_same(e_j, e_t)
    assert_same(sum_j, sum_t)
    assert_same(jio.log_int_softmax(jnp.asarray(logits), s, JBT["uint4"]),
                tio.log_int_softmax(T(logits), T(s), TBT["uint4"]))


@pytest.mark.parametrize("channel_wise", [True, False])
def test_minmax_pot_observers_bitwise(channel_wise):
    rng = np.random.RandomState(4)
    w = (rng.randn(24, 40) * 0.05).astype(np.float32)
    xx = rng.randn(96, 40).astype(np.float32)
    for jb, tb in zip(JWB, TWB):
        st_j = jobs.collect_minmax(jnp.asarray(w), "weight", layer_wise=not channel_wise)
        st_t = tobs.collect_minmax(T(w), "weight", layer_wise=not channel_wise)
        s_j, _ = jobs.minmax_pot_weight_params(st_j, jnp.asarray(w), jnp.asarray(xx), jb, channel_wise)
        s_t, _ = tobs.minmax_pot_weight_params(st_t, T(w), T(xx), tb, channel_wise)
        assert_same(s_j, s_t)
    act = (rng.randn(4, 17, 40) * 2).astype(np.float32)
    st_j = jobs.collect_minmax(jnp.asarray(act), "activation", layer_wise=True)
    st_t = tobs.collect_minmax(T(act), "activation", layer_wise=True)
    s_j, _ = jobs.minmax_pot_act_params(st_j, jnp.asarray(act), JBT["int8"])
    s_t, _ = tobs.minmax_pot_act_params(st_t, T(act), TBT["int8"])
    assert_same(s_j, s_t)


def test_ptf_observer_and_solvers_bitwise():
    rng = np.random.RandomState(5)
    x = (rng.randn(4, 17, 32) * 2.0 ** rng.randint(-2, 3, 32)).astype(np.float32)
    sj, zj, mj = jsolve.solve_act("ptf", jnp.asarray(x), JBT["int8"])
    st, zt, mt = tsolve.solve_act("ptf", T(x), TBT["int8"])
    assert_same(sj, st)
    assert_same(mj, mt)
    assert_same(zj, zt)
    assert set(np.unique(mt.numpy())) <= {1.0, 2.0, 4.0, 8.0}
    sj, _ = jsolve.solve_act("minmax", jnp.asarray(x), JBT["int8"])
    st, _ = tsolve.solve_act("minmax", T(x), TBT["int8"])
    assert_same(sj, st)
    w = (rng.randn(48, 32) * 0.04).astype(np.float32)
    ws_j, d_j = jsolve.solve_weight_all_bits(jnp.asarray(w), jnp.asarray(x.reshape(-1, 32)))
    ws_t, d_t = tsolve.solve_weight_all_bits(T(w), T(x.reshape(-1, 32)))
    assert_same(ws_j, ws_t)
    np.testing.assert_allclose(np.asarray(d_j), d_t.numpy(), rtol=1e-6)
    for method in ("minmax", "ptf"):
        j = jsolve.accumulate_act_stats(method, jnp.asarray(x))
        t = tsolve.accumulate_act_stats(method, T(x))
        assert_same(j.min_val, t.min_val)
        assert_same(j.max_val, t.max_val)


def test_smoothquant_scale_bitwise():
    rng = np.random.RandomState(6)
    for alpha in (0.35, 0.5):
        x = (rng.randn(4, 17, 32) * 2.0 ** rng.randint(-1, 4, 32)).astype(np.float32)
        w = (rng.randn(96, 32) * 0.02).astype(np.float32)
        cs_j = jsq.pot_smooth_channel_scale(jnp.asarray(x), jnp.asarray(w), alpha)
        cs_t = tsq.pot_smooth_channel_scale(T(x), T(w), alpha)
        assert_same(cs_j, cs_t)

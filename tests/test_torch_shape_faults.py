"""The six shapes JAX serves that the port's CUDA wrappers once refused
(``ROADMAP.md`` queue 3, closed), on the CPU: at each held shape, the port's
plain version and, where the wrapper pads, its padding route
(``fused_vit_layer_padded_plain``, ``lis_attention_qkv_fused_padded_plain``,
``swin_lis_attention_padded_plain``) against the JAX kernel in interpret
mode (``lis_attention_ref`` for the split kernel with LIS off, which the JAX
kernel lacks), on the same numpy-seeded codes, B = 1 and one or two heads;
and the plan functions, which accept the new shapes and raise past the
card's limits naming them (shared memory, the cluster size).

Tolerance: every comparison counts differing int8 codes. LIS on they are 0.
LIS off, JAX's float32 ``exp`` is not correctly rounded and its float32 sums
run in its own order, so a code can move by one (the envelope ``ROADMAP.md``
queue 3 traces to the JAX side); each case states its count at these seeds,
and every differing code differs by exactly 1. The kernels are held bit for
bit against these plain versions on the card
(``tests/test_torch_cuda_shape_faults.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

from p2vit_tpu.models import swin as jswin
from p2vit_tpu.ops.attention_lis import lis_attention as j_split
from p2vit_tpu.ops.attention_lis import lis_attention_fused as j_fused
from p2vit_tpu.ops.attention_lis import lis_attention_qkv_fused as j_qkv
from p2vit_tpu.ops.attention_lis import lis_attention_ref as j_split_ref
from p2vit_tpu.ops.attention_lis import swin_lis_attention as j_swin
from p2vit_tpu.ops.attention_lis import swin_lis_attention_folded as j_folded
from p2vit_tpu.ops.layer_fused import fused_vit_layer as j_layer
from p2vit_tpu.ops.swin_stem import fused_swin_stem as j_stem
from p2vit_tpu_torch.ops import attention_lis as al
from p2vit_tpu_torch.ops import layer_fused, swin_stem


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _codes(seed, shape, lo=-128, hi=128):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(np.int8)


def _diff(t, j):
    """Differing codes, after checking every difference is ±1."""
    d = np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(np.int32))
    assert int(d.max(initial=0)) <= 1
    return int((d != 0).sum())


# ---------------------------------------------------------------------------
# 1 and 2, 4: fused_vit_layer at C % 64 ≠ 0, N > 256, head_dim 128
# ---------------------------------------------------------------------------


def _layer_np(n, c, heads, hid, seed=21):
    """A layer's 32 arguments as numpy (the shape_faults tool's kinds)."""
    rng = np.random.RandomState(seed)
    i8 = lambda *s, lo=-128, hi=128: rng.randint(lo, hi, s).astype(np.int8)  # noqa: E731
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    pot = lambda k, lo, hi: f(2.0 ** rng.randint(lo, hi, k))  # noqa: E731
    ptf = lambda k, base: f(base * 2.0 ** rng.randint(0, 4, k))  # noqa: E731
    return [i8(1, n, c), i8(1, n, c), i8(3 * c, c, lo=-8, hi=8), pot(3 * c, -8, -6), f(rng.randn(3 * c)), heads,
            f(2.0**-9), f(2.0**-4), f(4.0), i8(c, c, lo=-8, hi=8), pot(c, -8, -6), f(rng.randn(c)), f(2.0**-5),
            ptf(c, 0.011), ptf(c, 0.03), f(rng.randn(c)), f(rng.randn(c) * 0.1),
            f(np.abs(rng.randn(c)) * 0.03 + 0.01), pot(c, -1, 2), i8(hid, c, lo=-8, hi=8), pot(hid, -10, -8),
            f(rng.randn(hid) * 0.5), f(16.0), i8(c, hid, lo=-8, hi=8), pot(c, -10, -8), f(rng.randn(c)),
            f(2.0**-4), ptf(c, 0.04), f(rng.randn(c)), f(rng.randn(c) * 0.1),
            f(np.abs(rng.randn(c)) * 0.03 + 0.01), f(1.0)]


# (N, C, heads, hid, LIS-off codes that differ from JAX): fault 1 at TINY
# (C = 32) and C = 96 with hid = 384; fault 2 at N = 257 and 300; fault 4
# at head_dim 128
LAYER_SHAPES = [(17, 32, 2, 128, 0), (17, 96, 3, 384, 0), (257, 64, 1, 128, 0), (300, 64, 1, 128, 0),
                (33, 128, 1, 128, 0)]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=lambda s: "n{}c{}h{}hid{}".format(*s[:4]))
def test_fused_layer_plain_and_padded_vs_jax(shape, lis):
    n, c, heads, hid, off_flips = shape
    a = _layer_np(n, c, heads, hid)
    ta = [T(x) if isinstance(x, np.ndarray) else x for x in a]
    j = j_layer(*a, lis=lis, interpret=True)
    t = layer_fused.fused_vit_layer_plain(*ta, lis=lis)
    p = layer_fused.fused_vit_layer_padded_plain(*ta, lis=lis)
    assert all(torch.equal(x, y) for x, y in zip(t, p))
    assert t[0].shape == (1, n, c) and len(np.unique(t[0].numpy())) > 20
    flips = sum(_diff(x, y) for x, y in zip(t, j))
    assert flips == (0 if lis else off_flips)
    layer_fused.check_fits(n, c, heads, hid)


# ---------------------------------------------------------------------------
# 2 and 4: the per-item kernels at N > 256 and head_dim 128
# ---------------------------------------------------------------------------

SC = (2.0**-11, 2.0**-11, 2.0)  # score_requant, s_attn (LIS), out_requant
SC_OFF = (2.0**-11, 2.0**-4, 2.0)  # LIS off: a softmax scale that spreads the weights


# (N, C, heads, LIS-off flips)
FUSED_SHAPES = [(257, 64, 1, 0), (300, 64, 1, 0), (577, 64, 1, 0), (197, 128, 1, 0)]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shape", FUSED_SHAPES, ids=lambda s: "n{}c{}h{}".format(*s[:3]))
def test_lis_attention_fused_plain_vs_jax(shape, lis):
    n, c, heads, off_flips = shape
    qkv = _codes(n + c, (1, n, 3 * c))
    sc = SC if lis else SC_OFF
    t = al.lis_attention_fused_plain(T(qkv), heads, *sc, lis=lis)
    j = j_fused(qkv, heads, *sc, lis=lis, interpret=True)
    assert len(np.unique(t.numpy())) > 20
    assert _diff(t, j) == (0 if lis else off_flips)
    al.vit_attention_plan(n, c // heads, lis)


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("n,d,off_flips", [(577, 64, 0), (300, 64, 1), (197, 128, 0)])
def test_lis_attention_plain_vs_jax(n, d, off_flips, lis):
    q, k, v = (_codes(n + d + i, (1, n, d)) for i in range(3))
    sc = SC if lis else SC_OFF
    t = al.lis_attention_plain(T(q), T(k), T(v), *sc, lis=lis)
    j = j_split(q, k, v, *sc, interpret=True) if lis else j_split_ref(q, k, v, *sc, lis=False)
    assert _diff(t, j) == (0 if lis else off_flips)
    al.vit_attention_plan(n, d, lis)


# ---------------------------------------------------------------------------
# 2 and 3: the qkv-fused kernel at N > 256, head_dims 32 and 128, C_in = 200
# ---------------------------------------------------------------------------

# (N, C, heads, C_in, LIS-off flips)
QKV_SHAPES = [(257, 64, 1, 64, 0), (577, 64, 1, 64, 0), (197, 64, 2, 64, 0), (197, 128, 1, 128, 1),
              (197, 64, 1, 200, 0)]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shape", QKV_SHAPES, ids=lambda s: "n{}c{}h{}cin{}".format(*s[:4]))
def test_qkv_fused_plain_and_padded_vs_jax(shape, lis):
    n, c, heads, c_in, off_flips = shape
    rng = np.random.RandomState(n + c_in)
    h = rng.randint(-128, 128, (1, n, c_in)).astype(np.int8)
    w = rng.randint(-8, 8, (3 * c, c_in)).astype(np.int8)
    r = (2.0 ** rng.randint(-6, -4, 3 * c)).astype(np.float32)
    b = rng.randn(3 * c).astype(np.float32)
    sc = (2.0**-11, 2.0**-4, 2.0)
    args = (T(h), T(w), T(r), T(b), heads, *sc)
    t = al.lis_attention_qkv_fused_plain(*args, lis=lis)
    assert torch.equal(al.lis_attention_qkv_fused_padded_plain(*args, lis=lis), t)
    j = j_qkv(h, w, r, b, heads, *sc, lis=lis, interpret=True)
    assert len(np.unique(t.numpy())) > 20
    assert _diff(t, j) == (0 if lis else off_flips)
    d = c // heads
    assert al.qkv_cluster_plan(n, -(-c_in // 16) * 16, al.qkv_kernel_hd(d)).cluster == -(-n // 64)


def test_qkv_pad_layout():
    """head_dim 32 → the 64-wide instance: each head's q, k, v rows moved to
    the front of its 64-row slot, zeros (and zero requant and bias) after;
    C_in 200 → 208 zero columns."""
    c, heads, c_in = 64, 2, 200
    w = torch.arange(3 * c * c_in, dtype=torch.int64).remainder(251).sub(125).to(torch.int8).reshape(3 * c, c_in)
    h = torch.ones(1, 5, c_in, dtype=torch.int8)
    r, b = torch.arange(3 * c, dtype=torch.float32) + 1, -torch.arange(3 * c, dtype=torch.float32) - 1
    hp, wp, rp, bp, dk = al.qkv_pad(h, w, r, b, heads)
    assert dk == 64 and hp.shape == (1, 5, 208) and wp.shape == (3 * heads * 64, 208)
    for part in range(3):
        for hh in range(heads):
            src, dst = (part * heads + hh) * 32, (part * heads + hh) * 64
            assert torch.equal(wp[dst:dst + 32, :c_in], w[src:src + 32])
            assert torch.equal(rp[dst:dst + 32], r[src:src + 32]) and torch.equal(bp[dst:dst + 32], b[src:src + 32])
            assert not wp[dst + 32:dst + 64].any() and not rp[dst + 32:dst + 64].any()
    assert not wp[:, c_in:].any() and not hp[..., c_in:].any()
    assert al.qkv_pad(h[..., :192], w[:, :192], r, b, 1)[4] == 64  # d = 64: nothing to pad


# ---------------------------------------------------------------------------
# 5: the Swin attention at head_dim 64 (N = 49) and N = 256 (head_dim 32)
# ---------------------------------------------------------------------------

SWIN_SC = (2.0**-9, 2.0**-4, np.float32(2.0**-4), 2.0**-2)


# (res, window, heads, d)
SWIN_SHAPES = [(14, 7, 1, 64), (14, 7, 1, 48), (32, 16, 1, 32)]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("fold", [False, True])
@pytest.mark.parametrize("shape", SWIN_SHAPES, ids=lambda s: "res{}ws{}h{}d{}".format(*s))
def test_swin_attention_plain_and_padded_vs_jax(shape, fold, lis):
    """With the shift mask of a shifted block; folded: the raster grid
    against JAX's folded kernel on the grid rolled by −shift, rolled back;
    panels: the partitioned windows of the rolled grid."""
    res, ws, heads, d = shape
    rng = np.random.RandomState(res + d)
    n, shift = ws * ws, ws // 2
    qkv = rng.randint(-128, 128, (1, res, res, 3 * heads * d)).astype(np.int8)
    bias = (rng.randn(heads, n, n) * 0.3).astype(np.float32)
    mask = (jswin.shift_attn_mask(res, res, ws, shift) / SWIN_SC[2]).astype(np.float32)
    rolled = np.roll(qkv, (-shift, -shift), (1, 2))
    if fold:
        t = al.swin_lis_attention_folded_plain(T(qkv), T(bias), T(mask), heads, ws, *SWIN_SC, lis=lis, shift=shift)
        j = np.roll(np.asarray(j_folded(rolled, bias, mask, heads, ws, *SWIN_SC, lis=lis, interpret=True)),
                    (shift, shift), (1, 2))
    else:
        panels = np.asarray(jswin.window_partition(rolled, ws))
        nw = (res // ws) ** 2
        t = al.swin_lis_attention_plain(T(panels), T(bias), T(mask), heads, nw, *SWIN_SC, lis=lis)
        assert torch.equal(al.swin_lis_attention_padded_plain(T(panels), T(bias), T(mask), heads, nw, *SWIN_SC,
                                                              lis=lis), t)
        j = j_swin(panels, bias, mask, heads, nw, *SWIN_SC, lis=lis, interpret=True)
    assert len(np.unique(t.numpy())) > 20
    assert _diff(t, j) == 0
    hd = al.swin_kernel_hd(d)
    assert al.swin_attention_plan(4, 4, heads, n, lis=lis, hd=hd).smem_bytes == al.swin_attention_smem(n, lis, hd)


# ---------------------------------------------------------------------------
# 6: the stem past C = 1024
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c", [1536, 4096])
def test_stem_plain_vs_jax_past_1024(c):
    """A calibrated state's kinds (every partial sum of the dot exact): 0 codes
    differ; the plan takes clusters of 6 and 16 CTAs."""
    rng = np.random.RandomState(c)
    m = 69
    sw = (2.0 ** rng.randint(-9, -6, c)).astype(np.float32)
    args = ((rng.randint(-128, 128, (m, 48)) * 2.0**-5).astype(np.float32),
            (rng.randint(-8, 8, (c, 48)) * sw[:, None]).astype(np.float32), (rng.randn(c) * 0.05).astype(np.float32),
            (2.0**-3 * 2.0 ** rng.randint(0, 4, c)).astype(np.float32), rng.randn(c).astype(np.float32),
            (rng.randn(c) * 0.1).astype(np.float32), np.float32(2.0**-4))
    t = swin_stem.fused_swin_stem_plain(*(T(a) for a in args))
    j = np.asarray(j_stem(*args, interpret=True))
    assert t.shape == (m, c) and len(np.unique(t.numpy())) > 50
    assert _diff(t, j) == 0
    assert swin_stem.stem_plan(m, 48, c).cs == -(-c // 256)


# ---------------------------------------------------------------------------
# The plans: the new shapes taken, the card's limits named
# ---------------------------------------------------------------------------


def test_plans_take_the_held_shapes():
    for n in (257, 300, 577):
        for hd in (32, 64):
            for lis in (True, False):
                p = al.vit_attention_plan(n, hd, lis)
                assert al.vit_attention_wide(n, p.hdp) and p.smem_bytes <= al.MAX_SMEM
        q = al.qkv_cluster_plan(n, 384)
        assert q.cluster == -(-n // 64) and al.vit_attention_wide(n, q.hd)
    assert al.qkv_cluster_plan(577, 384).cluster == 10  # past 8: the non-portable cluster size
    assert al.vit_attention_plan(197, 128).hdp == 128 and al.qkv_cluster_plan(197, 384, 128).hd == 128
    assert not al.vit_attention_wide(197, 64) and al.vit_attention_wide(197, 128)  # the zoo keeps its rows
    for args in ((17, 32, 2, 128), (17, 96, 3, 384), (257, 384, 6, 1536), (300, 384, 6, 1536),
                 (197, 384, 3, 1536), (17, 40, 5, 100)):
        plan = layer_fused.layer_plan(2, *args)
        assert plan.c_pad % 64 == 0 and plan.hid_pad % 64 == 0 and plan.smem_bytes <= layer_fused.MAX_SMEM
    assert al.swin_attention_plan(8, 4, 2, 256, hd=32).hd == 32
    assert al.swin_attention_plan(8, 4, 2, 49, hd=64).smem_bytes == al.swin_attention_smem(49, True, 64)
    assert swin_stem.stem_plan(100, 48, 4096).cs == 16


@pytest.mark.parametrize("call,match", [
    (lambda: al.vit_attention_plan(577, 128), "shared memory"),
    (lambda: al.vit_attention_plan(800, 64), "shared memory"),
    (lambda: al.vit_attention_plan(197, 129), "head_dim <= 128"),
    (lambda: al.qkv_cluster_plan(1025, 384), "cluster size"),
    (lambda: al.qkv_cluster_plan(1024, 384), "shared memory"),
    (lambda: al.swin_attention_plan(4, 1, 1, 257), "N <= 256"),
    (lambda: al.swin_attention_plan(4, 1, 1, 196, hd=64), "shared memory"),
    (lambda: layer_fused.check_fits(577, 384, 6, 1536), "shared memory.*fuse_layer=False"),
    (lambda: layer_fused.check_fits(197, 384, 3, 1536 * 4), "shared memory.*fuse_layer=False"),
    (lambda: swin_stem.stem_plan(100, 48, 4097), "C <= 4096"),
], ids=["rows-577-d128", "rows-800", "rows-d129", "qkv-1025", "qkv-1024", "swin-257", "swin-d64-196", "layer-577",
        "layer-hid6144", "stem-4097"])
def test_plans_name_the_card_limits(call, match):
    with pytest.raises(ValueError, match=match):
        call()

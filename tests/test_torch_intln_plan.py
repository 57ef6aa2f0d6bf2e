"""The int-LN kernels' plan, zero padding and exact row sums, on the CPU.

* ``ln_pad``: at C = 18, 98 and 100 the padded call's plain path (the
  kernel's chain on the zero-padded codes and vectors, the LN counting the
  true C) equals the unpadded plain version and JAX's kernels run with
  ``interpret=True``, bit for bit, but for the residual codes that XLA:CPU's
  FMA contraction flips in JAX's kernel (stated counts, traced as in
  ``tests/test_torch_swin_serving.py``);
* ``ln_plan`` at every LN shape of the zoo (Swin-T/S/B norms and merges,
  the staged ViT prologue) at batches 1, 8, 64, and at the widest C JAX
  serves: whole 16-byte chunks, each chunk owned by one lane, no lane idle
  at C = 96, nothing refused below the limit;
* a replay of the kernel's lane partition and its sums (float lane Σx, float
  chunk Σx² into an int32 lane sum, int64 across the lanes; or int64 of
  truncated x where a mask is not a small integer) against ``row_sums``,
  exactly, including rows of ±128 at mask 8 at the widest C, where Σx²
  passes 2^31.
"""

import numpy as np
import pytest
import torch

from p2vit_tpu.ops.intln import int_ln_requant as j_ln
from p2vit_tpu.ops.intln import int_res_ln_requant as j_res_ln
from p2vit_tpu.ops.intln import int_res_ln_requant_ref
from p2vit_tpu_torch.ops import intln

M = 200


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


def _ptf(rng, n, base):
    """PTF scale vector base·2^k, k ∈ {0..3}: LN masks {1, 2, 4, 8}."""
    return (base * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)


def _ln_args(c):
    rng = np.random.RandomState(c)
    s_in = _ptf(rng, c, 0.013)
    return (rng.randint(-128, 128, (M, c)).astype(np.int8), np.round(s_in / s_in.min()), s_in.min(),
            rng.randn(c).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32),
            (np.abs(rng.randn(c)) * 0.03 + 0.01).astype(np.float32), np.float32(1.0))


def _res_args(c):
    rng = np.random.RandomState(c + 1)
    return (rng.randint(-128, 128, (M, c)).astype(np.int8), _ptf(rng, c, 0.011),
            rng.randint(-128, 128, (M, c)).astype(np.int8), np.float32(2.0**-5), _ptf(rng, c, 0.017),
            rng.randn(c).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32), np.float32(2.0**-4),
            np.float32(1.0))


def _t(args):
    return [T(a) if isinstance(a, np.ndarray) else torch.tensor(a) for a in args]


@pytest.mark.parametrize("c", [18, 98, 100])
def test_int_ln_requant_padded_width(c):
    args = _ln_args(c)
    ta = _t(args)
    want = intln.int_ln_requant_plain(*ta)
    vecs, s1 = intln.ln_requant_consts(c, torch.device("cpu"), *ta[1:])
    vp, codes_p = intln.ln_pad(vecs, ta[0])
    plan = intln.ln_plan(M, c)
    assert codes_p.shape == (M, plan.c_pad) and vp.shape == (4, plan.c_pad) and plan.c_pad % 16 == 0
    assert bool((codes_p[:, c:] == 0).all()) and bool((vp[:, c:] == 0).all())
    got = intln.ln_requant_codes(codes_p, vp, s1, c_true=c)[:, :c]
    assert torch.equal(got, want)
    assert n_diff(j_ln(*args, interpret=True), want) == 0


# the residual codes XLA:CPU's contracted a·s_a + b·s_b flips in JAX's kernel
# (interpret mode) on these 200 rows, at C = 18, 98, 100; the LN codes differ
# only in rows that hold such a flip (0, 6 and 1 codes)
RES_FMA_FLIPS = {18: (2, 0), 98: (6, 6), 100: (4, 1)}  # (residual codes, LN codes)


@pytest.mark.parametrize("c", [18, 98, 100])
def test_int_res_ln_requant_padded_width(c):
    args = _res_args(c)
    ta = _t(args)
    want = intln.int_res_ln_requant_plain(*ta)
    vecs, s1 = intln.res_ln_requant_consts(c, torch.device("cpu"), *ta[1:2], *ta[3:])
    vp, a_p, b_p = intln.ln_pad(vecs, ta[0], ta[2])
    plan = intln.ln_plan(M, c, res=True)
    assert a_p.shape == b_p.shape == (M, plan.c_pad) and vp.shape == (7, plan.c_pad)
    got = intln.res_ln_requant_codes(a_p, b_p, vp, s1, c_true=c)
    assert bool((got[0][:, c:] == 0).all())
    for g, w in zip(got, want):
        assert torch.equal(g[:, :c], w)
    ref = int_res_ln_requant_ref(*args)
    assert n_diff(ref[0], want[0]) == 0 and n_diff(ref[1], want[1]) == 0
    j = j_res_ln(*args, interpret=True)
    assert (n_diff(j[0], want[0]), n_diff(j[1], want[1])) == RES_FMA_FLIPS[c]
    a, sa, b, sb, so = args[:5]  # JAX's residual codes are those of the once-rounded sum
    once = (a.astype(np.float64) * sa + b.astype(np.float64) * np.float64(sb)).astype(np.float32)
    inv = np.float32(1.0) / np.maximum(so, np.float32(1e-30))
    assert n_diff(j[0], np.clip(np.round(once * inv), -128, 127)) == 0
    flipped_rows = set(np.nonzero(np.asarray(j[0]) != want[0].numpy())[0])
    assert set(np.nonzero(np.asarray(j[1]) != want[1].numpy())[0]) <= flipped_rows


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

def _swin_shapes(embed, b):
    """(M, C, residual) of a Swin's int-LN calls: the patch norm and each
    stage's first norm1 (int_ln_requant), the PatchMerging norms at 4C
    (int_ln_requant), the attention-side junctions (int_res_ln_requant)."""
    out = []
    for s in range(4):
        res, c = 56 >> s, embed << s
        out += [(b * res * res, c, False), (b * res * res, c, True)]
        if s < 3:
            out.append((b * (res // 2) ** 2, 4 * c, False))
    return out + [(b * 56 * 56, embed, False)]


SHAPES = {
    "swin_tiny": lambda b: _swin_shapes(96, b),  # Swin-S has Swin-T's widths
    "swin_base": lambda b: _swin_shapes(128, b),
    "vit_prologue": lambda b: [(b * 197, c, False) for c in (192, 384, 768, 1024)],  # DeiT-T/S/B, ViT-L staged
    "widest": lambda b: [(b * 49, intln.MAX_C, False), (b * 49, intln.MAX_RES_C, True)],
}


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("model", sorted(SHAPES))
def test_ln_plan_covers_every_zoo_shape(model, batch):
    for m, c, res in SHAPES[model](batch):
        p = intln.ln_plan(m, c, res, sms=132, ctas_per_sm=4)
        assert p.c_pad % 16 == 0 and c <= p.c_pad < c + 16
        assert p.g in (2, 4, 8, 16, 32) and p.k in intln.K_SET and p.rows * p.g == intln.THREADS
        owned = sorted(j for lane in range(p.g) for j in p.lane_chunks(lane))
        assert owned == list(range(p.chunks))  # each 16-byte chunk owned by one lane, whole
        i = intln.K_SET.index(p.k)  # the fewest chunks a lane that cover the row
        assert p.k * p.g >= p.chunks and (i == 0 or intln.K_SET[i - 1] * p.g < p.chunks)
        assert p.blocks * p.rows >= m > (p.blocks - 1) * p.rows
        assert p.grid == min(p.blocks, 132 * 4)
        assert p.smem_bytes == p.chunks * intln.LD * 16 * (2 if res else 1) <= 232_448
        if c % 96 == 0 and c <= 1536:
            assert p.k == 3 and p.g * 3 == p.chunks  # Swin-T's widths: every lane busy
        if c == 96:
            assert (p.g, p.rows) == (2, 128)


@pytest.mark.parametrize("res", [False, True])
def test_ln_plan_refuses_past_jax_width(res):
    limit = intln.MAX_RES_C if res else intln.MAX_C
    assert (intln.MAX_C, intln.MAX_RES_C) == (4736, 4352)
    assert 128 * limit * (30 if res else 27) <= 2 ** 24 < 128 * (limit + 128) * (30 if res else 27)
    assert intln.ln_plan(8, limit, res).k == 10
    with pytest.raises(ValueError, match=f"C <= {limit}"):
        intln.ln_plan(8, limit + 1, res)
    with pytest.raises(ValueError, match="G in"):
        intln.ln_plan(8, 96, res, g=3)


# ---------------------------------------------------------------------------
# the kernel's sums, replayed
# ---------------------------------------------------------------------------

def _replay_sums(x: torch.Tensor, mask: torch.Tensor, plan):
    """Σx and Σx² per row as the kernel takes them on ``plan``'s lanes: where
    every mask is an integer of magnitude ≤ 8, a lane's Σx as a float32 sum
    in its element order and each chunk's Σx² as float32 fmaf sums, the
    chunk sums into an int32 lane sum; else int64 sums of x truncated. The
    G lane sums add in int64. Checks each partial stays exact."""
    m, c = x.shape
    xp = torch.nn.functional.pad(x, (0, plan.c_pad - c)).view(m, plan.chunks, 16)
    small = bool(((mask == torch.round(mask)) & (mask.abs() <= 8)).all())
    sx = torch.zeros(m, dtype=torch.int64)
    sxx = torch.zeros(m, dtype=torch.int64)
    for lane in range(plan.g):
        chunks = plan.lane_chunks(lane)
        if not chunks:
            continue
        xs = xp[:, chunks, :]  # (m, k, 16) in the lane's order
        if small:
            f = xs.reshape(m, -1).to(torch.float32)
            acc = torch.zeros(m, dtype=torch.float32)
            for i in range(f.shape[1]):  # float32 adds, in order
                acc = acc + f[:, i]
            assert bool((acc.abs() < 2**24).all())
            lane_sx = acc.to(torch.int64)
            chunk_sq = (xs.to(torch.int64) ** 2).sum(-1)  # each fmaf sum exact: integers ≤ 2^24
            assert int(chunk_sq.max()) <= 2**24
            lane_sxx = chunk_sq.sum(-1)
            assert int(lane_sxx.max()) < 2**31  # the int32 lane sum
        else:
            xi = xs.reshape(m, -1).to(torch.int64)  # truncation toward zero
            lane_sx, lane_sxx = xi.sum(-1), (xi * xi).sum(-1)
        sx += lane_sx
        sxx += lane_sxx
    return sx, sxx


SUM_CASES = {
    "swin_t_96": (96, "ptf", False),
    "padded_18": (18, "ptf", False),
    "merge_1536": (1536, "ptf", False),
    "widest_ln_pm128_mask8": (intln.MAX_C, "pm128x8", False),
    "widest_res_pm128_mask8": (intln.MAX_RES_C, "pm128x8", True),
    "mask_16_int64_path": (384, "mask16", False),
    "mask_fraction_int64_path": (98, "fraction", False),
}


@pytest.mark.parametrize("case", sorted(SUM_CASES))
def test_replayed_kernel_sums_equal_row_sums(case):
    c, kind, res = SUM_CASES[case]
    rng = np.random.RandomState(c)
    codes = torch.from_numpy(rng.randint(-128, 128, (64, c)).astype(np.float32))
    if kind == "pm128x8":
        codes = torch.from_numpy(np.where(rng.rand(64, c) < 0.5, -128, 127).astype(np.float32))
        codes[0] = -128  # Σx² = C·2^20 > 2^32
        mask = torch.full((c,), 8.0)
    elif kind == "mask16":
        mask = torch.from_numpy(2.0 ** rng.randint(0, 5, c)).to(torch.float32)
        mask[0] = 16.0
    elif kind == "fraction":
        mask = torch.from_numpy(rng.randint(1, 9, c).astype(np.float32) * 0.75)
    else:
        mask = torch.from_numpy(2.0 ** rng.randint(0, 4, c)).to(torch.float32)
    x = codes * mask[None, :]
    plan = intln.ln_plan(64, c, res)
    sx, sxx = _replay_sums(x, mask, plan)
    want_sx, want_sxx = intln.row_sums(x)
    assert torch.equal(sx.to(torch.float32)[:, None], want_sx)
    assert torch.equal(sxx.to(torch.float32)[:, None], want_sxx)
    assert torch.equal(sxx, (x.to(torch.int64) ** 2).sum(-1))
    if kind == "pm128x8":
        assert int(sxx[0]) == c * 2**20 > 2**32 and int(sxx.min()) > 2**31

"""The qkv-fused attention kernel's cluster design, on the CPU.

``csrc/attention_lis.cu`` runs ``lis_attention_qkv_fused`` as one cluster of
ceil(N/64) CTAs per (image, head): each CTA computes the q/k/v codes of 64
token rows, shares K and V through distributed shared memory and attends a
balanced share of the 16-row query groups; attn@v runs on u8·s8 tensor cores
over the LIS weights split into two byte planes. The kernel needs the card
(``tests/test_torch_cuda_kernels.py``); here: its Python launch plan
(``qkv_cluster_plan``), the exactness of the byte-plane split, the kernel's
data flow replayed in PyTorch, and the plain version against the JAX kernel
(interpret mode) at the N where the cluster split changes shape. Every
comparison is bit for bit.
"""

import math

import numpy as np
import pytest
import torch

from p2vit_tpu.ops.attention_lis import lis_attention_qkv_fused as j_qkv_fused
from p2vit_tpu_torch.ops import attention_lis as al
from p2vit_tpu_torch.ops.fastmath import exp2i
from p2vit_tpu_torch.ops.matmul_int8 import int8_matmul_requant_plain

NS = [1, 5, 16, 64, 65, 197, 256]
SM_SHARED = 228 * 1024  # shared memory of one H100 SM; each resident CTA reserves 1 KB of it


@pytest.mark.parametrize("n", NS)
def test_plan_attends_every_query_row_once(n):
    """The CTAs' query groups are contiguous, balanced within one group, and
    cover rows 0 … N−1 exactly once; the keys fit the cluster's 64-row tiles."""
    plan = al.qkv_cluster_plan(n, 384)
    assert plan.cluster == math.ceil(n / 64) <= 4
    seen = np.zeros(n, np.int64)
    nxt = 0
    for first, count in plan.groups:
        assert first == nxt and count >= 1
        nxt = first + count
        seen[16 * first:min(16 * (first + count), n)] += 1
    assert nxt == math.ceil(n / 16)
    assert (seen == 1).all()
    counts = [c for _, c in plan.groups]
    assert max(counts) - min(counts) <= 1
    assert n <= plan.kpad <= 64 * plan.cluster and plan.kpad % 32 == 0
    if n == 197:
        assert counts == [4, 3, 3, 3]


@pytest.mark.parametrize("n", NS)
def test_plan_fits_shared_memory(n):
    """Every CTA's shared memory fits the 232,448 B a block may use, and two
    CTAs fit one SM at every N (the kernel's occupancy target)."""
    plan = al.qkv_cluster_plan(n, 384)
    assert al.GEMM_STAGE_BYTES <= plan.smem_bytes <= al.MAX_SMEM == 232_448
    assert 2 * (plan.smem_bytes + 1024) <= SM_SHARED
    assert plan == al.qkv_cluster_plan(n, 768)  # C_in streams through the GEMM's stages


@pytest.mark.parametrize("n,c_in,match", [(1025, 384, "N <= 1024"), (0, 384, "N <= 1024"),
                                          (197, 392, "C_in % 16")])
def test_plan_raises_where_the_kernel_does_not_run(n, c_in, match):
    with pytest.raises(ValueError, match=match):
        al.qkv_cluster_plan(n, c_in)


def _planes(w_int):
    """The kernel's two u8 planes of a LIS weight: (w >> 8, w & 0xFF)."""
    w = w_int.to(torch.int32)
    return (w >> 8).to(torch.uint8), (w & 0xFF).to(torch.uint8)


def test_lis_weight_planes_are_exact_for_every_weight_and_code():
    """All 17 LIS weights 2^(15−q) (q = 0 … 15) and 0, against all 256 int8
    v codes: 256·hi·v + lo·v == w·v, with hi and lo in u8 (≤ 128); a full
    row's partial sums stay within int32 (|Σ hi·v| ≤ 256·128·128 = 2^22)."""
    w = torch.tensor([0] + [2**k for k in range(16)], dtype=torch.int32)
    hi, lo = _planes(w)
    assert hi.dtype == lo.dtype == torch.uint8
    assert int(hi.max()) <= 128 and int(lo.max()) <= 128
    assert torch.equal(hi.to(torch.int32) * 256 + lo.to(torch.int32), w)
    v = torch.arange(-128, 128, dtype=torch.int64)
    lhs = 256 * hi.to(torch.int64)[:, None] * v[None] + lo.to(torch.int64)[:, None] * v[None]
    assert torch.equal(lhs, w.to(torch.int64)[:, None] * v[None])
    assert 256 * int(hi.max()) * 128 <= 2**22 and 256 * 2**22 < 2**31


def _inputs(seed, b, n, c_in, c, heads):
    rng = np.random.RandomState(seed)
    h = rng.randint(-128, 128, (b, n, c_in)).astype(np.int8)
    w = rng.randint(-128, 128, (3 * c, c_in)).astype(np.int8)
    rv = (2.0 ** rng.randint(-13, -10, 3 * c)).astype(np.float32)
    bv = rng.randn(3 * c).astype(np.float32)
    return h, w, rv, bv, heads


@pytest.mark.parametrize("n", [5, 64, 65])
def test_qkv_fused_plain_vs_jax_at_the_cluster_edges(n):
    """One CTA and one query group (5), one full tile (64), one row over a
    tile (65): the plain version equals the JAX kernel (interpret mode) at
    C = 128, 2 heads."""
    h, w, rv, bv, heads = _inputs(40 + n, 2, n, 128, 128, 2)
    sr, sa, ro = 2.0**-11, 2.0**-5, 0.5
    t = al.lis_attention_qkv_fused_plain(*(torch.from_numpy(a) for a in (h, w, rv, bv)), heads, sr, sa, ro)
    j = np.asarray(j_qkv_fused(h, w, rv, bv, heads, sr, sa, ro, images_per_step=2, interpret=True))
    assert t.shape == (2, n, 128) and t.dtype == torch.int8
    assert int((t.numpy().astype(np.int32) != j.astype(np.int32)).sum()) == 0


def _cluster_replay(h, w, rv, bv, heads, sr, sa, ro, c_in):
    """The kernel's data flow in PyTorch: per (image, head), each CTA of the
    plan computes the q/k/v codes of its 64 rows (zeros past N), the whole
    K and V are assembled from the CTAs' tiles (keys padded to kpad), and
    each CTA attends its query groups with attn@v as 256·(hi@v) + lo@v."""
    b, n, _ = h.shape
    c = w.shape[0] // 3
    plan = al.qkv_cluster_plan(n, c_in)
    qkv = int8_matmul_requant_plain(h.reshape(-1, c_in), w, rv, bv).reshape(b, n, 3, heads, 64)
    out = torch.zeros((b, n, c), dtype=torch.int8)
    sa_t = torch.tensor(sa, dtype=torch.float32)
    for img in range(b):
        for hd in range(heads):
            tiles = torch.zeros((plan.cluster * 64, 3, 64), dtype=torch.int8)
            for r in range(plan.cluster):  # CTA r's own rows
                rows = slice(64 * r, min(64 * r + 64, n))
                tiles[rows] = qkv[img, rows, :, hd]
            k, v = tiles[:plan.kpad, 1], tiles[:plan.kpad, 2]
            for first, count in plan.groups:
                q = tiles[16 * first:16 * (first + count), 0]
                scores = al._scores(q, k[:n], sr)
                big = al.lis_codes(scores, sa_t)
                w_int = torch.where(big < 16, exp2i(al.AV_SHIFT - big), torch.zeros_like(scores))
                w_int = torch.nn.functional.pad(w_int, (0, plan.kpad - n)).to(torch.int64)
                hi, lo = _planes(w_int)
                v64 = v.to(torch.int64)
                av_int = 256 * (hi.to(torch.int64) @ v64) + lo.to(torch.int64) @ v64
                av = av_int.to(torch.float32) * 2.0**-al.AV_SHIFT
                o = torch.clamp(torch.round(av * torch.tensor(ro, dtype=torch.float32)), -128, 127)
                rows = slice(16 * first, min(16 * (first + count), n))
                out[img, rows, 64 * hd:64 * hd + 64] = o[:rows.stop - rows.start].to(torch.int8)
    return out


@pytest.mark.parametrize("n", [5, 65, 197])
def test_cluster_replay_equals_the_plain_version(n):
    """The kernel's split (64-row q/k/v tiles per CTA, 16-row query groups,
    keys padded with zeros, attn@v over the byte planes) gives the plain
    version's codes bit for bit."""
    h, w, rv, bv, heads = (torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                           for a in _inputs(60 + n, 2, n, 128, 128, 2))
    args = (h, w, rv, bv, heads, 2.0**-11, 2.0**-5, 0.5)
    assert torch.equal(_cluster_replay(*args, c_in=128), al.lis_attention_qkv_fused_plain(*args))

"""The Hopper ``int8_matmul_requant`` kernel's tiling, on the CPU.

``csrc/gemm_wgmma.cuh`` runs the int8 GEMM with its requant epilogue on a
persistent grid: each CTA takes tiles c, c + grid, …, its consumer
warpgroups (two; six with GELU) take them in turn, and each tile is 64 rows
× BN columns, fed 128 bytes of K at a time by TMA with zeros past the edges. The kernel needs
the card (``tests/test_torch_cuda_kernels.py``); here: its Python launch
plan (``requant_plan``) at every shape of the DeiT-S and Swin-T serving
paths, the kernel's tile walk replayed in PyTorch, and the plain version
against the JAX reference. Every comparison is bit for bit.
"""

import numpy as np
import pytest
import torch

from p2vit_tpu.ops.matmul_int8 import int8_matmul_requant_ref
from p2vit_tpu_torch.ops import matmul_int8 as mi

# (M, K, N, GELU) of every int8_matmul_requant call at batch 64: DeiT-S (fc1,
# head, the staged qkv and patch GEMM) and Swin-T (per stage qkv, proj, fc1,
# fc2, PatchMerging reduction; the head; the int stem)
SHAPES = [
    (12608, 384, 1536, True), (64, 384, 1000, False), (12608, 384, 1152, False), (12544, 768, 384, False),
    (200704, 96, 288, False), (200704, 96, 96, False), (200704, 96, 384, True), (200704, 384, 96, False),
    (50176, 384, 192, False), (50176, 192, 576, False), (50176, 192, 192, False), (50176, 192, 768, True),
    (50176, 768, 192, False), (12544, 384, 1152, False), (12544, 384, 384, False), (12544, 384, 1536, True),
    (12544, 1536, 384, False), (3136, 1536, 768, False), (3136, 768, 2304, False), (3136, 768, 768, False),
    (3136, 768, 3072, True), (64, 768, 1000, False), (200704, 48, 96, False),
]
H100_SMS = 132


def _wgmma_width_ok(n: int) -> bool:
    """N of an integer ``wgmma.m64nNk32``: 8, 16, 24, or a multiple of 16 up to 256."""
    return n in (8, 16, 24) or (n % 16 == 0 and 16 <= n <= 256)


@pytest.mark.parametrize("m,k,n,gelu", SHAPES)
def test_plan_covers_every_output_once(m, k, n, gelu):
    """Each tile of the walk is taken once, by one CTA and its consumers in
    turn; the tiles cover the (M, N) output exactly; BN is a legal integer
    wgmma width that wastes the fewest columns; the ring fits shared memory."""
    plan = mi.requant_plan(m, n, k, H100_SMS, gelu)
    widths = mi.GELU_WIDTHS if gelu else mi.WIDTHS
    assert _wgmma_width_ok(plan.bn) and (plan.bn, plan.nc) in widths
    waste = -(-n // plan.bn) * plan.bn - n
    assert waste == min(-(-n // w) * w - n for w, _ in widths)
    if not gelu:
        assert {96: 96, 288: 144, 384: 192, 1536: 256, 1000: 144}.get(n, plan.bn) == plan.bn
    assert (plan.tiles_m - 1) * mi.TILE_M < m <= plan.tiles_m * mi.TILE_M
    assert (plan.tiles_n - 1) * plan.bn < n <= plan.tiles_n * plan.bn
    assert plan.grid == min(H100_SMS, plan.tiles)
    assert 2 <= plan.stages <= mi.MAX_STAGES
    assert plan.smem_bytes == mi.requant_smem(plan.bn, plan.nc, plan.stages, gelu) <= mi.MAX_SMEM
    assert plan.stages == mi.MAX_STAGES or mi.requant_smem(plan.bn, plan.nc, plan.stages + 1, gelu) > mi.MAX_SMEM
    assert 128 * (plan.nc + 1) <= 1024
    seen = np.zeros((plan.tiles_m, plan.tiles_n), np.int64)
    last = {}
    for cta, consumer, i, t in plan.walk():
        m0, n0 = plan.tile(t)
        assert t % plan.grid == cta and consumer == i % plan.nc
        assert last.get(cta, -1) == i - 1  # a CTA's tiles come in order
        last[cta] = i
        seen[m0 // mi.TILE_M, n0 // plan.bn] += 1
    assert (seen == 1).all()


def _case(seed, m, k, n, gelu):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    r = (2.0 ** rng.randint(-14, -9, n) if gelu else 2.0 ** rng.randint(-12, -7, n)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, w, r, b


def _replay(plan, x, w, r, b, out_inv, qmin, qmax, gelu):
    """The kernel's data flow in PyTorch: TMA boxes of 64 x rows and BN w
    rows, 128 bytes of K each, zeros past M, N and K; the exact int32 sum over
    the slices; the epilogue on the tile with r and b zero past N; only the
    tile's rows and columns inside the output stored. Returns the output and
    how often each element was stored."""
    (m, k), n = x.shape, w.shape[0]
    nk = -(-k // mi.TILE_K)
    xp = torch.zeros((plan.tiles_m * mi.TILE_M, nk * mi.TILE_K), dtype=torch.int64)
    wp = torch.zeros((plan.tiles_n * plan.bn, nk * mi.TILE_K), dtype=torch.int64)
    xp[:m, :k], wp[:n, :k] = x, w
    rp, bp = torch.zeros(wp.shape[0]), torch.zeros(wp.shape[0])
    rp[:n], bp[:n] = r, b
    out = torch.zeros((m, n), dtype=torch.int8)
    stores = torch.zeros((m, n), dtype=torch.int64)
    for _, _, _, t in plan.walk():
        m0, n0 = plan.tile(t)
        acc = torch.zeros((mi.TILE_M, plan.bn), dtype=torch.int64)
        for s in range(nk):
            ks = slice(s * mi.TILE_K, (s + 1) * mi.TILE_K)
            acc += xp[m0:m0 + mi.TILE_M, ks] @ wp[n0:n0 + plan.bn, ks].T
        tile = mi.requant_epilogue_plain(acc.to(torch.int32), rp[n0:n0 + plan.bn], bp[n0:n0 + plan.bn],
                                         out_inv, qmin, qmax, gelu)
        rows, cols = min(mi.TILE_M, m - m0), min(plan.bn, n - n0)
        out[m0:m0 + rows, n0:n0 + cols] = tile[:rows, :cols]
        stores[m0:m0 + rows, n0:n0 + cols] += 1
    return out, stores


@pytest.mark.parametrize("m", [1, 77])
@pytest.mark.parametrize("n", [96, 288, 1000])
@pytest.mark.parametrize("k", [48, 96])
def test_tile_walk_replay_equals_plain(m, n, k):
    """On the ragged shapes (K < the 128-byte slice, N = 1000 with a masked
    edge, M below one tile), the replayed tile walk on a 3-SM grid (the
    consumers of a CTA take turns) equals the plain version, every element
    stored once."""
    gelu = n != 96
    x, w, r, b = (torch.from_numpy(a) for a in _case(m * n + k, m, k, n, gelu))
    out_inv = torch.tensor(16.0)
    plan = mi.requant_plan(m, n, k, 3, gelu)
    got, stores = _replay(plan, x, w, r, b, out_inv, -128, 127, gelu)
    assert (stores == 1).all()
    want = mi.int8_matmul_requant_plain(x, w, r, b, out_inv, gelu=gelu)
    assert torch.equal(got, want)


@pytest.mark.parametrize("m,k,n", [(49, 96, 288), (49, 96, 96), (49, 384, 96), (35, 192, 576)])
@pytest.mark.parametrize("gelu", [False, True])
def test_plain_matches_jax_ref_at_swin_widths(m, k, n, gelu):
    """The plain version (which the kernel equals bit for bit on the card)
    against JAX's ``int8_matmul_requant_ref`` at Swin-T's narrow widths, with
    and without the GELU epilogue, and with the narrow clamp of 4-bit codes."""
    x, w, r, b = _case(7 * m + n, m, k, n, gelu)
    inv = np.float32(16.0)
    for qmin, qmax in ((-128, 127), (-8, 7)):
        want = np.asarray(int8_matmul_requant_ref(x, w, r, b, out_inv=inv, qmin=qmin, qmax=qmax, gelu=gelu))
        got = mi.int8_matmul_requant_plain(*(torch.from_numpy(a) for a in (x, w, r, b)),
                                           torch.tensor(inv), qmin, qmax, gelu)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("m,n,k,sms,match", [
    (64, 96, 40, 132, "K % 16"), (64, 96, 0, 132, "K % 16"), (64, 96, -16, 132, "K % 16"),
    (2 ** 31, 96, 96, 132, "2\\^31"), (64, 2 ** 31, 96, 132, "2\\^31"), (64, 96, 96, 0, "SM"),
])
def test_plan_raises_where_the_kernel_does_not_run(m, n, k, sms, match):
    with pytest.raises(ValueError, match=match):
        mi.requant_plan(m, n, k, sms)

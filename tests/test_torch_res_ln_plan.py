"""The Hopper ``int8_matmul_res_ln`` kernel's plan and data flow, and the
zero padding of the three wrappers that pad, on the CPU.

``csrc/matmul_ln.cu`` runs the junction on a persistent grid: each CTA takes
row blocks in turn, each of 64·NC whole rows (NC consumer warpgroups of 64
rows), its CS CTAs splitting N; a CTA sweeps its columns in chunks of BN fed
128 bytes of K at a time by TMA with zeros past the edges, writes each
chunk's residual codes into a code tile with integer partial row sums,
adds its peers' sums, and runs the LN from the stored codes. The kernel needs the card
(``tests/test_torch_cuda_kernels.py``); here: its Python plan
(``res_ln_plan``) at every junction of the zoo, the kernel's walk replayed
in PyTorch, the plain version against the JAX kernel, and each wrapper's
padding function against the plain version on the unpadded inputs. Every
comparison is bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.ops.embed_fused import fused_patch_embed as j_embed
from p2vit_tpu.ops.matmul_ln import int8_matmul_res_ln as j_resln
from p2vit_tpu.ops.matmul_ln import int8_matmul_res_ln_ref
from p2vit_tpu_torch.ops import embed_fused, intln, matmul_int8, matmul_ln as ml

H100_SMS = 132
# clusters of 1, 2, 3 and 4 CTAs one H100 SXM holds at once at one CTA per
# SM (cudaOccupancyMaxActiveClusters, res_ln_kernel_info on the card)
H100_RESIDENT = (132, 66, 39, 30)
# (M, N, K) of every junction of the zoo's serving paths at batch 64:
# DeiT-T/S/B and ViT-B/L (proj K = C, fc2 K = 4C, M = 64·197), Swin-T/S
# (C = 96 … 768) and Swin-B (C = 128 … 1024) per stage (M = 64·56², 64·28²,
# 64·14², 64·7²)
ZOO_SHAPES = [
    (12608, 192, 192), (12608, 192, 768), (12608, 384, 384), (12608, 384, 1536), (12608, 768, 768),
    (12608, 768, 3072), (12608, 1024, 1024), (12608, 1024, 4096),
    (200704, 96, 384), (50176, 192, 768), (12544, 384, 1536), (3136, 768, 3072),
    (200704, 128, 512), (50176, 256, 1024), (12544, 512, 2048), (3136, 1024, 4096),
]


# (cluster size, chunk width, chunks per CTA, consumers) the plan picks on
# the H100: DeiT-S's and Swin-T's wide stages fill the card with CTAs of 128
# whole rows; Swin-T stage 3 (25 such blocks) spreads each block's columns
# over a cluster of four; batch 8 (1,576 rows) over clusters of four with
# one consumer
PINNED = {(12608, 384): (1, 192, 2, 2), (12544, 384): (1, 192, 2, 2), (3136, 768): (4, 192, 1, 2),
          (200704, 96): (1, 96, 1, 2), (50176, 192): (1, 192, 1, 2), (1576, 384): (4, 96, 1, 1)}


def _load(m, cs, nc, cols):
    """Elements of the busiest consumer: ⌈blocks / resident clusters⌉ row
    blocks × 64 rows × the CTA's columns."""
    return -(-(-(-m // (64 * nc))) // H100_RESIDENT[cs - 1]) * 64 * cols


@pytest.mark.parametrize("m,n,k", ZOO_SHAPES + [(1576, 384, 384)])
def test_plan_at_every_zoo_junction(m, n, k):
    """The cluster's CTAs split N into equal parts of cpc chunks of a width
    of WIDTHS, wasting no more columns than one CTA would; the row blocks
    cover M once, each taken by one cluster in its turn, and the grid's
    clusters are all resident; the ring has two stages or more and shared
    memory holds it, and one more stage would not fit (or the ring is at
    its maximum); no other cluster size and consumer count that fits gives
    the busiest consumer fewer elements."""
    plan = ml.res_ln_plan(m, n, k, H100_SMS, H100_RESIDENT)
    assert plan.n_pad == n and plan.k_pad == k  # the zoo pads nothing
    widths = [w for w, _ in matmul_int8.WIDTHS]
    assert plan.bn in widths and plan.cs * plan.cols - n == min(-(-n // w) * w - n for w in widths) == 0
    assert PINNED.get((m, n), (plan.cs, plan.bn, plan.cpc, plan.nc)) == (plan.cs, plan.bn, plan.cpc, plan.nc)
    assert (plan.blocks - 1) * plan.rows < m <= plan.blocks * plan.rows
    assert plan.grid == min(H100_RESIDENT[plan.cs - 1], plan.blocks) * plan.cs
    assert 2 <= plan.stages <= matmul_int8.MAX_STAGES
    smem = lambda st: ml.res_ln_smem(plan.bn, plan.cpc, plan.nc, st, plan.cs)  # noqa: E731
    assert plan.smem_bytes == smem(plan.stages) <= matmul_int8.MAX_SMEM
    assert plan.stages == matmul_int8.MAX_STAGES or smem(plan.stages + 1) > matmul_int8.MAX_SMEM
    load = _load(m, plan.cs, plan.nc, plan.cols)
    for cs in range(1, ml.MAX_CLUSTER + 1):
        for w in widths:
            if n % (cs * w) == 0:
                for nc in range(1, ml.MAX_CONSUMERS + 1):
                    if ml.res_ln_smem(w, n // (cs * w), nc, 2, cs) <= matmul_int8.MAX_SMEM:
                        assert load <= _load(m, cs, nc, n // cs)
    seen = np.zeros(plan.blocks, np.int64)
    last = {}
    for cl, i, blk in plan.walk():
        assert blk % (plan.grid // plan.cs) == cl and last.get(cl, -1) == i - 1
        last[cl] = i
        seen[blk] += 1
    assert (seen == 1).all()
    ld = ml.code_ld(plan.cols)
    assert ld % 16 == 0 and (ld // 4) % 8 == 4  # 16-byte rows; a quad group's 8 rows in distinct banks


@pytest.mark.parametrize("cs,nc", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (4, 1), (4, 2)])
def test_forced_plans_at_deit_s(cs, nc):
    """The measurement hook's plans at DeiT-S's junction (M = 12608, N = 384):
    each (cluster size, consumers) fits, splits N evenly and keeps every
    cluster resident."""
    plan = ml.res_ln_plan(12608, 384, 384, H100_SMS, H100_RESIDENT, cs, nc)
    assert (plan.cs, plan.nc) == (cs, nc) and plan.cs * plan.cols == 384
    assert plan.grid == min(H100_RESIDENT[cs - 1], plan.blocks) * cs and plan.stages >= 2


@pytest.mark.parametrize("m,n,k,sms,match", [
    (64, 96, 0, 132, "K > 0"), (64, 2064, 96, 132, "N <= 2048"), (64, 0, 96, 132, "N <= 2048"),
    (2 ** 31, 96, 96, 132, "2\\^31"), (64, 96, 96, 0, "SM"),
])
def test_plan_raises_where_the_kernel_does_not_run(m, n, k, sms, match):
    with pytest.raises(ValueError, match=match):
        ml.res_ln_plan(m, n, k, sms)
    if match == "K > 0":  # a cluster that would split N = 96 into padded halves
        with pytest.raises(ValueError, match="no plan fits"):
            ml.res_ln_plan(m, n, 96, sms, cs=2)


def _args(seed, m, k, n, mask_max=16):
    """Seeded junction arguments: int8 x, int4-valued weights, PoT requant
    scales, residual codes, PTF scales with masks up to ``mask_max``."""
    rng = np.random.RandomState(seed)
    lg = int(np.log2(mask_max))
    s_out = (0.013 * 2.0 ** rng.randint(0, lg + 1, n)).astype(np.float32)
    s_out[0] = 0.013
    s_out[-1] = 0.013 * mask_max
    return (rng.randint(-128, 128, (m, k)).astype(np.int8), rng.randint(-8, 8, (n, k)).astype(np.int8),
            (2.0 ** rng.randint(-10, -6, n)).astype(np.float32), rng.randn(n).astype(np.float32),
            rng.randint(-128, 128, (m, n)).astype(np.int8),
            (np.abs(rng.randn(n)) * 0.02 + 0.01).astype(np.float32),
            (0.011 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32), s_out,
            rng.randn(n).astype(np.float32), (rng.randn(n) * 0.1).astype(np.float32),
            (np.abs(rng.randn(n)) * 0.03 + 0.01).astype(np.float32),
            (2.0 ** rng.randint(-1, 2, n)).astype(np.float32))


def _replay(plan, x, w, res, vecs, s1, n, qmin=-128, qmax=127):
    """The kernel's data flow in PyTorch, on the wrapper's padded operands:
    per row block, CTA of the cluster and consumer, TMA boxes of 64 x rows
    and BN w rows, 128 bytes of K each, zeros past M, N and K; per chunk of
    the CTA's columns, the exact int32 sum, the junction on the chunk with
    the vectors zero past N, its codes written into the code tile in place
    of the residual codes, and the chunk's integer partial row sums of
    x = code·mask; then each CTA's sums plus its peers', the LN of the stored
    codes with the sums rounded once to float32 and the true N counted.
    Returns both outputs and how often each element was stored."""
    m = x.shape[0]
    xp, wp, resp, vp = ml.res_ln_pad(x, w, res, vecs)
    nw, tk = plan.cs * plan.cols, matmul_int8.TILE_K
    nk = -(-plan.k_pad // tk)
    xz = torch.zeros((plan.blocks * plan.rows, nk * tk), dtype=torch.int64)
    wz = torch.zeros((nw, nk * tk), dtype=torch.int64)
    xz[:m, :plan.k_pad], wz[:plan.n_pad, :plan.k_pad] = xp, wp
    vs = torch.zeros((9, nw))
    vs[:, :plan.n_pad] = vp
    r, b, s_mid, s_res, inv_s_out, mask, w_os, b_os, ratio = vs
    outs = [torch.zeros((m, n), dtype=torch.int8) for _ in range(2)]
    stores = torch.zeros((m, n), dtype=torch.int64)
    for _, _, blk in plan.walk():
        for c in range(plan.nc):
            r0 = blk * plan.rows + 64 * c
            rows = max(0, min(64, m - r0))
            tile = torch.zeros((64, nw))
            tile[:rows, :plan.n_pad] = resp[r0:r0 + rows].to(torch.float32)
            partial = []  # each CTA's (Σx, Σx²) over its columns
            for rank in range(plan.cs):
                sx = torch.zeros(64, dtype=torch.int64)
                sxx = torch.zeros(64, dtype=torch.int64)
                for ch in range(plan.cpc):
                    c0 = rank * plan.cols + ch * plan.bn
                    cs = slice(c0, c0 + plan.bn)
                    acc = torch.zeros((64, plan.bn), dtype=torch.int64)
                    for s in range(nk):
                        ks = slice(s * tk, (s + 1) * tk)
                        acc += xz[r0:r0 + 64, ks] @ wz[cs, ks].T
                    mid = torch.clamp(torch.round(acc.to(torch.int32).to(torch.float32) * r[cs] + b[cs]), qmin, qmax)
                    val = mid * s_mid[cs] + tile[:, cs] * s_res[cs]
                    code = torch.clamp(torch.round(val * inv_s_out[cs]), qmin, qmax)
                    tile[:, cs] = code
                    xi = (code * mask[cs]).to(torch.int64)
                    sx += xi.sum(1)
                    sxx += (xi * xi).sum(1)
                partial.append((sx, sxx))
            sx, sxx = sum(p[0] for p in partial), sum(p[1] for p in partial)
            xt = tile * mask
            y = intln.ln_mn_chain(xt, sx.to(torch.float32)[:, None], sxx.to(torch.float32)[:, None], s1[0], n,
                                  w_os[None], b_os[None])
            ln = torch.clamp(torch.round(y * ratio[None]), qmin, qmax)
            outs[0][r0:r0 + rows] = tile[:rows, :n].to(torch.int8)
            outs[1][r0:r0 + rows] = ln[:rows, :n].to(torch.int8)
            stores[r0:r0 + rows] += 1
    return outs, stores


@pytest.mark.parametrize("n", [96, 100, 384, 1000])
@pytest.mark.parametrize("m", [1, 63, 65, 197])
def test_walk_replay_equals_plain(m, n):
    """On ragged M (one row, one short of and one past a 64-row tile, DeiT's
    197) and N (100 and 1000 padded to 112 and 1008, one and seven chunks;
    384 split over a cluster of four), K = 40 padded to 64, PTF masks up to
    16, on a 4-SM grid (N = 384 split over a cluster of two or four): the
    replayed walk equals the plain version, every element stored once."""
    a = [torch.from_numpy(v) for v in _args(m * n, m, 40, n)]
    plan = ml.res_ln_plan(m, n, 40, 4)
    assert (plan.cs > 1) == (n == 384)
    vecs, s1 = ml.res_ln_consts(n, torch.device("cpu"), *a[2:4], *a[5:])
    got, stores = _replay(plan, a[0], a[1], a[4], vecs, s1, n)
    assert (stores == 1).all()
    want = ml.int8_matmul_res_ln_plain(*a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("m,k,n", [(49, 384, 96), (49, 768, 192), (17, 3072, 768), (70, 40, 96)])
def test_plain_matches_jax_at_swin_widths(m, k, n):
    """The plain version (which the kernel equals bit for bit on the card)
    against JAX's Pallas kernel in interpret mode and its eager twin, at
    Swin-T's fc2 junction widths and at a ragged K = 40, masks up to 8."""
    a = _args(3 * m + n, m, k, n, mask_max=8)
    got = ml.int8_matmul_res_ln_plain(*(torch.from_numpy(v) for v in a))
    for want in (j_resln(*a, interpret=True), int8_matmul_res_ln_ref(*a)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("k,n", [(40, 96), (100, 1000), (384, 8)])
def test_res_ln_pad_equals_plain(k, n):
    """The junction wrapper's padding (K to 32, N to 16): the plain chain
    on the padded operands, with the true N counted, sliced to (M, N),
    equals the plain version on the unpadded inputs."""
    a = [torch.from_numpy(v) for v in _args(k + n, 37, k, n)]
    vecs, s1 = ml.res_ln_consts(n, torch.device("cpu"), *a[2:4], *a[5:])
    xp, wp, rp, vp = ml.res_ln_pad(a[0], a[1], a[4], vecs)
    assert xp.shape[1] % 32 == 0 and wp.shape == (-(-n // 16) * 16, xp.shape[1]) and vp.shape[1] == wp.shape[0]
    got = ml.res_ln_epilogue_plain(matmul_int8.int_matmul_nt(xp, wp), rp, vp, s1, n_true=n)
    want = ml.int8_matmul_res_ln_plain(*a)
    assert torch.equal(got[0][:, :n], want[0]) and torch.equal(got[1][:, :n], want[1])


@pytest.mark.parametrize("k", [40, 8, 100])
def test_requant_pad_equals_plain(k):
    """The requant wrapper's padding (K to 32) leaves the product exact."""
    rng = np.random.RandomState(k)
    x = torch.from_numpy(rng.randint(-128, 128, (33, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-128, 128, (70, k)).astype(np.int8))
    r = torch.from_numpy((2.0 ** rng.randint(-14, -8, 70)).astype(np.float32))
    b = torch.from_numpy(rng.randn(70).astype(np.float32))
    xp, wp = matmul_int8.requant_pad(x, w)
    assert xp.shape[1] % 32 == 0 and wp.shape[1] == xp.shape[1]
    for gelu in (False, True):
        assert torch.equal(matmul_int8.int8_matmul_requant_plain(xp, wp, r, b, 16.0, gelu=gelu),
                           matmul_int8.int8_matmul_requant_plain(x, w, r, b, 16.0, gelu=gelu))


@pytest.mark.parametrize("k,c", [(40, 100), (200, 36), (48, 384)])
def test_embed_pad_equals_plain(k, c):
    """The fused embed wrapper's padding (K to 16, C to 8, s_qact1 padded
    with ones): the plain chain on the padded operands with the true C
    counted, sliced to C, equals the plain version on the unpadded inputs."""
    rng = np.random.RandomState(k + c)
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    patches = torch.from_numpy(rng.randint(-128, 128, (2, 9, k)).astype(np.int8))
    w = torch.from_numpy(rng.randint(-8, 8, (c, k)).astype(np.int8))
    consts = dict(patch_requant=f(2.0 ** rng.randint(-10, -6, c)), patch_bias=f(rng.randn(c)),
                  embed_requant=f(0.5), s_embed=f(0.05), pos_val=f(rng.randn(9, c) * 0.2),
                  cls_xc=torch.from_numpy(rng.randint(-128, 128, (1, c)).astype(np.int8)),
                  s_qact1=f(0.02 * 2.0 ** rng.randint(0, 3, c)), ln_mask=f(2.0 ** rng.randint(0, 3, c)),
                  ln_s1=f(0.02), ln_w_os=f(rng.randn(c) * 8), ln_b_os=f(rng.randn(c) * 4))
    want = embed_fused.fused_patch_embed_plain(patches, w, **consts)
    vecs, scal = embed_fused.embed_consts(c, torch.device("cpu"), consts["patch_requant"], consts["patch_bias"],
                                          consts["s_qact1"], consts["ln_mask"], consts["ln_w_os"],
                                          consts["ln_b_os"], consts["embed_requant"], consts["s_embed"],
                                          consts["ln_s1"])
    pp, wp, vp, pos, cls = embed_fused.embed_pad(patches, w, vecs, consts["pos_val"], consts["cls_xc"].reshape(c))
    assert pp.shape[-1] % 16 == 0 and wp.shape[0] % 8 == 0 and (vp[2, c:] == 1).all()
    got = embed_fused.embed_codes_plain(pp, wp, vp, scal, pos, cls, c_true=c)
    assert torch.equal(got[0][..., :c], want[0]) and torch.equal(got[1][..., :c], want[1])


# ---------------------------------------------------------------------------
# The widths JAX serves past the zoo's: junction rows 1024 < N ≤ 2048, and
# the fused embed past C = 1024
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1536, 2048])
@pytest.mark.parametrize("m", [1, 1576, 3136, 12608])
def test_plan_at_wide_rows(m, n):
    """At these widths one CTA's plan (BN 256, the widest that wastes no
    column) fits no ring of two stages beside a whole row's code tile, so
    clusters split the row: the plan fits shared memory, its clusters are
    resident and cover N, and the walk covers every row block once."""
    for q in range(1, ml.MAX_CONSUMERS + 1):
        assert ml.res_ln_smem(256, n // 256, q, 2, 1) > matmul_int8.MAX_SMEM
    plan = ml.res_ln_plan(m, n, 4 * n, H100_SMS, H100_RESIDENT)
    assert plan.cs >= 2 and plan.cs * plan.cols >= n > (plan.cs - 1) * plan.cols
    assert 2 <= plan.stages and plan.smem_bytes == ml.res_ln_smem(plan.bn, plan.cpc, plan.nc, plan.stages,
                                                                  plan.cs) <= matmul_int8.MAX_SMEM
    assert plan.grid == min(H100_RESIDENT[plan.cs - 1], plan.blocks) * plan.cs
    seen = np.zeros(plan.blocks, np.int64)
    for _, _, blk in plan.walk():
        seen[blk] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("n", [1536, 2048])
def test_walk_replay_equals_plain_wide_rows(n):
    """The replayed walk of a wide-row plan (clusters splitting N, PTF
    masks up to 16, K = 40 padded to 64) equals the plain version, every
    element stored once."""
    a = [torch.from_numpy(v) for v in _args(n, 65, 40, n)]
    plan = ml.res_ln_plan(65, n, 40, H100_SMS, H100_RESIDENT)
    assert plan.cs >= 2
    vecs, s1 = ml.res_ln_consts(n, torch.device("cpu"), *a[2:4], *a[5:])
    got, stores = _replay(plan, a[0], a[1], a[4], vecs, s1, n)
    assert (stores == 1).all()
    want = ml.int8_matmul_res_ln_plain(*a)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [1536, 2048])
def test_plain_matches_jax_wide_rows(n):
    """The plain version against JAX's Pallas kernel in interpret mode and its
    eager twin at N = 1536 and 2048 (JAX serves N ≤ 2048), masks up to 8."""
    a = _args(7 * n, 9, 64, n, mask_max=8)
    got = ml.int8_matmul_res_ln_plain(*(torch.from_numpy(v) for v in a))
    for want in (j_resln(*a, interpret=True), int8_matmul_res_ln_ref(*a)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


@pytest.mark.parametrize("c,rows", [(384, 32), (1616, 32), (1624, 16), (2816, 16), (3272, 16), (3280, None)])
def test_embed_block_rows(c, rows):
    """The fused embed's row blocks up to C = 3272 (wider raises): at the
    zoo's 196 patches, batch 64, the Hopper plan (embed_plan) holds whole
    rows of codes in shared memory, over a cluster where one CTA's tile does
    not fit, and reads the weight panel once per 64·NC patch rows, at least
    the ``rows`` of the mma.sync kernel's block that it replaced (32 token
    rows, 16 past C = 1616)."""
    if rows is None:
        with pytest.raises(ValueError, match="C <= 3272"):
            embed_fused.embed_plan(64 * 196, c, 768, H100_SMS, H100_RESIDENT)
        return
    plan = embed_fused.embed_plan(64 * 196, c, 768, H100_SMS, H100_RESIDENT)
    assert plan.rows >= rows and plan.cs * plan.cols >= plan.c_pad > (plan.cs - 1) * plan.cols
    assert 2 <= plan.stages and plan.smem_bytes == embed_fused.embed_smem(
        plan.bn, plan.cpc, plan.nc, plan.stages, plan.cs) <= matmul_int8.MAX_SMEM


def _embed_jax_args(rng, b, n_patch, k, c):
    """fused_patch_embed arguments as numpy: int8 patch codes, int4-valued
    weights, power-of-two requant scales and s_embed, PTF scales and masks
    up to 2, the [CLS] row and LN constants."""
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return dict(
        patches=rng.randint(-128, 128, (b, n_patch, k)).astype(np.int8),
        w_q=rng.randint(-8, 8, (c, k)).astype(np.int8),
        patch_requant=f(2.0 ** rng.randint(-10, -6, c)), patch_bias=f(rng.randn(c)),
        embed_requant=f(0.5), s_embed=f(2.0**-4), pos_val=f(rng.randn(n_patch, c) * 0.2),
        cls_xc=rng.randint(-128, 128, (1, c)).astype(np.int8),
        s_qact1=f(0.05 * 2.0 ** rng.randint(0, 2, c)), ln_mask=f(2.0 ** rng.randint(0, 2, c)),
        ln_s1=f(0.05), ln_w_os=f(rng.randn(c) * 8), ln_b_os=f(rng.randn(c) * 4))


def test_embed_plain_matches_jax_at_c1536():
    """The fused embed's plain version against JAX's Pallas kernel in
    interpret mode at C = 1536 (int8 patches, K = 48)."""
    a = _embed_jax_args(np.random.RandomState(1536), 2, 9, 48, 1536)
    xc_j, h_j = j_embed(jnp.asarray(a["patches"]), jnp.asarray(a["w_q"]), 1.0, interpret=True,
                        **{k: jnp.asarray(v) for k, v in a.items() if k not in ("patches", "w_q")})
    xc_t, h_t = embed_fused.fused_patch_embed_plain(*(torch.from_numpy(a[k]) for k in (
        "patches", "w_q", "patch_requant", "patch_bias", "embed_requant", "s_embed", "pos_val", "cls_xc",
        "s_qact1", "ln_mask", "ln_s1", "ln_w_os", "ln_b_os")))
    np.testing.assert_array_equal(xc_t.numpy(), np.asarray(xc_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))


def test_embed_widest_c_jax_admits_at_197_tokens():
    """JAX's VMEM guard at the zoo's 196 patches + [CLS] and K = 768 admits
    C = 2816 and refuses the next padded width (C = 2817 → 2944); the
    port's kernel serves 2816 with its 16-row block."""
    def shapes(c):
        a = _embed_jax_args(np.random.RandomState(0), 1, 196, 768, 8)
        spec = {k: jax.ShapeDtypeStruct(np.shape(v) if k not in ("w_q", "pos_val", "cls_xc") else
                                        {"w_q": (c, 768), "pos_val": (196, c), "cls_xc": (1, c)}[k], v.dtype)
                for k, v in a.items()}
        vec = jax.ShapeDtypeStruct((c,), np.float32)
        for k in ("patch_requant", "patch_bias", "s_qact1", "ln_mask", "ln_w_os", "ln_b_os"):
            spec[k] = vec
        return jax.eval_shape(lambda **kw: j_embed(kw.pop("patches"), kw.pop("w_q"), 1.0, **kw), **spec)

    assert shapes(2816)[0].shape == (1, 197, 2816)
    with pytest.raises(ValueError, match="scoped-VMEM"):
        shapes(2817)
    plan = embed_fused.embed_plan(196, 2816, 768, H100_SMS, H100_RESIDENT)
    assert plan.cs * plan.cols >= 2816 and plan.smem_bytes <= matmul_int8.MAX_SMEM

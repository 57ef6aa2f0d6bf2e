"""The fourteen CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: they skip without a CUDA device (decided inside the
fixture, never at import). Run them on a GPU machine with
``python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q``
(``--noconftest``: the repository conftest imports JAX, which a GPU-only
machine need not have).
"""

import dataclasses

import numpy as np
import pytest
import torch

from p2vit_tpu_torch import serving, serving_swin
from p2vit_tpu_torch.config import make_policy
from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO, swin, vit
from p2vit_tpu_torch.ops import (
    attention_lis, embed_fused, intln, launch_counts, layer_fused, matmul_int8, matmul_ln,
    matmul_wstream, reset_launch_counts, swin_stem,
)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


def _i8(rng, shape, lo=-128, hi=128):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))


def _pot(rng, n, lo, hi):
    return torch.from_numpy((2.0 ** rng.randint(lo, hi, n)).astype(np.float32))


def _same(got, want):
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert int((g != w).sum()) == 0


@pytest.mark.parametrize("gelu", [False, True])
def test_int8_matmul_requant_kernel(dev, gelu):
    rng = np.random.RandomState(0)
    m, k, n = 1576, 384, 1536
    x, w = _i8(rng, (m, k)).to(dev), _i8(rng, (n, k), -8, 8).to(dev)
    r = _pot(rng, n, -14, -10).to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    kw = dict(out_inv=torch.tensor(32.0, device=dev), gelu=True) if gelu else {}
    _same(matmul_int8.int8_matmul_requant(x, w, r, b, **kw),
          matmul_int8.int8_matmul_requant_plain(x, w, r, b, **kw))
    # ragged edges: M, N not multiples of the 128 tile
    _same(matmul_int8.int8_matmul_requant(x[:77], w[:1000], r[:1000], b[:1000], **kw),
          matmul_int8.int8_matmul_requant_plain(x[:77], w[:1000], r[:1000], b[:1000], **kw))


def _requant_case(dev, seed, m, k, n, gelu):
    rng = np.random.RandomState(seed)
    x, w = _i8(rng, (m, k)).to(dev), _i8(rng, (n, k), -8, 8).to(dev)
    r = (_pot(rng, n, -14, -10) if gelu else _pot(rng, n, -12, -7)).to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    kw = dict(out_inv=torch.tensor(16.0, device=dev), gelu=True) if gelu else {}
    return (x, w, r, b), kw


@pytest.mark.parametrize("n,gelu,bn", [(96, False, 96), (288, False, 144), (384, False, 192), (1536, False, 256),
                                       (128, False, 128), (1000, False, 144), (384, True, 64), (1536, True, 64)])
def test_int8_matmul_requant_each_tile_width(dev, n, gelu, bn):
    """Every tile width the plan picks, at Swin-T stage 1's M (3136 tiles of
    64 rows: a persistent grid, every consumer of each CTA busy); the kernel's
    own plan (the C entry) equals requant_plan's, and its registers are those
    the setmaxnreg hand-over assumes, with nothing spilled."""
    m, k = (200_704, 96) if n <= 384 else (12_608, 384)
    a, kw = _requant_case(dev, n, m, k, n, gelu)
    info = matmul_int8.requant_kernel_info(m, n, k, gelu)
    plan = matmul_int8.requant_plan(m, n, k, info["sms"], gelu)
    assert info["bn"] == plan.bn == bn
    assert (info["nc"], info["stages"], info["grid"], info["smem_bytes"]) == (
        plan.nc, plan.stages, plan.grid, plan.smem_bytes)
    assert info["registers"] == (65536 // (128 * (plan.nc + 1))) // 8 * 8
    assert info["spill_bytes"] == 0 and info["ctas_per_sm"] == 1
    _same(matmul_int8.int8_matmul_requant(*a, **kw), matmul_int8.int8_matmul_requant_plain(*a, **kw))


@pytest.mark.parametrize("m", [1, 77, 12608])
@pytest.mark.parametrize("n", [96, 288, 1000])
@pytest.mark.parametrize("k", [48, 96, 1536])
def test_int8_matmul_requant_ragged(dev, m, n, k):
    """Ragged M (below one tile, not a multiple of 64), N (a masked 8-column
    edge at 1000, whose rows take 8-byte stores) and K (below one 128-byte
    slice: TMA fills zeros; 12 slices at 1536)."""
    a, kw = _requant_case(dev, m + n + k, m, k, n, n == 288)
    _same(matmul_int8.int8_matmul_requant(*a, **kw), matmul_int8.int8_matmul_requant_plain(*a, **kw))


@pytest.mark.parametrize("qmin,qmax", [(-8, 7), (0, 15), (-128, 127)])
@pytest.mark.parametrize("gelu", [False, True])
def test_int8_matmul_requant_clamp_arms(dev, qmin, qmax, gelu):
    """The narrow clamps of 4-bit codes and the full int8 range, with and
    without GELU, where many values clip at both ends."""
    a, kw = _requant_case(dev, qmax - qmin, 1576, 384, 1536, gelu)
    a = (a[0], a[1], a[2] * 8, a[3])
    _same(matmul_int8.int8_matmul_requant(*a, qmin=qmin, qmax=qmax, **kw),
          matmul_int8.int8_matmul_requant_plain(*a, qmin=qmin, qmax=qmax, **kw))


@pytest.mark.parametrize("k", [384, 768])
def test_int8_matmul_requant_head(dev, k):
    """The classifier heads (M = batch, N = 1000): seven 144-wide tiles, one
    per CTA; and the one-tile-per-CTA grid hook gives the same codes."""
    for m in (1, 8, 64):
        a, kw = _requant_case(dev, m + k, m, k, 1000, False)
        got = matmul_int8.int8_matmul_requant(*a, **kw)
        _same(got, matmul_int8.int8_matmul_requant_plain(*a, **kw))
        tiles = matmul_int8.requant_plan(m, 1000, k, 1).tiles
        _same(matmul_int8.int8_matmul_requant_grid(*a, grid=tiles), got)


@pytest.mark.parametrize("qmin,qmax", [(-128, 127), (-8, 7), (0, 15), (0, 255), (-2 ** 22, 2 ** 22)])
def test_int8_matmul_requant_rounding_rewrite_is_exact(dev, qmin, qmax):
    """The kernel rounds by clip, then + 1.5·2^23 (p2v::wg::rint_clip), where
    the plain version rounds half to even, then clips: equal over all 2^32
    float32 bit patterns (NaN, ±inf, subnormals, ties) at each clamp."""
    assert matmul_int8.requant_rint_check(qmin, qmax, dev) == 0


def test_int8_matmul_requant_grid_hook_and_launch_count(dev):
    """Any grid gives the same codes (1 CTA: every tile through one ring);
    only the wrapper counts launches."""
    a, kw = _requant_case(dev, 5, 12608, 384, 1536, True)
    want = matmul_int8.int8_matmul_requant_plain(*a, **kw)
    before = matmul_int8.int8_matmul_requant.launches
    _same(matmul_int8.int8_matmul_requant(*a, **kw), want)
    for grid in (1, 3, matmul_int8.requant_plan(12608, 1536, 384, 1, True).tiles):
        _same(matmul_int8.int8_matmul_requant_grid(*a, grid=grid, **kw), want)
    assert matmul_int8.int8_matmul_requant.launches == before + 1


def _res_ln_args(rng, m, k, n, case="ptf"):
    """Junction arguments: int8 x, int4-valued weights, PoT requant scales,
    residual codes and PTF scales. ``mask16``: every column but one at
    s_out = 16·s1 (PTF mask 16) with the residual scaled so that most codes
    saturate: |x| = 2048, and at N = 1024 every row's Σx² passes 2^31.
    ``zero_rows``: under a zero bias, the first row, the row at 64 and the
    last have zero x and residual codes, so zero residual codes and LN
    constants 0/0 (the NaN cast to code 0, as the plain version and JAX do)."""
    s_out = (0.013 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)
    s_res = (0.011 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)
    if case == "mask16":
        s_out = np.full(n, 0.013 * 16, np.float32)
        s_out[0] = 0.013
        s_res = (4 * s_out).astype(np.float32)
    args = [
        _i8(rng, (m, k)), _i8(rng, (n, k), -8, 8), _pot(rng, n, -10, -6),
        torch.from_numpy(rng.randn(n).astype(np.float32)), _i8(rng, (m, n)),
        torch.from_numpy((np.abs(rng.randn(n)) * 0.02 + 0.01).astype(np.float32)),
        torch.from_numpy(s_res), torch.from_numpy(s_out),
        torch.from_numpy(rng.randn(n).astype(np.float32)),
        torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32)),
        torch.from_numpy((np.abs(rng.randn(n)) * 0.03 + 0.01).astype(np.float32)),
        _pot(rng, n, -1, 2),
    ]
    if case == "zero_rows":
        rows = sorted({0, min(64, m - 1), m - 1})
        args[0][rows], args[4][rows], args[3] = 0, 0, torch.zeros(n)
    return args


@pytest.mark.parametrize("case", ["ptf", "mask16", "int4_clamp", "zero_rows"])
@pytest.mark.parametrize("kmul", [1, 4])
@pytest.mark.parametrize("n", [96, 128, 192, 256, 384, 512, 768, 1024])
def test_int8_matmul_res_ln_kernel(dev, n, kmul, case):
    """Every chunk width the plan picks (N = 96 … 1024, one to four chunks),
    K = N (proj) and 4N (fc2), ragged M (one row, one row past a 64-row
    tile, a partial 128-row block, Swin-T stage 3's 3136 + 1); a PTF mask
    of 16 with saturated codes (Σx² past 2^31 at N = 1024); the int4 clamp;
    rows of zero codes (LN 0/0)."""
    rng = np.random.RandomState(n + kmul)
    qmin, qmax = (-8, 7) if case == "int4_clamp" else (-128, 127)
    for m in (1, 65, 394, 3137):
        args = [a.to(dev) for a in _res_ln_args(rng, m, kmul * n, n, case)]
        got = matmul_ln.int8_matmul_res_ln(*args, qmin=qmin, qmax=qmax)
        _same(got, matmul_ln.int8_matmul_res_ln_plain(*args, qmin=qmin, qmax=qmax))
        if case == "zero_rows":
            assert not got[1][0].any()
        if case == "mask16" and n == 1024 and m > 1:
            x = got[0].to(torch.int64) * torch.round(args[7] / args[7].min()).to(torch.int64)
            assert int((x * x).sum(1).min()) > 2**31


@pytest.mark.parametrize("flags", [{}, {"fuse_qkv": False, "fuse_embed": False}, {"fuse_layer": True},
                                   {"lis": False}, {"fuse_layer": True, "lis": False}])
def test_serving_forward_synthetic_state(dev, flags):
    """DeiT-T at full width on ``synthetic_qstate``: its placeholder weight
    scale (0.0625) leaves most weight codes 0, so the [CLS] row's residual
    codes are all zero and every junction's LN (the fused layer's too)
    meets 0/0 there; each int8 arm equals its plain path bit for bit and
    launches ``launches_per_forward``'s kernels."""
    cfg = VIT_ZOO["deit_tiny_patch16_224"]
    params = vit.init_params(0, cfg, device=dev)
    s = serving.convert(params, vit.synthetic_qstate(cfg, device=dev), cfg, make_policy(), [8] * cfg.num_matmuls)
    x = torch.randn((2, 3, 224, 224), generator=torch.Generator().manual_seed(1)).to(dev)
    reset_launch_counts()
    got = serving.serving_forward(s, cfg, x, **flags)
    counts = {k: v for k, v in launch_counts().items() if v}
    assert counts == serving.launches_per_forward(cfg, **{k: v for k, v in flags.items() if k != "lis"})
    assert torch.equal(got, serving.serving_forward(s, cfg, x, use_kernels=False, **flags))


# (M, N, K) of every junction of the zoo's serving paths at batch 64:
# DeiT-T/S/B and ViT-B/L (proj K = C, fc2 K = 4C, M = 64·197) and
# Swin-T/S/B's fc2 junctions per stage
RES_LN_SHAPES = [(12608, 192, 192), (12608, 192, 768), (12608, 384, 384), (12608, 384, 1536),
                 (12608, 768, 768), (12608, 768, 3072), (12608, 1024, 1024), (12608, 1024, 4096),
                 (200704, 96, 384), (50176, 192, 768), (12544, 384, 1536), (3136, 768, 3072),
                 (200704, 128, 512), (50176, 256, 1024), (12544, 512, 2048), (3136, 1024, 4096)]


@pytest.mark.parametrize("m,n,k", RES_LN_SHAPES)
def test_int8_matmul_res_ln_plan_matches_kernel(dev, m, n, k):
    """The C entry's plan equals res_ln_plan at every zoo junction shape; its
    registers are those the setmaxnreg hand-over assumes, nothing spills, one
    CTA per SM, and the card holds all of the persistent grid's clusters at
    once; the kernel equals the plain version there (M cut to a few row
    blocks past the first wave)."""
    info = matmul_ln.res_ln_kernel_info(m, n)
    plan = matmul_ln.res_ln_plan(m, n, k, info["sms"], info["resident"])
    assert (info["bn"], info["cpc"], info["cs"], info["nc"], info["stages"], info["blocks"], info["grid"],
            info["smem_bytes"]) == (plan.bn, plan.cpc, plan.cs, plan.nc, plan.stages, plan.blocks, plan.grid,
                                    plan.smem_bytes)
    assert info["registers"] == 168 and info["spill_bytes"] == 0 and info["ctas_per_sm"] == 1
    assert plan.grid <= info["resident"][plan.cs - 1] * plan.cs
    mm = min(m, plan.rows * (info["sms"] + 3) - 5)
    args = [a.to(dev) for a in _res_ln_args(np.random.RandomState(m + n), mm, k, n)]
    _same(matmul_ln.int8_matmul_res_ln(*args), matmul_ln.int8_matmul_res_ln_plain(*args))


@pytest.mark.parametrize("cs,nc", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (4, 1), (4, 2)])
def test_int8_matmul_res_ln_forced_plans(dev, cs, nc):
    """Every cluster size and consumer count the measurement hook can force,
    at DeiT-S's width over a few waves of row blocks (the clusters' row sums
    through distributed shared memory, blocks taken in turn), equals the
    plain version; the hook counts no launch."""
    rng = np.random.RandomState(10 * cs + nc)
    args = [a.to(dev) for a in _res_ln_args(rng, 64 * 2 * 200 + 17, 384, 384, "mask16")]
    before = matmul_ln.int8_matmul_res_ln.launches
    _same(matmul_ln.int8_matmul_res_ln_forced(*args, cs=cs, nc=nc), matmul_ln.int8_matmul_res_ln_plain(*args))
    assert matmul_ln.int8_matmul_res_ln.launches == before


@pytest.mark.parametrize("n", [8, 100, 200, 1000])
@pytest.mark.parametrize("k", [40, 100, 384])
def test_int8_matmul_res_ln_padded(dev, n, k):
    """N not a multiple of 16 and K not of 32: the wrapper zero-pads both,
    the LN counts the true N, and the outputs are (M, N); each call counts
    one launch."""
    rng = np.random.RandomState(n * k)
    args = [a.to(dev) for a in _res_ln_args(rng, 131, k, n)]
    before = matmul_ln.int8_matmul_res_ln.launches
    got = matmul_ln.int8_matmul_res_ln(*args)
    assert matmul_ln.int8_matmul_res_ln.launches == before + 1
    assert got[0].shape == got[1].shape == (131, n) and got[0].is_contiguous()
    _same(got, matmul_ln.int8_matmul_res_ln_plain(*args))


@pytest.mark.parametrize("n", [1536, 2048])
def test_int8_matmul_res_ln_wide_rows(dev, n):
    """N = 1536 and 2048, which JAX serves and no one-CTA plan fits: the
    plan splits each row over a cluster (ragged M: one row, a partial
    block, several waves), the C entry's plan equals res_ln_plan, and the
    kernel equals the plain version with PTF masks of 16."""
    for m in (1, 197, 3136 + 5):
        info = matmul_ln.res_ln_kernel_info(m, n)
        plan = matmul_ln.res_ln_plan(m, n, n, info["sms"], info["resident"])
        assert plan.cs >= 2 and (info["cs"], info["bn"], info["cpc"], info["nc"], info["stages"]) == (
            plan.cs, plan.bn, plan.cpc, plan.nc, plan.stages)
        args = [a.to(dev) for a in _res_ln_args(np.random.RandomState(m + n), m, n, n, "mask16")]
        _same(matmul_ln.int8_matmul_res_ln(*args), matmul_ln.int8_matmul_res_ln_plain(*args))


@pytest.mark.parametrize("m,k,n", [(77, 40, 96), (200, 8, 288), (12608, 100, 384), (5, 200, 1000)])
@pytest.mark.parametrize("gelu", [False, True])
def test_int8_matmul_requant_padded(dev, m, k, n, gelu):
    """K not a multiple of 16: planned and launched at the zero-padded K."""
    a, kw = _requant_case(dev, m + k, m, k, n, gelu)
    _same(matmul_int8.int8_matmul_requant(*a, **kw), matmul_int8.int8_matmul_requant_plain(*a, **kw))


def _embed_args(rng, b, n_patch, k, c):
    """fused_patch_embed arguments: int8 patch codes, int4-valued weights,
    PoT scales, positional values, a [CLS] row and the LN constants."""
    f = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return [_i8(rng, (b, n_patch, k)), _i8(rng, (c, k), -8, 8), _pot(rng, c, -10, -6), f(rng.randn(c)),
            f(2.0 ** rng.randint(-2, 1)), f(0.05), f(rng.randn(n_patch, c) * 0.2), _i8(rng, (1, c)),
            f(0.02 * 2.0 ** rng.randint(0, 3, c)), f(2.0 ** rng.randint(0, 3, c)), f(0.02),
            f(rng.randn(c) * 8), f(rng.randn(c) * 4)]


@pytest.mark.parametrize("k,c", [(768, 384), (40, 100), (200, 36), (768, 1000)])
def test_fused_patch_embed_padded(dev, k, c):
    """K not a multiple of 16 and C not of 8 (and DeiT-S's own widths): the
    wrapper zero-pads both and the LN counts the true C."""
    args = [a.to(dev) for a in _embed_args(np.random.RandomState(k + c), 3, 49, k, c)]
    got = embed_fused.fused_patch_embed(*args)
    assert got[0].shape == (3, 50, c)
    _same(got, embed_fused.fused_patch_embed_plain(*args))


@pytest.mark.parametrize("c", [1536, 2816, 3272])
def test_fused_patch_embed_wide(dev, c):
    """Past C = 1024 at the zoo's 196 patches and K = 768: C = 1536, 2816
    (the widest C JAX's VMEM guard admits there) and 3272 (the port's
    widest, padded to 3280) split over clusters, equal to the plain version."""
    info = embed_fused.embed_kernel_info(2 * 196, c)
    assert info["cs"] > 1 and info["cs"] * info["cpc"] * info["bn"] >= -(-c // 16) * 16
    args = [a.to(dev) for a in _embed_args(np.random.RandomState(c), 2, 196, 768, c)]
    got = embed_fused.fused_patch_embed(*args)
    assert got[0].shape == (2, 197, c)
    _same(got, embed_fused.fused_patch_embed_plain(*args))


@pytest.mark.parametrize("b", [1, 2, 3, 64])
@pytest.mark.parametrize("c", [192, 384, 768, 1024])
def test_fused_patch_embed_embed_widths(dev, c, b):
    """DeiT-T/S/B and ViT-L widths at the zoo's 196 patches, K = 768: at
    batch 1 (clusters splitting C over 4 row blocks), 2 and 3 (row blocks of
    64·NC patch rows that cross images) and 64; the kernel's plan equals
    embed_plan's with the card's resident clusters, its registers are those
    the setmaxnreg hand-over assumes; nothing spills but at BN 192, whose
    96 accumulators and 96 prefetched positional values leave a 16-byte
    frame (28 bytes of spill stores, ptxas)."""
    info = embed_fused.embed_kernel_info(b * 196, c)
    plan = embed_fused.embed_plan(b * 196, c, 768, info["sms"], info["resident"])
    assert (info["bn"], info["cpc"], info["cs"], info["nc"], info["stages"], info["blocks"], info["grid"],
            info["smem_bytes"]) == (plan.bn, plan.cpc, plan.cs, plan.nc, plan.stages, plan.blocks, plan.grid,
                                    plan.smem_bytes)
    assert info["registers"] == 168 and info["ctas_per_sm"] == 1
    assert info["spill_bytes"] == (16 if info["bn"] == 192 else 0)
    args = [a.to(dev) for a in _embed_args(np.random.RandomState(b * c), b, 196, 768, c)]
    before = embed_fused.fused_patch_embed.launches
    _same(embed_fused.fused_patch_embed(*args), embed_fused.fused_patch_embed_plain(*args))
    assert embed_fused.fused_patch_embed.launches == before + 1


@pytest.mark.parametrize("cs,nc", [(1, 1), (1, 2), (2, 1), (2, 2), (3, 1), (3, 2), (4, 1), (4, 2)])
def test_fused_patch_embed_forced_plans(dev, cs, nc):
    """Every cluster size and consumer count the hook can force, at DeiT-S's
    width over several waves of row blocks, and on the float32 arm, equals
    the plain version; the hook counts no launch."""
    rng = np.random.RandomState(10 * cs + nc)
    args = [a.to(dev) for a in _embed_args(rng, 70, 196, 768, 384)]
    before = embed_fused.fused_patch_embed.launches
    _same(embed_fused.fused_patch_embed_forced(*args, cs=cs, nc=nc), embed_fused.fused_patch_embed_plain(*args))
    args[0] = torch.from_numpy((rng.randn(3, 196, 768) * 0.6).astype(np.float32)).to(dev)
    kw = dict(s_input=torch.tensor(0.0131, device=dev))
    _same(embed_fused.fused_patch_embed_forced(*args, cs=cs, nc=nc, **kw),
          embed_fused.fused_patch_embed_plain(*args, **kw))
    assert embed_fused.fused_patch_embed.launches == before


def test_fused_patch_embed_phase_hook(dev):
    """The phase clock of one CTA's consumer at DeiT-S batch 64: its stamps
    run in order through each chunk's products and epilogue, the row
    constants, the LN pass and the end (two may share a tick of the
    timer); the hook counts no launch and changes no output."""
    args = [a.to(dev) for a in _embed_args(np.random.RandomState(14), 64, 196, 768, 384)]
    info = embed_fused.embed_kernel_info(64 * 196, 384)
    stamps = torch.zeros(len(embed_fused.EMBED_PHASES), dtype=torch.int64, device=dev)
    before = embed_fused.fused_patch_embed.launches
    _same(embed_fused.fused_patch_embed_forced(*args, phase_ns=stamps), embed_fused.fused_patch_embed_plain(*args))
    assert embed_fused.fused_patch_embed.launches == before
    st = stamps.tolist()
    seq = [st[0]] + [st[1 + i] for i in range(2 * min(info["cpc"], 6))] + st[13:16]
    assert all(a <= b for a, b in zip(seq, seq[1:])) and seq[0] < seq[-1], seq


@pytest.mark.parametrize("k,c", [(768, 384), (48, 100), (40, 1024)])
def test_fused_patch_embed_f32_arm(dev, k, c):
    """float32 patches quantized in the kernel (clip(round(x / s_input)),
    the true divide), a third of them on round-half edges, K and C padded:
    equal to the plain version; without s_input the wrapper raises."""
    rng = np.random.RandomState(k + c)
    args = [a.to(dev) for a in _embed_args(rng, 3, 49, k, c)]
    s_in = 0.0131
    x = rng.randn(3, 49, k).astype(np.float32) * 0.7
    half = ((rng.randint(-140, 140, x.shape) + 0.5) * np.float32(s_in)).astype(np.float32)
    args[0] = torch.from_numpy(np.where(rng.rand(*x.shape) < 1 / 3, half, x).astype(np.float32)).to(dev)
    kw = dict(s_input=torch.tensor(s_in, device=dev))
    _same(embed_fused.fused_patch_embed(*args, **kw), embed_fused.fused_patch_embed_plain(*args, **kw))
    with pytest.raises(ValueError, match="s_input"):
        embed_fused.fused_patch_embed(*args)


def test_fused_patch_embed_zero_row_ln(dev):
    """A patch row whose codes are all zero (zero patches, zero bias, zero
    positional row) has LN constants 0/0: its h row is what the plain
    version's NaN cast gives, and the other rows are unchanged."""
    rng = np.random.RandomState(12)
    args = [a.to(dev) for a in _embed_args(rng, 3, 196, 768, 384)]
    args[0][1, 5] = 0
    args[3] = torch.zeros(384, device=dev)
    args[6][5] = 0
    xc, h = embed_fused.fused_patch_embed(*args)
    assert int((xc[1, 6] != 0).sum()) == 0
    _same((xc, h), embed_fused.fused_patch_embed_plain(*args))


def test_fused_patch_embed_divide_exhaustive(dev):
    """The kernel's PTF divide (RN(1/d) staged, one Markstein correction)
    against __fdiv_rn over all 2^32 float32 dividends, for 256 divisors
    across [2^-64, 2^64] and at the edges of their significands: no code
    differs, nor any quotient in [1/4, 1024)."""
    rng = np.random.RandomState(13)
    edge = [m * 2.0 ** e for e in (-64, -20, -7, -1, 0, 1, 20, 63) for m in (1.0, 1 + 2.0**-23, 2 - 2.0**-23)]
    d = np.concatenate([np.float32(edge), np.exp2(rng.uniform(-64, 64, 232)).astype(np.float32)])
    assert embed_fused.embed_div_check(torch.from_numpy(d.astype(np.float32)).to(dev)) == (0, 0)


# (B, N, C_in, C_out, heads): the cluster's edges (N = 5: one CTA and one
# query group; 64: exactly one tile; 65: one row over; 197: DeiT's 4/3/3/3
# groups; 256: the maximum), DeiT-S's tensor-parallel shards at tp = 2 and 3
# (C_out ≠ C_in) and the DeiT-B width
QKV_SHAPES = [(3, 5, 384, 384, 6), (3, 64, 384, 384, 6), (3, 65, 384, 384, 6), (3, 197, 384, 384, 6),
              (3, 256, 384, 384, 6), (2, 197, 384, 192, 3), (2, 197, 384, 128, 2), (2, 197, 768, 768, 12)]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("s_attn", [2.0**-11, 2.0**-5])
@pytest.mark.parametrize("shape", QKV_SHAPES, ids=lambda s: "b{}n{}cin{}cout{}h{}".format(*s))
def test_lis_attention_qkv_fused_kernel(dev, shape, s_attn, lis):
    b, n, c_in, c, heads = shape
    rng = np.random.RandomState(2 + n + c_in + c)
    h, w = _i8(rng, (b, n, c_in)).to(dev), _i8(rng, (3 * c, c_in)).to(dev)
    rv = _pot(rng, 3 * c, -14 if c_in > 384 else -13, -10).to(dev)
    bv = torch.from_numpy(rng.randn(3 * c).astype(np.float32)).to(dev)
    a = (h, w, rv, bv, heads, 2.0**-12, s_attn, 0.5)
    _same(attention_lis.lis_attention_qkv_fused(*a, lis=lis),
          attention_lis.lis_attention_qkv_fused_plain(*a, lis=lis))


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("n", [5, 64, 65, 197, 256])
def test_lis_attention_qkv_fused_plan_matches_kernel(dev, n, lis):
    """The CUDA runtime's view of the cluster kernel agrees with the Python
    launch plan (cluster size, shared memory), and the card can hold it."""
    plan = attention_lis.qkv_cluster_plan(n, 384)
    info = attention_lis.qkv_kernel_info(n, lis)
    assert info["cluster"] == plan.cluster and info["smem_bytes"] == plan.smem_bytes
    assert info["max_active_clusters"] >= 1 and info["ctas_per_sm"] >= 1
    with pytest.raises(ValueError, match="N <= 1024"):
        attention_lis.qkv_cluster_plan(1025, 384)


@pytest.mark.parametrize("lis", [True, False])
def test_lis_attention_qkv_fused_phase_hook(dev, lis):
    """The measurement hook: the same codes, one counted launch, and the
    stamped CTA's six stamps in order."""
    rng = np.random.RandomState(7)
    h, w = _i8(rng, (2, 197, 384)).to(dev), _i8(rng, (1152, 384)).to(dev)
    a = (h, w, _pot(rng, 1152, -13, -10).to(dev), torch.zeros(1152, device=dev), 6, 2.0**-12, 2.0**-5, 0.5)
    stamps = torch.zeros(6, dtype=torch.int64, device=dev)
    before = attention_lis.lis_attention_qkv_fused.launches
    _same(attention_lis.lis_attention_qkv_fused(*a, lis=lis, phase_ns=stamps),
          attention_lis.lis_attention_qkv_fused_plain(*a, lis=lis))
    assert attention_lis.lis_attention_qkv_fused.launches == before + 1
    st = stamps.cpu()
    assert int(st[0]) > 0 and bool((st[1:] >= st[:-1]).all())


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("n", [197, 256, 5])
def test_lis_attention_fused_kernel(dev, n, lis):
    """(B, N, 3C) qkv codes at DeiT-S width; N = 256 needs more than 48 KB of
    shared memory, N = 5 leaves most lanes without a key."""
    rng = np.random.RandomState(n)
    qkv = _i8(rng, (3, n, 3 * 384)).to(dev)
    a = (qkv, 6, 2.0**-11, 2.0**-11 if lis else 2.0**-4, 2.0)
    _same(attention_lis.lis_attention_fused(*a, lis=lis), attention_lis.lis_attention_fused_plain(*a, lis=lis))


@pytest.mark.parametrize("lis", [True, False])
def test_lis_attention_kernel(dev, lis):
    """Split (B·H, N, 64) q/k/v; head_dim 32 is served too, 129 raises."""
    rng = np.random.RandomState(5)
    q, k, v = (_i8(rng, (18, 197, 64)).to(dev) for _ in range(3))
    a = (q, k, v, 2.0**-11, 2.0**-4, 2.0)
    _same(attention_lis.lis_attention(*a, lis=lis), attention_lis.lis_attention_plain(*a, lis=lis))
    half = [t[..., :32].contiguous() for t in (q, k, v)]
    _same(attention_lis.lis_attention(*half, *a[3:], lis=lis),
          attention_lis.lis_attention_plain(*half, *a[3:], lis=lis))
    wide = [_i8(rng, (2, 17, 129)).to(dev) for _ in range(3)]
    with pytest.raises(ValueError, match="head_dim"):
        attention_lis.lis_attention(*wide, *a[3:], lis=lis)


# (B, N, C, heads) at head_dims 16, 32 and 64 and the item's edges: N = 5
# (one query group, one key block), 65 (a group and a key block over), 197,
# 256 (the maximum)
FUSED_ATTN_SHAPES = [(3, n, c, h) for n in (5, 65, 197, 256) for c, h in ((96, 6), (192, 6), (384, 6))]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shape", FUSED_ATTN_SHAPES, ids=lambda s: "b{}n{}c{}h{}".format(*s))
def test_lis_attention_fused_head_dims(dev, shape, lis):
    """Every head_dim the kernel serves (16, 32, 64), bitwise against the
    plain version, on the plan's query-group chunks and on forced ones."""
    b, n, c, heads = shape
    rng = np.random.RandomState(n + c)
    qkv = _i8(rng, (b, n, 3 * c)).to(dev)
    a = (qkv, heads, 2.0**-11, 2.0**-11 if lis else 2.0**-4, 2.0)
    want = attention_lis.lis_attention_fused_plain(*a, lis=lis)
    _same(attention_lis.lis_attention_fused(*a, lis=lis), want)
    groups = -(-n // 16)
    for gc in sorted({1, 2, max(1, groups // 2), groups}):
        _same(attention_lis.lis_attention_fused_forced(*a, lis=lis, gc=gc), want)


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("d", [1, 2, 4, 5, 8, 16, 17, 31, 32, 33, 48, 63, 64])
def test_lis_attention_any_head_dim(dev, d, lis):
    """``lis_attention`` at head_dims up to 64: rows that are no multiple of
    16 bytes take the byte loads, odd widths the byte stores; output columns
    past d are never written."""
    rng = np.random.RandomState(d)
    q, k, v = (_i8(rng, (7, 65, d)).to(dev) for _ in range(3))
    a = (q, k, v, 2.0**-11, 2.0**-11 if lis else 2.0**-4, 2.0)
    _same(attention_lis.lis_attention(*a, lis=lis), attention_lis.lis_attention_plain(*a, lis=lis))
    _same(attention_lis.lis_attention_forced(*a, lis=lis, gc=1), attention_lis.lis_attention_plain(*a, lis=lis))


# (B, N, C, heads) at head_dims 8, 4, 2 and 1: q/k/v rows of fewer than 16
# bytes (byte loads), items of odd offsets (byte stores), at C = 64 and at
# DeiT-S width
SMALL_HEAD_DIM_SHAPES = [(3, n, c, c // d) for d in (8, 4, 2, 1) for n, c in ((65, 64), (197, 384))]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shape", SMALL_HEAD_DIM_SHAPES, ids=lambda s: "b{}n{}c{}h{}".format(*s))
def test_lis_attention_fused_small_head_dims(dev, shape, lis):
    """head_dims 8, 4, 2 and 1 (the divisors of 128 below 16, which JAX
    admits), bitwise against the plain version on the plan's chunks and on
    one group a chunk; no column of a neighbouring head is read or
    written."""
    b, n, c, heads = shape
    rng = np.random.RandomState(n + heads)
    qkv = _i8(rng, (b, n, 3 * c)).to(dev)
    a = (qkv, heads, 2.0**-11, 2.0**-11 if lis else 2.0**-4, 2.0)
    want = attention_lis.lis_attention_fused_plain(*a, lis=lis)
    _same(attention_lis.lis_attention_fused(*a, lis=lis), want)
    _same(attention_lis.lis_attention_fused_forced(*a, lis=lis, gc=1), want)


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("n,hd", [(5, 16), (197, 64), (256, 64), (197, 32), (256, 16), (197, 8), (65, 1)])
def test_vit_attention_plan_matches_kernel(dev, n, hd, lis):
    """The CUDA runtime's view of the per-item kernel agrees with
    ``vit_attention_plan`` (padded head_dim, groups a chunk, shared memory),
    holds the CTAs an SM the plan sized it for and spills nothing."""
    plan = attention_lis.vit_attention_plan(n, hd, lis)
    info = attention_lis.vit_attention_info(n, hd, lis)
    assert (info["hdp"], info["gc"], info["smem_bytes"]) == (plan.hdp, plan.gc, plan.smem_bytes)
    per_sm = next(k for k in (4, 3, 2, 1) if plan.smem_bytes <= attention_lis.SM_SMEM // k - 1024)
    assert info["ctas_per_sm"] >= min(per_sm, 3) and info["spill_bytes"] == 0  # registers may hold a 4th back


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(64, 384, dtype=torch.int8, device=dev)
    w = torch.zeros(128, 384, dtype=torch.int8, device=dev)
    v = torch.ones(128, device=dev)
    with pytest.raises(TypeError):
        matmul_int8.int8_matmul_requant(x.int(), w, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_int8.int8_matmul_requant(x[:, ::2], w[:, :192], v, v)
    with pytest.raises(ValueError, match="K % 16"):
        matmul_int8.int8_matmul_requant(x[:, :0].contiguous(), w[:, :0].contiguous(), v, v)
    with pytest.raises(ValueError, match="2\\^22"):
        matmul_int8.int8_matmul_requant(x, w, v, v, qmin=-2 ** 23)
    rng = np.random.RandomState(6)
    h = _i8(rng, (1, 197, 384)).to(dev)
    wq = _i8(rng, (1152, 384), -8, 8).to(dev)
    a = (h, wq, torch.full((1152,), 2.0**-10, device=dev), torch.zeros(1152, device=dev), 6,
         2.0**-11, 2.0**-4, 1.0)
    # LIS off launches the kernel's fp softmax arm, equal to the plain version
    before = attention_lis.lis_attention_qkv_fused.launches
    _same(attention_lis.lis_attention_qkv_fused(*a, lis=False),
          attention_lis.lis_attention_qkv_fused_plain(*a, lis=False))
    assert attention_lis.lis_attention_qkv_fused.launches == before + 1
    with pytest.raises(ValueError, match="lis_bits"):
        attention_lis.lis_attention_qkv_fused(*a, lis_bits=8)


def test_serving_forward_small_model(dev):
    """A small ViT with head_dim 64: the whole serving path through the
    kernels equals the plain path bit for bit, with the expected launches."""
    cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], img_size=64, depth=2,
                              embed_dim=128, num_heads=2, num_classes=10)
    policy = make_policy()
    params = vit.init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((6, 3, 64, 64), generator=gen).to(dev)
    calib = vit.calibrate(params, cfg, policy, x)
    s = serving.convert(params, calib.qstate, cfg, policy, [4] * cfg.num_matmuls)
    reset_launch_counts()
    got = serving.serving_forward(s, cfg, x)
    assert launch_counts() == {"fused_patch_embed": 1, "lis_attention_qkv_fused": 2,
                               "int8_matmul_res_ln": 4, "int8_matmul_requant": 3,
                               "int_ln_requant": 0, "int_res_ln_requant": 0,
                               "swin_lis_attention": 0, "lis_attention_fused": 0,
                               "lis_attention": 0, "fused_swin_stem": 0,
                               "swin_lis_attention_folded": 0, "fused_vit_layer": 0,
                               "int4_matmul_requant": 0, "wstream_matmul": 0}
    want = serving.serving_forward(s, cfg, x, use_kernels=False)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    # embed kernel alone, on the serving path's arguments
    k = serving._embed_fused_consts(s, cfg)
    from p2vit_tpu_torch.models.common import extract_patches

    patches = extract_patches(serving._input_codes(s, x), cfg.patch_size).contiguous()
    _same(embed_fused.fused_patch_embed(patches, s["patch"]["w_q"], **k),
          embed_fused.fused_patch_embed_plain(patches, s["patch"]["w_q"], **k))


@pytest.mark.parametrize("lis", [True, False])
def test_serving_forward_staged_u8_small_model(dev, lis):
    """The staged flags (fuse_embed=False, fuse_qkv=False) on uint8 images,
    LIS on and off: the kernels equal the plain path, the staged path equals
    the fused one, uint8 equals host-normalized float32, and the launches
    are ``launches_per_forward``'s."""
    cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], img_size=64, depth=2,
                              embed_dim=128, num_heads=2, num_classes=10)
    policy = make_policy(lis=lis)
    params = vit.init_params(0, cfg, device=dev)
    u8 = torch.from_numpy(np.random.RandomState(7).randint(0, 256, (5, 3, 64, 64), dtype=np.uint8))
    mean = torch.tensor([0.485, 0.456, 0.406]).reshape(3, 1, 1)
    std = torch.tensor([0.229, 0.224, 0.225]).reshape(3, 1, 1)
    xf = ((u8.to(torch.float32) / torch.tensor(255.0) - mean) / std).to(dev)
    calib = vit.calibrate(params, cfg, policy, xf)
    s = serving.attach_u8_ingest(serving.convert(params, calib.qstate, cfg, policy,
                                                 [4] * cfg.num_matmuls))
    assert serving.u8_ingest_exact(s)
    u8 = u8.to(dev)
    staged = dict(fuse_embed=False, fuse_qkv=False, lis=lis)
    reset_launch_counts()
    got = serving.serving_forward(s, cfg, u8, **staged)
    want_counts = {k: 0 for k in launch_counts()}
    want_counts.update(serving.launches_per_forward(cfg, fuse_embed=False, fuse_qkv=False))
    assert launch_counts() == want_counts
    assert torch.equal(got, serving.serving_forward(s, cfg, u8, use_kernels=False, **staged))
    assert torch.equal(got, serving.serving_forward(s, cfg, u8, lis=lis))
    assert torch.equal(got, serving.serving_forward(s, cfg, xf, **staged))


def _ptf(rng, n, base):
    """A PTF scale vector: base·2^k, k ∈ {0..3}, so the LN mask is {1, 2, 4, 8}."""
    return torch.from_numpy((base * 2.0 ** rng.randint(0, 4, n)).astype(np.float32))


# Swin-T's int-LN calls at batch 2: (M, C) of the patch norm and first norm1s,
# the PatchMerging rows (4C), and the attention-side junctions
SWIN_T_LN = [(2 * 3136, 96), (2 * 784, 192), (2 * 196, 384), (2 * 49, 768), (2 * 784, 384), (2 * 196, 768),
             (2 * 49, 1536)]
SWIN_T_RES = [(2 * 3136, 96), (2 * 784, 192), (2 * 196, 384), (2 * 49, 768)]


def _ln_args(rng, m, c, mask=None, const_rows=0):
    s_in = _ptf(rng, c, 0.013)
    codes = _i8(rng, (m, c))
    const_rows = min(const_rows, m)
    codes[:const_rows] = torch.from_numpy(rng.randint(-128, 128, (const_rows, 1)).astype(np.int8))
    codes[:min(1, const_rows)] = 0  # a row of zeros: mean/std = 0/0, NaN codes cast as the plain version casts them
    return [codes, torch.round(s_in / s_in.min()) if mask is None else mask, s_in.min(),
            torch.from_numpy(rng.randn(c).astype(np.float32)),
            torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)),
            torch.from_numpy((np.abs(rng.randn(c)) * 0.03 + 0.01).astype(np.float32)), 1.0]


@pytest.mark.parametrize("m,c", SWIN_T_LN + [(2 * 3136 + 5, 96), (2 * 196 + 3, 384), (50, 3072), (77, 18),
                                             (129, 98), (3, 100), (200, 3074), (33, intln.MAX_C)])
def test_int_ln_requant_kernel(dev, m, c):
    """Every Swin-T int-LN shape at batch 2, ragged M, padded C (18, 98, 100,
    3074), swin_base's widest 3072 row and the widest C JAX serves; the
    first 5 rows constant (std = 0: the row constants are inf, or NaN on
    the first row, all zeros)."""
    rng = np.random.RandomState(c + m)
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in _ln_args(rng, m, c, const_rows=5)]
    _same(intln.int_ln_requant(*args), intln.int_ln_requant_plain(*args))


def test_int_ln_chain_rewrites_exhaustive(dev):
    """The kernels' LN chain (``ln_code_fast``: 2^N and 2^-N from a's bits,
    and with every ratio 1 the round of y folded into the biased clip)
    against ``p2v::ln_elem``'s forms, over all 2^32 float32 inputs."""
    assert intln.ln_chain_check(dev) == (0, 0)


def _res_args(rng, m, c, const_rows=0):
    a, b = _i8(rng, (m, c)), _i8(rng, (m, c))
    a[:const_rows], b[:const_rows] = 0, 17  # residual codes constant along the row where s_out is a scalar
    b[:min(1, const_rows)] = 0  # a row of zero residual codes: NaN LN codes
    return [a, _ptf(rng, c, 0.011), b, torch.tensor(2.0**-5), _ptf(rng, c, 0.017),
            torch.from_numpy(rng.randn(c).astype(np.float32)),
            torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)), torch.tensor(2.0**-4), 1.0]


@pytest.mark.parametrize("m,c", SWIN_T_RES + [(2 * 3136 + 7, 96), (2 * 49 + 1, 768), (5, 18), (130, 100),
                                              (64, 1536), (33, intln.MAX_RES_C)])
def test_int_res_ln_requant_kernel(dev, m, c):
    """Every Swin-T junction shape at batch 2, ragged M, padded C and the
    widest C JAX serves; the first 4 rows' residual codes constant where
    s_out is a scalar (std = 0), the first row's zero."""
    rng = np.random.RandomState(c + m + 1)
    args = _res_args(rng, m, c, const_rows=4)
    for s_out in (args[4], torch.tensor(0.017)):
        a = [t.to(dev) if isinstance(t, torch.Tensor) else t for t in args[:4] + [s_out] + args[5:]]
        _same(intln.int_res_ln_requant(*a), intln.int_res_ln_requant_plain(*a))


@pytest.mark.parametrize("kind", ["mask16", "fraction", "negative"])
def test_int_ln_kernels_any_mask(dev, kind):
    """Masks that are not integers of magnitude ≤ 8 take the kernel's int64
    sums of truncated x, as the plain version's ``row_sums``."""
    rng = np.random.RandomState(3)
    m, c = 300, 384
    mask = {"mask16": torch.from_numpy(2.0 ** rng.randint(0, 5, c)).float(),
            "fraction": torch.from_numpy(rng.randint(1, 9, c) * 0.75).float(),
            "negative": -torch.from_numpy(2.0 ** rng.randint(0, 4, c)).float()}[kind]
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in _ln_args(rng, m, c, mask=mask)]
    _same(intln.int_ln_requant(*args), intln.int_ln_requant_plain(*args))
    ra = _res_args(rng, m, c)
    ra[4] = torch.from_numpy((0.01 * 2.0 ** rng.randint(0, 6, c)).astype(np.float32))  # masks up to 32
    ra = [t.to(dev) if isinstance(t, torch.Tensor) else t for t in ra]
    _same(intln.int_res_ln_requant(*ra), intln.int_res_ln_requant_plain(*ra))


@pytest.mark.parametrize("res", [False, True])
def test_int_ln_plan_and_forced_launches(dev, res):
    """The C plan equals ``ln_plan`` on the card's SMs and resident CTAs at
    Swin-T's shapes at batches 1 and 64; every forced G (1 to 32) gives the
    plain version's codes."""
    shapes = SWIN_T_RES if res else SWIN_T_LN
    for batch in (1, 64):
        for m2, c in shapes:
            m = m2 // 2 * batch
            info = intln.ln_kernel_info(m, c, res)
            plan = intln.ln_plan(m, c, res, info["sms"], info["ctas_per_sm"])
            assert (info["g"], info["k"], info["rows"], info["blocks"], info["grid"], info["smem_bytes"]) == (
                plan.g, plan.k, plan.rows, plan.blocks, plan.grid, plan.smem_bytes)
            assert info["spill_bytes"] == 0
    rng = np.random.RandomState(9)
    m, c = 2 * 3136 + 3, 96
    if res:
        args = [t.to(dev) if isinstance(t, torch.Tensor) else t for t in _res_args(rng, m, c, const_rows=2)]
        want, kern = intln.int_res_ln_requant_plain(*args), intln.int_res_ln_requant_forced
    else:
        args = [t.to(dev) if isinstance(t, torch.Tensor) else t for t in _ln_args(rng, m, c, const_rows=2)]
        want, kern = intln.int_ln_requant_plain(*args), intln.int_ln_requant_forced
    before = (intln.int_ln_requant.launches, intln.int_res_ln_requant.launches)
    for g in (1, 2, 4, 8, 16, 32):
        _same(kern(*args, g=g), want)
    assert (intln.int_ln_requant.launches, intln.int_res_ln_requant.launches) == before


def _swin_attn_args(rng, windows, n_win, heads, masked, distinct_masks=False):
    c = 32 * heads
    qkv = _i8(rng, (windows, 49, 3 * c))
    bias = torch.from_numpy((rng.randn(heads, 49, 49) * 0.3).astype(np.float32))
    s2 = 2.0**-4
    mask = None
    if masked:
        if distinct_masks:
            m = -100.0 * (rng.rand(n_win, 49, 49) < 0.3)
        else:
            res = int(round(n_win**0.5)) * 7
            m = swin.shift_attn_mask(res, res, 7, 3)
        mask = torch.from_numpy((m / s2).astype(np.float32))
    return qkv, bias, mask, heads, n_win, 2.0**-9, 2.0**-4, s2, 2.0**-2


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("case", ["stage0", "stage0_shifted", "stage2_shifted", "mask_chunks"])
def test_swin_lis_attention_kernel(dev, case, lis):
    """Swin-T shapes: stage 0 (64 windows per image, 3 heads) plain and
    shifted, stage 2 (4 windows, 12 heads) shifted, and 64 distinct masks per
    image, so a wrong ``w % n_windows`` index changes the output."""
    rng = np.random.RandomState(3)
    windows, n_win, heads = {"stage0": (128, 64, 3), "stage0_shifted": (128, 64, 3),
                             "stage2_shifted": (8, 4, 12), "mask_chunks": (128, 64, 2)}[case]
    a = _swin_attn_args(rng, windows, n_win, heads, case != "stage0", case == "mask_chunks")
    a = tuple(t.to(dev) if isinstance(t, torch.Tensor) else t for t in a)
    _same(attention_lis.swin_lis_attention(*a, lis=lis), attention_lis.swin_lis_attention_plain(*a, lis=lis))


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("grid", [1, 7, 0, -1])
def test_swin_lis_attention_forced_grids(dev, grid, lis):
    """The persistent grid forced to one CTA (every item in turn: bias and
    mask restaged across heads and window positions), 7 CTAs, the plan's and
    one item per CTA (-1), at Swin-T stage 0's shifted shapes (64 distinct
    masks): bit for bit the plain version."""
    rng = np.random.RandomState(5)
    a = tuple(t.to(dev) if isinstance(t, torch.Tensor) else t for t in _swin_attn_args(rng, 128, 64, 3, True, True))
    g = 128 * 3 if grid == -1 else grid
    _same(attention_lis.swin_lis_attention(*a, lis=lis, grid=g), attention_lis.swin_lis_attention_plain(*a, lis=lis))


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("batch", [1, 8, 64])
def test_swin_attention_at_swin_t_stages(dev, batch, lis):
    """Both entries at every Swin-T stage (res 56/28/14/7, heads 3/6/12/24)
    and batches 1, 8 and 64: the panel entry with and without the shift
    mask, the folded entry (stages of more than one window) at shift 0
    unmasked and at shift 3 masked, against their plain versions; the
    shifted folded entry also against roll → the panel kernel → roll."""
    rng = np.random.RandomState(batch)
    for stage in range(4):
        res, heads = 56 >> stage, 3 << stage
        g2 = (res // 7) ** 2
        c = 32 * heads
        qkv = _i8(rng, (batch, res, res, 3 * c)).to(dev)
        bias = torch.from_numpy((rng.randn(heads, 49, 49) * 0.3).astype(np.float32)).to(dev)
        mask = torch.from_numpy(swin.shift_attn_mask(res, res, 7, 3) / 2.0**-4).float().to(dev) if g2 > 1 else None
        sc = (2.0**-9, 2.0**-4, 2.0**-4, 2.0**-2)
        panels = swin.window_partition(qkv, 7).contiguous()
        for m in ((None, mask) if mask is not None else (None,)):
            a = (panels, bias, m, heads, g2) + sc
            _same(attention_lis.swin_lis_attention(*a, lis=lis), attention_lis.swin_lis_attention_plain(*a, lis=lis))
        if g2 == 1:
            continue
        for shift, m in ((0, None), (3, mask)):
            a = (qkv, bias, m, heads, 7) + sc
            got = attention_lis.swin_lis_attention_folded(*a, lis=lis, shift=shift)
            _same(got, attention_lis.swin_lis_attention_folded_plain(*a, lis=lis, shift=shift))
        rolled = swin.window_partition(torch.roll(qkv, (-3, -3), (1, 2)), 7).contiguous()
        two_step = attention_lis.swin_lis_attention(rolled, bias, mask, heads, g2, *sc, lis=lis)
        _same(got, torch.roll(swin.window_reverse(two_step, 7, res, res), (3, 3), (1, 2)).contiguous())


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("fold", [False, True])
def test_swin_attention_plan_matches_kernel(dev, fold, lis):
    """The launch facts at N = 49: the shared memory swin_attention_smem
    states, nothing spilled, 4 CTAs per SM with LIS and 3 without; the
    phase hook's readings (the grid the plan states, the middle CTA's items
    and bias stagings, a phase clock that adds up to no more than its total)
    and every CTA's span (each CTA ran; the items went to all of them)."""
    info = attention_lis.swin_attention_info(49, lis, fold)
    assert info["smem_bytes"] == attention_lis.swin_attention_smem(49, lis) and info["spill_bytes"] == 0
    assert info["ctas_per_sm"] == (4 if lis else 3)
    rng = np.random.RandomState(6)
    qkv = _i8(rng, (8, 56, 56, 288)).to(dev)
    bias = torch.from_numpy((rng.randn(3, 49, 49) * 0.3).astype(np.float32)).to(dev)
    mask = torch.from_numpy(swin.shift_attn_mask(56, 56, 7, 3) / 2.0**-4).float().to(dev)
    sc = (2.0**-9, 2.0**-4, 2.0**-4, 2.0**-2)
    plan = attention_lis.swin_attention_plan(8 * 64, 64, 3, 49, info["sms"], info["ctas_per_sm"], lis=lis)
    stamps = torch.zeros(9, dtype=torch.int64, device=dev)
    spans = torch.zeros(2 * plan.grid, dtype=torch.int64, device=dev)
    if fold:
        a = (qkv, bias, mask, 3, 7) + sc
        kw = dict(lis=lis, shift=3)
        want = attention_lis.swin_lis_attention_folded_plain(*a, **kw)
        kern = attention_lis.swin_lis_attention_folded
    else:
        a = (swin.window_partition(qkv, 7).contiguous(), bias, mask, 3, 64) + sc
        kw = dict(lis=lis)
        want = attention_lis.swin_lis_attention_plain(*a, **kw)
        kern = attention_lis.swin_lis_attention
    _same(kern(*a, **kw, phase_ns=stamps), want)
    _same(kern(*a, **kw, cta_ns=spans), want)
    st = stamps.tolist()
    assert st[7] == plan.grid and 1 <= st[6] <= plan.items and 1 <= st[8] <= st[6]
    assert 0 < sum(st[:5]) <= st[5]
    se = spans.view(-1, 2)
    assert bool((se[:, 1] > se[:, 0]).all()) and bool((se[:, 0] > 0).all())


def test_swin_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    rng = np.random.RandomState(4)
    a = tuple(t.to(dev) if isinstance(t, torch.Tensor) else t
              for t in _swin_attn_args(rng, 4, 4, 2, False))
    # LIS off launches the kernel's fp softmax arm and skips the LIS scale bound
    low = a[:7] + (2.0**-21,) + a[8:]
    _same(attention_lis.swin_lis_attention(*low, lis=False),
          attention_lis.swin_lis_attention_plain(*low, lis=False))
    with pytest.raises(ValueError, match="2\\^-20"):
        attention_lis.swin_lis_attention(*low)
    with pytest.raises(ValueError, match="head_dim"):
        attention_lis.swin_lis_attention(torch.zeros(4, 49, 384, dtype=torch.int8, device=dev), a[1][:1], None, 1,
                                         *a[4:])
    x = torch.zeros(8, intln.MAX_C + 1, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match=f"C <= {intln.MAX_C}"):
        intln.int_ln_requant(x, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0)
    with pytest.raises(ValueError, match=f"C <= {intln.MAX_RES_C}"):
        intln.int_res_ln_requant(x, 1.0, x, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0)


def test_swin_serving_forward_small_model(dev):
    """A narrow two-stage Swin with head_dim 32: the whole serving path through
    the kernels equals the plain path bit for bit, with the expected launches."""
    cfg = dataclasses.replace(SWIN_ZOO["swin_tiny_patch4_window7_224"], img_size=112, embed_dim=64,
                              depths=(2, 2), num_heads=(2, 4), num_classes=10)
    policy = make_policy()
    params = swin.init_params(0, cfg, device=dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((3, 3, 112, 112), generator=gen).to(dev)
    calib = swin.calibrate(params, cfg, policy, x)
    s = serving_swin.convert(params, calib.qstate, cfg, policy, 4)
    reset_launch_counts()
    got = serving_swin.serving_forward(s, calib.qstate, cfg, policy, x)
    assert launch_counts() == {"fused_patch_embed": 0, "lis_attention_qkv_fused": 0,
                               "int8_matmul_res_ln": 3, "int8_matmul_requant": 15,
                               "int_ln_requant": 4, "int_res_ln_requant": 4,
                               "swin_lis_attention": 4, "lis_attention_fused": 0,
                               "lis_attention": 0, "fused_swin_stem": 0,
                               "swin_lis_attention_folded": 0, "fused_vit_layer": 0,
                               "int4_matmul_requant": 0, "wstream_matmul": 0}
    want = serving_swin.serving_forward(s, calib.qstate, cfg, policy, x, use_kernels=False)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("d", [8, 16])
def test_swin_attention_small_head_dims(dev, d, lis):
    """TINY Swin's head_dims 8 and 16 (4×4 windows on an 8×8 grid, 2 heads):
    the wrappers zero-pad each head to 32, and both entries, at shift 0 and
    2, equal their plain versions bit for bit; each call launches its kernel
    once."""
    rng = np.random.RandomState(d)
    heads, c, s2 = 2, 2 * d, 2.0**-4
    qkv = _i8(rng, (3, 8, 8, 3 * c)).to(dev)
    bias = torch.from_numpy((rng.randn(heads, 16, 16) * 0.3).astype(np.float32)).to(dev)
    mask = torch.from_numpy((swin.shift_attn_mask(8, 8, 4, 2) / s2).astype(np.float32)).to(dev)
    sc = (2.0**-12 * d**-0.5, 2.0**-4, s2, 2.0**-1)
    for m in (None, mask):
        panels = swin.window_partition(qkv, 4).contiguous()
        a = (panels, bias, m, heads, 4) + sc
        before = attention_lis.swin_lis_attention.launches
        got = attention_lis.swin_lis_attention(*a, lis=lis)
        assert attention_lis.swin_lis_attention.launches == before + 1 and got.shape == (12, 16, c)
        _same(got, attention_lis.swin_lis_attention_plain(*a, lis=lis))
        for shift in (0, 2):
            a = (qkv, bias, m, heads, 4) + sc
            _same(attention_lis.swin_lis_attention_folded(*a, lis=lis, shift=shift),
                  attention_lis.swin_lis_attention_folded_plain(*a, lis=lis, shift=shift))


@pytest.mark.parametrize("lis", [True, False])
def test_swin_serving_forward_tiny(dev, lis):
    """The JAX tests' TINY Swin (embed 16, heads (2, 2), 4×4 windows: head_dims
    8 and 16): serving_forward through the kernels equals the plain path bit
    for bit, LIS on and off."""
    cfg = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                          num_heads=(2, 2), window_size=4)
    policy = make_policy(lis=lis)
    params = swin.init_params(0, cfg, device=dev)
    x = torch.randn((5, 3, 32, 32), generator=torch.Generator().manual_seed(1)).to(dev)
    calib = swin.calibrate(params, cfg, policy, x)
    s = serving_swin.convert(params, calib.qstate, cfg, policy, 4)
    reset_launch_counts()
    got = serving_swin.serving_forward(s, calib.qstate, cfg, policy, x)
    assert launch_counts()["swin_lis_attention"] == 4
    want = serving_swin.serving_forward(s, calib.qstate, cfg, policy, x, use_kernels=False)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())


@pytest.mark.parametrize("case", ["randn", "pot"])
def test_fused_swin_stem_kernel(dev, case):
    """Swin-T's stem (K = 48, C = 96), ragged M: random-normal inputs, where
    only the fixed summation order makes the dot agree, and a calibrated
    state's kinds (PoT scales, PTF s_bn), where every partial sum is exact."""
    rng = np.random.RandomState(8)
    m, k, c = 2 * 3136 + 5, 48, 96
    bias = torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32))
    ln_w = torch.from_numpy(rng.randn(c).astype(np.float32))
    ln_b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    if case == "randn":
        px = torch.from_numpy(rng.randn(m, k).astype(np.float32))
        w = torch.from_numpy((rng.randn(c, k) * 0.2).astype(np.float32))
        s_bn, s_out = torch.tensor(0.04), torch.tensor(0.03)
    else:
        px = _i8(rng, (m, k)).to(torch.float32) * 2.0**-5
        w = _i8(rng, (c, k), -8, 8).to(torch.float32) * _pot(rng, c, -9, -6)[:, None]
        s_bn, s_out = _ptf(rng, c, 2.0**-3), torch.tensor(2.0**-4)
    args = [t.to(dev) for t in (px, w, bias, s_bn, ln_w, ln_b, s_out)]
    before = swin_stem.fused_swin_stem.launches
    _same(swin_stem.fused_swin_stem(*args), swin_stem.fused_swin_stem_plain(*args))
    assert swin_stem.fused_swin_stem.launches == before + 1
    with pytest.raises(ValueError, match="C <= 4096"):
        swin_stem.fused_swin_stem(args[0], torch.zeros(4100, k, device=dev), *args[2:])


@pytest.mark.parametrize("case", ["randn", "zero_row_mask16"])
@pytest.mark.parametrize("c", [96, 128, 192, 256])
def test_fused_swin_stem_widths(dev, c, case):
    """Each channel count a thread holds (C = 96, 128, 192, 256) at ragged
    M: random-normal inputs; and a calibrated state's kinds with PTF masks
    up to 16 (the int64 sums) and a zero patch row with zero bias (LN 0/0).
    The kernel's plan equals stem_plan's with the card's CTAs per SM."""
    rng = np.random.RandomState(c)
    m, k = 3136 + 77, 48
    bias = torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32))
    ln_w = torch.from_numpy(rng.randn(c).astype(np.float32))
    ln_b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    if case == "randn":
        px = torch.from_numpy(rng.randn(m, k).astype(np.float32))
        w = torch.from_numpy((rng.randn(c, k) * 0.2).astype(np.float32))
        s_bn, s_out = torch.tensor(0.04), torch.tensor(0.03)
    else:
        px = _i8(rng, (m, k)).to(torch.float32) * 2.0**-5
        px[100] = 0
        w = _i8(rng, (c, k), -8, 8).to(torch.float32) * _pot(rng, c, -9, -6)[:, None]
        bias = torch.zeros(c)
        s_bn = torch.from_numpy((2.0**-4 * 2.0 ** rng.randint(0, 5, c)).astype(np.float32))
        s_out = torch.tensor(2.0**-4)
    args = [t.to(dev) for t in (px, w, bias, s_bn, ln_w, ln_b, s_out)]
    info = swin_stem.stem_kernel_info(m, k, c)
    plan = swin_stem.stem_plan(m, k, c, info["sms"], info["ctas_per_sm"])
    assert (info["cc"], info["c_pad"], info["blocks"], info["grid"], info["smem_bytes"]) == (
        plan.cc, plan.c_pad, plan.blocks, plan.grid, plan.smem_bytes)
    _same(swin_stem.fused_swin_stem(*args), swin_stem.fused_swin_stem_plain(*args))


@pytest.mark.parametrize("case", ["randn", "zero_row_mask16"])
@pytest.mark.parametrize("c", [257, 384, 512, 768, 1024])
def test_fused_swin_stem_wide(dev, c, case):
    """Past C = 256, clusters of ⌈C/256⌉ CTAs split the channels and add
    their partial row sums through distributed shared memory: bitwise
    against the plain version at ragged M on random-normal inputs and on a
    calibrated state's kinds with PTF masks up to 16 and a zero patch row
    (LN 0/0); the launch facts equal stem_plan's with the card's resident
    clusters; forced grids of 1 and 7 clusters and one block a cluster."""
    rng = np.random.RandomState(c)
    m, k = 3136 + 77, 48
    bias = torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32))
    ln_w = torch.from_numpy(rng.randn(c).astype(np.float32))
    ln_b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    if case == "randn":
        px = torch.from_numpy(rng.randn(m, k).astype(np.float32))
        w = torch.from_numpy((rng.randn(c, k) * 0.2).astype(np.float32))
        s_bn, s_out = torch.tensor(0.04), torch.tensor(0.03)
    else:
        px = _i8(rng, (m, k)).to(torch.float32) * 2.0**-5
        px[100] = 0
        w = _i8(rng, (c, k), -8, 8).to(torch.float32) * _pot(rng, c, -9, -6)[:, None]
        bias = torch.zeros(c)
        s_bn = torch.from_numpy((2.0**-4 * 2.0 ** rng.randint(0, 5, c)).astype(np.float32))
        s_out = torch.tensor(2.0**-4)
    args = [t.to(dev) for t in (px, w, bias, s_bn, ln_w, ln_b, s_out)]
    info = swin_stem.stem_kernel_info(m, k, c)
    plan = swin_stem.stem_plan(m, k, c, info["sms"], info["ctas_per_sm"], clusters=info["clusters"])
    assert (info["cc"], info["c_pad"], info["cs"], info["blocks"], info["grid"], info["smem_bytes"]) == (
        plan.cc, plan.c_pad, plan.cs, plan.blocks, plan.grid, plan.smem_bytes)
    want = swin_stem.fused_swin_stem_plain(*args)
    before = swin_stem.fused_swin_stem.launches
    _same(swin_stem.fused_swin_stem(*args), want)
    assert swin_stem.fused_swin_stem.launches == before + 1
    for g in (1, 7, plan.blocks):
        _same(swin_stem.fused_swin_stem_forced(*args, grid=g), want)


@pytest.mark.parametrize("grid", [0, 1, 7, "blocks"])
def test_fused_swin_stem_forced_grid(dev, grid):
    """The persistent grid's double buffer on any grid: the plan's, one CTA
    taking every block, 7 CTAs, and one block a CTA, all equal to the plain
    version; the hook counts no launch."""
    rng = np.random.RandomState(15)
    m, k, c = 20 * 64 + 9, 48, 96
    args = [t.to(dev) for t in (torch.from_numpy(rng.randn(m, k).astype(np.float32)),
                                torch.from_numpy((rng.randn(c, k) * 0.2).astype(np.float32)),
                                torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32)), torch.tensor(0.04),
                                torch.from_numpy(rng.randn(c).astype(np.float32)),
                                torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)), torch.tensor(0.03))]
    g = swin_stem.stem_plan(m, k, c).blocks if grid == "blocks" else grid
    before = swin_stem.fused_swin_stem.launches
    _same(swin_stem.fused_swin_stem_forced(*args, grid=g), swin_stem.fused_swin_stem_plain(*args))
    assert swin_stem.fused_swin_stem.launches == before


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("stage", [0, 1, 2])
def test_swin_lis_attention_folded_kernel(dev, stage, masked, lis):
    """Swin-T's folded stages (res 56/28/14, heads 3/6/12, 7×7 windows),
    with and without the shift mask, against the plain version and against
    window_reverse of the panel kernel on the partitioned windows."""
    rng = np.random.RandomState(10 + stage)
    res, heads = 56 >> stage, 3 << stage
    c = 32 * heads
    qkv = _i8(rng, (2, res, res, 3 * c)).to(dev)
    bias = torch.from_numpy((rng.randn(heads, 49, 49) * 0.3).astype(np.float32)).to(dev)
    mask = (torch.from_numpy(swin.shift_attn_mask(res, res, 7, 3) / 2.0**-4).to(dev)
            if masked else None)
    a = (qkv, bias, mask, heads, 7, 2.0**-9, 2.0**-4, 2.0**-4, 2.0**-2)
    got = attention_lis.swin_lis_attention_folded(*a, lis=lis)
    _same(got, attention_lis.swin_lis_attention_folded_plain(*a, lis=lis))
    panels = swin.window_partition(qkv, 7).contiguous()
    two_step = attention_lis.swin_lis_attention(panels, bias, mask, heads, (res // 7) ** 2, *a[5:],
                                                lis=lis)
    _same(got, swin.window_reverse(two_step, 7, res, res).contiguous())


def test_swin_folded_wrapper_raises_on_what_the_kernel_does_not_take(dev):
    bias = torch.zeros(2, 49, 49, device=dev)
    sc = (1.0, 2.0**-4, 1.0, 1.0)
    with pytest.raises(ValueError, match="square grid"):
        attention_lis.swin_lis_attention_folded(torch.zeros(1, 14, 7, 192, dtype=torch.int8, device=dev),
                                                bias, None, 2, 7, *sc)
    with pytest.raises(ValueError, match="square grid"):
        attention_lis.swin_lis_attention_folded(torch.zeros(1, 7, 7, 192, dtype=torch.int8, device=dev),
                                                bias, None, 2, 7, *sc)
    qkv = torch.zeros(1, 14, 14, 192, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="mask shape"):
        attention_lis.swin_lis_attention_folded(qkv, bias, torch.zeros(3, 49, 49, device=dev), 2, 7,
                                                *sc)
    with pytest.raises(ValueError, match="head_dim"):
        attention_lis.swin_lis_attention_folded(torch.zeros(1, 14, 14, 384, dtype=torch.int8, device=dev),
                                                bias[:1], None, 1, 7, *sc)
    with pytest.raises(ValueError, match="2\\^-20"):
        attention_lis.swin_lis_attention_folded(qkv, bias, None, 2, 7, 1.0, 2.0**-4, 2.0**-21, 1.0)


@pytest.mark.parametrize("flags", [dict(fold_windows=True), dict(fuse_stem=True),
                                   dict(int_stem=True, fuse_res=False),
                                   dict(fold_windows=True, fuse_stem=True, lis=False)])
def test_swin_serving_flags_small_model(dev, flags):
    """The serving flags on a narrow two-stage Swin (7×7 windows, stage 0
    folded, stage 1 one window): kernels equal the plain path bit for bit,
    with ``launches_per_forward``'s counts; fold_windows and (PoT s_bn)
    fuse_stem equal the default path."""
    cfg = dataclasses.replace(SWIN_ZOO["swin_tiny_patch4_window7_224"], img_size=56, embed_dim=64,
                              depths=(2, 2), num_heads=(2, 4), num_classes=10)
    policy = make_policy()
    params = swin.init_params(0, cfg, device=dev)
    x = torch.randn((3, 3, 56, 56), generator=torch.Generator().manual_seed(1)).to(dev)
    calib = swin.calibrate(params, cfg, policy, x)
    s = serving_swin.convert(params, calib.qstate, cfg, policy, 4)
    lis = flags.pop("lis", None)
    reset_launch_counts()
    got = serving_swin.serving_forward(s, calib.qstate, cfg, policy, x, lis=lis, **flags)
    want_counts = {k: 0 for k in launch_counts()}
    want_counts.update(serving_swin.launches_per_forward(cfg, **flags))
    assert launch_counts() == want_counts
    want = serving_swin.serving_forward(s, calib.qstate, cfg, policy, x, use_kernels=False, lis=lis,
                                        **flags)
    assert torch.equal(got, want) and bool(torch.isfinite(got).all())
    if "int_stem" not in flags:
        assert torch.equal(got, serving_swin.serving_forward(s, calib.qstate, cfg, policy, x, lis=lis))


def _layer_args(dev, b, seed=11, dead=False):
    """One encoder layer's arguments at DeiT-S width (N = 197, C = 384, 6
    heads, hid 1536): int8 codes, W4 weights, PoT requants, PTF residual
    scales; ``dead`` zeroes LN2's out-scale in channel 0."""
    rng = np.random.RandomState(seed)
    n, c, hid, heads = 197, 384, 1536, 6

    def f(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    ln_out = (np.abs(rng.randn(c)) * 0.03 + 0.01).astype(np.float32)
    if dead:
        ln_out[0] = 0.0
    args = [_i8(rng, (b, n, c)), _i8(rng, (b, n, c)), _i8(rng, (3 * c, c), -8, 8), _pot(rng, 3 * c, -8, -6),
            f(rng.randn(3 * c)), heads, 2.0**-9, 2.0**-4, 4.0,
            _i8(rng, (c, c), -8, 8), _pot(rng, c, -8, -6), f(rng.randn(c)), 2.0**-5, _ptf(rng, c, 0.011),
            _ptf(rng, c, 0.03), f(rng.randn(c)), f(rng.randn(c) * 0.1), f(ln_out), _pot(rng, c, -1, 2),
            _i8(rng, (hid, c), -8, 8), _pot(rng, hid, -10, -8), f(rng.randn(hid) * 0.5), 16.0,
            _i8(rng, (c, hid), -8, 8), _pot(rng, c, -10, -8), f(rng.randn(c)), 2.0**-4, _ptf(rng, c, 0.04),
            f(rng.randn(c)), f(rng.randn(c) * 0.1), f(np.abs(rng.randn(c)) * 0.03 + 0.01), 1.0]
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("b,dead", [(1, False), (3, False), (64, False), (3, True)])
def test_fused_vit_layer_kernel(dev, b, dead, lis):
    """One launch per layer, equal to the four-kernel pipeline's plain
    versions bit for bit, at DeiT-S width; batch 64 runs every phase over
    more work items than the grid has blocks."""
    a = _layer_args(dev, b, dead=dead)
    before = layer_fused.fused_vit_layer.launches
    got = layer_fused.fused_vit_layer(*a, lis=lis)
    assert layer_fused.fused_vit_layer.launches == before + 1
    want = layer_fused.fused_vit_layer_plain(*a, lis=lis)
    _same(got, want)
    assert len(torch.unique(got[0])) > 200 and len(torch.unique(got[1])) > 200


def test_fused_vit_layer_raises_where_it_does_not_fit(dev):
    """C = 48 with 4 heads (head_dim 12, which JAX's assert refuses too) on
    the card: ValueError naming fuse_layer=False."""
    rng = np.random.RandomState(12)
    c, hid = 48, 128
    v = lambda n: torch.ones(n, device=dev)  # noqa: E731
    args = [_i8(rng, (1, 17, c)).to(dev), _i8(rng, (1, 17, c)).to(dev), _i8(rng, (3 * c, c)).to(dev),
            v(3 * c), v(3 * c), 4, 1.0, 0.0625, 1.0, _i8(rng, (c, c)).to(dev), v(c), v(c), 1.0, v(c),
            v(c), v(c), v(c), v(c), 1.0, _i8(rng, (hid, c)).to(dev), v(hid), v(hid), 1.0,
            _i8(rng, (c, hid)).to(dev), v(c), v(c), 1.0, v(c), v(c), v(c), v(c), 1.0]
    with pytest.raises(ValueError, match="head_dim 12.*fuse_layer=False"):
        layer_fused.fused_vit_layer(*args)


def _small_layer_args(dev, b, n, c, heads, hid, seed=21):
    """A layer's arguments at any width (as ``_layer_args``)."""
    rng = np.random.RandomState(seed)

    def f(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    args = [_i8(rng, (b, n, c)), _i8(rng, (b, n, c)), _i8(rng, (3 * c, c), -8, 8), _pot(rng, 3 * c, -8, -6),
            f(rng.randn(3 * c)), heads, 2.0**-9, 2.0**-4, 4.0,
            _i8(rng, (c, c), -8, 8), _pot(rng, c, -8, -6), f(rng.randn(c)), 2.0**-5, _ptf(rng, c, 0.011),
            _ptf(rng, c, 0.03), f(rng.randn(c)), f(rng.randn(c) * 0.1), f(np.abs(rng.randn(c)) * 0.03 + 0.01),
            _pot(rng, c, -1, 2), _i8(rng, (hid, c), -8, 8), _pot(rng, hid, -10, -8), f(rng.randn(hid) * 0.5), 16.0,
            _i8(rng, (c, hid), -8, 8), _pot(rng, c, -10, -8), f(rng.randn(c)), 2.0**-4, _ptf(rng, c, 0.04),
            f(rng.randn(c)), f(rng.randn(c) * 0.1), f(np.abs(rng.randn(c)) * 0.03 + 0.01), 1.0]
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


# (B, N, C, heads, hid): head_dims 16 (C = 64, 4 heads), 32 (2 heads) and 64;
# N = 5, 65, 197 and 256; DeiT-T's width
LAYER_SHAPES = [(3, 5, 64, 4, 256), (3, 65, 64, 2, 256), (1, 197, 128, 2, 512), (3, 256, 192, 3, 768),
                (3, 197, 192, 6, 768), (2, 65, 384, 12, 1536), (1, 256, 384, 6, 1536)]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shape", LAYER_SHAPES, ids=lambda s: "b{}n{}c{}h{}hid{}".format(*s))
def test_fused_vit_layer_shapes(dev, shape, lis):
    """Every head_dim and token count the kernel takes, bitwise against the
    four-kernel pipeline's plain versions, with one counted launch."""
    a = _small_layer_args(dev, *shape)
    before = layer_fused.fused_vit_layer.launches
    got = layer_fused.fused_vit_layer(*a, lis=lis)
    assert layer_fused.fused_vit_layer.launches == before + 1
    _same(got, layer_fused.fused_vit_layer_plain(*a, lis=lis))


# (B, N, C, heads, hid): head_dims 8, 4, 2 and 1 at C = 64, 8 and 4 at
# DeiT-S width
LAYER_SMALL_HEAD_DIMS = [(3, 65, 64, 8, 256), (3, 65, 64, 16, 256), (2, 197, 64, 32, 256), (2, 70, 64, 64, 256),
                         (1, 197, 384, 48, 1536), (1, 197, 384, 96, 1536)]


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shape", LAYER_SMALL_HEAD_DIMS, ids=lambda s: "b{}n{}c{}h{}hid{}".format(*s))
def test_fused_vit_layer_small_head_dims(dev, shape, lis):
    """The fused layer at head_dims below 16: its attention phase stages
    rows of fewer than 16 bytes by byte loads (a 16-byte copy would read
    the next head's codes); bitwise against the plain version, also on one
    query group a chunk."""
    a = _small_layer_args(dev, *shape)
    layer_fused.check_fits(shape[1], shape[2], shape[3], shape[4])
    want = layer_fused.fused_vit_layer_plain(*a, lis=lis)
    _same(layer_fused.fused_vit_layer(*a, lis=lis), want)
    _same(layer_fused.fused_vit_layer_forced(*a, lis=lis, gc=1), want)


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("grid,gc,br", [(1, 0, 0), (1, 0, 64), (2, 0, 0), (7, 0, 64), (0, 1, 0), (0, 4, 0),
                                        (0, 13, 64), (5, 3, 32), (0, 0, 64)])
def test_fused_vit_layer_forced_plans(dev, grid, gc, br, lis):
    """Forced plans at DeiT-S width, batch 3: one CTA walks every tile, item
    and block (each warpgroup's ring phases carried across hundreds of
    chunks and across blocks), a few CTAs, the attention in chunks of 1, 3,
    4 and 13 query groups, phase C in blocks of 32 rows, of 64 and of both;
    each bitwise against the plain version."""
    a = _layer_args(dev, 3)
    _same(layer_fused.fused_vit_layer_forced(*a, lis=lis, grid=grid, gc=gc, br=br),
          layer_fused.fused_vit_layer_plain(*a, lis=lis))


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("b,n,c,heads,hid", [(64, 197, 384, 6, 1536), (64, 197, 192, 3, 768), (3, 65, 64, 4, 256)])
def test_fused_vit_layer_plan_matches_kernel(dev, b, n, c, heads, hid, lis):
    """The CUDA runtime's view of the launch agrees with ``layer_plan``
    (threads, grid, shared memory per phase, groups a chunk, padded
    head_dim, phase C's blocks); one CTA fits an SM within the 168
    registers a thread that 384 threads leave."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = layer_fused.layer_plan(b, n, c, heads, hid, lis, sms=sms)
    info = layer_fused.layer_kernel_info(b, n, c, heads, hid, lis)
    assert (info["threads"], info["grid"], info["smem_bytes"], info["smem_a"], info["smem_b"], info["smem_c"],
            info["gc"], info["hdp"], info["blocks_64"], info["blocks"]) == (
        plan.threads, plan.grid, plan.smem_bytes, plan.smem_a, plan.smem_b, plan.smem_c, plan.gc, plan.hdp,
        plan.blocks_64, plan.blocks)
    assert info["ctas_per_sm"] >= 1 and info["registers"] <= 168


@pytest.mark.parametrize("lis", [True, False])
def test_fused_vit_layer_phase_hook(dev, lis):
    """The phase clock: the same codes, one counted launch, four stamps in
    order."""
    a = _layer_args(dev, 8)
    stamps = torch.zeros(4, dtype=torch.int64, device=dev)
    before = layer_fused.fused_vit_layer.launches
    _same(layer_fused.fused_vit_layer(*a, lis=lis, phase_ns=stamps), layer_fused.fused_vit_layer_plain(*a, lis=lis))
    assert layer_fused.fused_vit_layer.launches == before + 1
    st = stamps.cpu()
    assert int(st[0]) > 0 and bool((st[1:] >= st[:-1]).all())


@pytest.mark.parametrize("lis", [True, False])
def test_serving_forward_fuse_layer_small_model(dev, lis):
    """``fuse_layer=True`` on a small ViT with head_dim 64: the kernels equal
    the plain path and the default four-kernel path bit for bit, with
    ``launches_per_forward(fuse_layer=True)``'s launches."""
    cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], img_size=64, depth=2,
                              embed_dim=128, num_heads=2, num_classes=10)
    policy = make_policy(lis=lis)
    params = vit.init_params(0, cfg, device=dev)
    x = torch.randn((6, 3, 64, 64), generator=torch.Generator().manual_seed(1)).to(dev)
    calib = vit.calibrate(params, cfg, policy, x)
    s = serving.convert(params, calib.qstate, cfg, policy, [4] * cfg.num_matmuls)
    reset_launch_counts()
    got = serving.serving_forward(s, cfg, x, lis=lis, fuse_layer=True)
    want_counts = {k: 0 for k in launch_counts()}
    want_counts.update(serving.launches_per_forward(cfg, fuse_layer=True))
    assert launch_counts() == want_counts
    assert torch.equal(got, serving.serving_forward(s, cfg, x, lis=lis, fuse_layer=True, use_kernels=False))
    assert torch.equal(got, serving.serving_forward(s, cfg, x, lis=lis))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n", [(1576, 384, 1536), (197, 1536, 384), (77, 384, 1000), (70, 260, 33),
                                   (64, 96, 48)])
def test_int4_matmul_requant_kernel(dev, m, k, n, gelu):
    """Against its plain version and the int8 kernel on the unpacked codes;
    K = 260 and 96 take the wrapper's half-K pad."""
    rng = np.random.RandomState(k + n)
    x, w = _i8(rng, (m, k)).to(dev), _i8(rng, (n, k), -8, 8).to(dev)
    r = _pot(rng, n, -14, -10).to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    kw = dict(out_inv=8.0, gelu=True) if gelu else {}
    wp = matmul_int8.pack_int4(w)
    before = matmul_int8.int4_matmul_requant.launches
    got = matmul_int8.int4_matmul_requant(x, wp, r, b, **kw)
    assert matmul_int8.int4_matmul_requant.launches == before + 1
    _same(got, matmul_int8.int4_matmul_requant_plain(x, wp, r, b, **kw))
    if k % 16 == 0:
        _same(got, matmul_int8.int8_matmul_requant(x, w, r, b, **kw))


def _int4_case(dev, seed, m, k, n, gelu, rexp=None):
    """int4_matmul_requant arguments: int8 x, int4-valued w and its packed
    store, PoT requant scales, a normal bias; returns ((x, store, r, b),
    kwargs, w)."""
    rng = np.random.RandomState(seed)
    x, w = _i8(rng, (m, k)).to(dev), _i8(rng, (n, k), -8, 8).to(dev)
    r = _pot(rng, n, *(rexp or ((-14, -10) if gelu else (-12, -7)))).to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    kw = dict(out_inv=torch.tensor(16.0, device=dev), gelu=True) if gelu else {}
    return (x, matmul_int8.pack_int4(w), r, b), kw, w


@pytest.mark.parametrize("n,gelu,bn", [(96, False, 96), (288, False, 144), (384, False, 192), (1152, False, 192),
                                       (1536, False, 256), (128, False, 128), (1000, False, 144),
                                       (384, True, 64), (1536, True, 64)])
def test_int4_matmul_requant_each_tile_width(dev, n, gelu, bn):
    """Every width the plan picks, on TMA loads of the packed store and int8
    wgmma: the C entry's plan equals ``int4_requant_plan``'s, its registers
    are those the setmaxnreg hand-over assumes, nothing spills; bitwise
    against the plain version and the int8 kernel on the unpacked codes."""
    m, k = (37_632, 96) if n <= 384 and not gelu else (12_608, 384)
    a, kw, w = _int4_case(dev, n + gelu, m, k, n, gelu)
    info = matmul_int8.int4_kernel_info(m, n, k, gelu)
    plan = matmul_int8.int4_requant_plan(m, n, k, info["sms"], gelu)
    assert info["bn"] == plan.bn == bn
    assert (info["nc"], info["stages"], info["grid"], info["smem_bytes"]) == (
        plan.nc, plan.stages, plan.grid, plan.smem_bytes)
    assert plan.stages >= 2 and info["registers"] == (65536 // (128 * (plan.nc + 1))) // 8 * 8
    assert info["spill_bytes"] == 0 and info["ctas_per_sm"] == 1
    got = matmul_int8.int4_matmul_requant(*a, **kw)
    _same(got, matmul_int8.int4_matmul_requant_plain(*a, **kw))
    _same(got, matmul_int8.int8_matmul_requant(a[0], w, *a[2:], **kw))


@pytest.mark.parametrize("m", [1, 63, 64, 65, 12608])
@pytest.mark.parametrize("k,n", [(260, 33), (384, 1000), (96, 1536), (3072, 384), (48, 200)])
def test_int4_matmul_requant_edges(dev, m, k, n):
    """M below, at and past a 64-row tile; N not a multiple of 16 (33:
    one-byte stores; 1000: a masked 8-column edge); K/2 = 130 (padded to
    144), 192 and 1536 (K/2 % 128 != 0: the last packed box reads zeros past
    K/2, and the low x box reads high-half codes against them), 48 and 24
    (below one box)."""
    gelu = (m + n) % 2 == 1
    a, kw, w = _int4_case(dev, m + k + n, m, k, n, gelu)
    _same(matmul_int8.int4_matmul_requant(*a, **kw), matmul_int8.int4_matmul_requant_plain(*a, **kw))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n", [(1576, 384, 1536), (197, 1536, 384), (12608, 384, 1152)])
def test_int4_matmul_requant_forced_grids(dev, m, k, n, gelu):
    """One CTA walks every tile through one ring (the unpackers' and the
    consumers' barrier phases carried across hundreds of stages), and one
    tile a CTA; the grid hook counts no launch."""
    a, kw, _ = _int4_case(dev, m + n, m, k, n, gelu)
    want = matmul_int8.int4_matmul_requant_plain(*a, **kw)
    plan = matmul_int8.int4_requant_plan(m, n, k, 1, gelu)
    before = matmul_int8.int4_matmul_requant.launches
    for grid in (1, 3, plan.tiles):
        _same(matmul_int8.int4_matmul_requant_grid(*a, **kw, grid=grid), want)
    assert matmul_int8.int4_matmul_requant.launches == before


@pytest.mark.parametrize("qmin,qmax", [(-8, 7), (0, 15), (-128, 127)])
@pytest.mark.parametrize("gelu", [False, True])
def test_int4_matmul_requant_clamp_arms(dev, qmin, qmax, gelu):
    """The int4 clamp, an unsigned 4-bit clamp and the full int8 range,
    with requant scales 8× larger, so that many codes saturate at both
    ends."""
    a, kw, _ = _int4_case(dev, qmax - qmin, 1576, 384, 1536, gelu)
    a = (a[0], a[1], a[2] * 8, a[3])
    _same(matmul_int8.int4_matmul_requant(*a, qmin=qmin, qmax=qmax, **kw),
          matmul_int8.int4_matmul_requant_plain(*a, qmin=qmin, qmax=qmax, **kw))


@pytest.mark.parametrize("qmin,qmax", [(-2 ** 23, 2 ** 23), (-2 ** 22 - 1, 5), (-2 ** 24, 2 ** 24)])
@pytest.mark.parametrize("gelu", [False, True])
def test_int4_matmul_requant_wide_clamp(dev, qmin, qmax, gelu):
    """|qmin| or |qmax| past 2^22, where the int8 kernel's rounding by
    adding 1.5·2^23 no longer holds: the int4 kernel rounds as the plain
    version (rintf, the clip, the conversion to int8), bit for bit, with
    values of magnitude past 2^22 (up to ~2^24) clipped or kept."""
    a, kw, _ = _int4_case(dev, qmax, 1576, 384, 1536, gelu, rexp=(-2, 0) if gelu else (7, 10))
    if gelu:
        kw["out_inv"] = torch.tensor(1024.0, device=dev)
    want = matmul_int8.int4_matmul_requant_plain(*a, qmin=qmin, qmax=qmax, **kw)
    y = matmul_int8.int_matmul_nt(a[0], matmul_int8.unpack_int4(a[1])).abs().max() * a[2].max()
    assert float(y) * (1024 if gelu else 1) > 2 ** 22
    _same(matmul_int8.int4_matmul_requant(*a, qmin=qmin, qmax=qmax, **kw), want)


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("fmt", ["bf16", "i8", "w8p", "w4p"])
@pytest.mark.parametrize("m,k,n", [(197, 384, 1152), (1576, 1536, 384), (5, 200, 70), (12608, 384, 1536),
                                   (1, 3072, 1152), (8, 3072, 1536), (197, 3072, 1536)])
def test_wstream_matmul_kernel(dev, m, k, n, fmt, gelu):
    """Bit for bit against the plain version (exact panel sums), on every
    block tile the kernel picks by M and N (M = 1, 8, 197 take the small
    tiles)."""
    rng = np.random.RandomState(m + k + n)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(dev).to(torch.bfloat16)
    w = _i8(rng, (n, k), -8, 8).to(dev)
    r = _pot(rng, n, -9, -5).to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    store = {"bf16": w.to(torch.bfloat16), "i8": w, "w8p": matmul_wstream.pack_w8(w),
             "w4p": matmul_wstream.pack_w4(w)}[fmt]
    before = matmul_wstream.wstream_matmul.launches
    got = matmul_wstream.wstream_matmul(x, store, r, b, w_format=fmt, gelu=gelu)
    assert matmul_wstream.wstream_matmul.launches == before + 1
    want = matmul_wstream.wstream_matmul_plain(x, store, r, b, w_format=fmt, gelu=gelu)
    _same(got.view(torch.int16), want.view(torch.int16))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("fmt", ["bf16", "i8", "w8p", "w4p"])
@pytest.mark.parametrize("m,k,n", [(197, 3072, 1152), (12608, 384, 1536), (9, 203, 70)])
def test_wstream_matmul_wide_span_and_misaligned_kernel(dev, m, k, n, fmt, gelu):
    """Rows of x spanning 25 binades, full-range codes (int4 for w4p), and x
    and the store as .contiguous() copies of column slices: at K = 203 their
    rows are not 16-byte aligned, so the kernel stages them by elements."""
    from p2vit_tpu_torch.tools.wstream_bench import PACK, wide_span_x

    rng = np.random.RandomState(m + k + n + 25)
    x = wide_span_x(m, k + 3, 25, rng, dev)[:, 3:].contiguous()
    lo, hi = (-8, 8) if fmt == "w4p" else (-128, 128)
    w = _i8(rng, (n, k + 1), lo, hi)[:, 1:].contiguous().to(dev)
    r = _pot(rng, n, -16, -12).to(dev)
    b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
    store = PACK[fmt](w)
    got = matmul_wstream.wstream_matmul(x, store, r, b, w_format=fmt, gelu=gelu)
    want = matmul_wstream.wstream_matmul_plain(x, store, r, b, w_format=fmt, gelu=gelu)
    assert bool(torch.isfinite(want.float()).all())
    _same(got.view(torch.int16), want.view(torch.int16))


def test_wstream_blocks_fill_the_card_at_batch_1(dev):
    """The tile is picked by M and N: at M = 197 the qkv and fc1 GEMMs put
    about a block on every SM (126 and 168 on 132 SMs)."""
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n in (1152, 1536):
        assert matmul_wstream.wstream_blocks(197, n) >= 0.95 * sms
    assert matmul_wstream.wstream_blocks(12608, 1536) == 99 * 24


def test_wstream_w8p_full_range_codes_kernel(dev):
    rng = np.random.RandomState(7)
    x = torch.from_numpy(rng.randn(33, 384).astype(np.float32)).to(dev).to(torch.bfloat16)
    w = _i8(rng, (256, 384)).to(dev)
    r, b = torch.full((256,), 2.0**-7, device=dev), torch.zeros(256, device=dev)
    store = matmul_wstream.pack_w8(w)
    _same(matmul_wstream.wstream_matmul(x, store, r, b, w_format="w8p").view(torch.int16),
          matmul_wstream.wstream_matmul_plain(x, store, r, b, w_format="w8p").view(torch.int16))


def test_weight_store_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(64, 384, dtype=torch.int8, device=dev)
    wp = torch.zeros(128, 192, dtype=torch.int8, device=dev)
    v = torch.ones(128, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_int8.int4_matmul_requant(torch.zeros(64, 768, dtype=torch.int8, device=dev)[:, ::2], wp, v, v)
    with pytest.raises(TypeError):
        matmul_int8.int4_matmul_requant(x, wp.int(), v, v)
    xb = torch.zeros(64, 768, dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_wstream.wstream_matmul(xb[:, ::2], torch.zeros(128, 384, dtype=torch.int8, device=dev), v, v,
                                      w_format="i8")
    with pytest.raises(TypeError):
        matmul_wstream.wstream_matmul(xb[:, :384].contiguous(), torch.zeros(128, 128, dtype=torch.int8,
                                                                            device=dev), v, v, w_format="w8p")


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lis", [True, False])
def test_swin_attention_window12(dev, masked, lis):
    """12×12 windows (N = 144, the unstaged instance): both entries against
    their plain versions, and the folded entry against window_reverse of the
    panel entry, with and without the shift mask."""
    rng = np.random.RandomState(12)
    res, ws, heads = 24, 12, 3
    c, n = 32 * heads, ws * ws
    qkv = _i8(rng, (2, res, res, 3 * c)).to(dev)
    bias = torch.from_numpy((rng.randn(heads, n, n) * 0.3).astype(np.float32)).to(dev)
    mask = (torch.from_numpy(swin.shift_attn_mask(res, res, ws, ws // 2) / 2.0**-4).to(dev)
            if masked else None)
    a = (qkv, bias, mask, heads, ws, 2.0**-9, 2.0**-4, 2.0**-4, 2.0**-2)
    shift = ws // 2 if masked else 0
    got = attention_lis.swin_lis_attention_folded(*a, lis=lis, shift=shift)
    _same(got, attention_lis.swin_lis_attention_folded_plain(*a, lis=lis, shift=shift))
    panels = swin.window_partition(torch.roll(qkv, (-shift, -shift), (1, 2)), ws).contiguous()
    two_step = attention_lis.swin_lis_attention(panels, bias, mask, heads, (res // ws) ** 2, *a[5:], lis=lis)
    _same(two_step, attention_lis.swin_lis_attention_plain(panels, bias, mask, heads, (res // ws) ** 2, *a[5:],
                                                          lis=lis))
    _same(got, torch.roll(swin.window_reverse(two_step, ws, res, res), (shift, shift), (1, 2)).contiguous())
    info = attention_lis.swin_attention_info(n, lis)
    assert info["smem_bytes"] == attention_lis.swin_attention_smem(n, lis) and info["spill_bytes"] == 0

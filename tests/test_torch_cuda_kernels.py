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


@pytest.mark.parametrize("k", [384, 1536])
def test_int8_matmul_res_ln_kernel(dev, k):
    rng = np.random.RandomState(1)
    m, n = 394, 384
    args = [
        _i8(rng, (m, k)), _i8(rng, (n, k), -8, 8), _pot(rng, n, -10, -6),
        torch.from_numpy(rng.randn(n).astype(np.float32)), _i8(rng, (m, n)),
        torch.from_numpy((np.abs(rng.randn(n)) * 0.02 + 0.01).astype(np.float32)),
        torch.from_numpy((0.011 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)),
        torch.from_numpy((0.013 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)),
        torch.from_numpy(rng.randn(n).astype(np.float32)),
        torch.from_numpy((rng.randn(n) * 0.1).astype(np.float32)),
        torch.from_numpy((np.abs(rng.randn(n)) * 0.03 + 0.01).astype(np.float32)),
        _pot(rng, n, -1, 2),
    ]
    args = [a.to(dev) for a in args]
    _same(matmul_ln.int8_matmul_res_ln(*args), matmul_ln.int8_matmul_res_ln_plain(*args))


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("s_attn", [2.0**-11, 2.0**-5])
def test_lis_attention_qkv_fused_kernel(dev, s_attn, lis):
    rng = np.random.RandomState(2)
    b, n, c, heads = 3, 197, 384, 6
    h, w = _i8(rng, (b, n, c)).to(dev), _i8(rng, (3 * c, c)).to(dev)
    rv = _pot(rng, 3 * c, -13, -10).to(dev)
    bv = torch.from_numpy(rng.randn(3 * c).astype(np.float32)).to(dev)
    a = (h, w, rv, bv, heads, 2.0**-12, s_attn, 0.5)
    _same(attention_lis.lis_attention_qkv_fused(*a, lis=lis),
          attention_lis.lis_attention_qkv_fused_plain(*a, lis=lis))


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
    """Split (B·H, N, 64) q/k/v; another head_dim raises."""
    rng = np.random.RandomState(5)
    q, k, v = (_i8(rng, (18, 197, 64)).to(dev) for _ in range(3))
    a = (q, k, v, 2.0**-11, 2.0**-4, 2.0)
    _same(attention_lis.lis_attention(*a, lis=lis), attention_lis.lis_attention_plain(*a, lis=lis))
    with pytest.raises(ValueError, match="head_dim"):
        attention_lis.lis_attention(q[..., :32].contiguous(), k[..., :32].contiguous(),
                                    v[..., :32].contiguous(), *a[3:], lis=lis)


def test_wrappers_raise_on_what_the_kernels_do_not_take(dev):
    x = torch.zeros(64, 384, dtype=torch.int8, device=dev)
    w = torch.zeros(128, 384, dtype=torch.int8, device=dev)
    v = torch.ones(128, device=dev)
    with pytest.raises(TypeError):
        matmul_int8.int8_matmul_requant(x.int(), w, v, v)
    with pytest.raises(ValueError, match="contiguous"):
        matmul_int8.int8_matmul_requant(x[:, ::2], w[:, :192], v, v)
    with pytest.raises(ValueError, match="K % 16"):
        matmul_int8.int8_matmul_requant(x[:, :40].contiguous(), w[:, :40].contiguous(), v, v)
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


@pytest.mark.parametrize("m,c", [(2 * 3136 + 5, 96), (2 * 196, 384), (2 * 49, 1536), (50, 3072)])
def test_int_ln_requant_kernel(dev, m, c):
    """Swin-T's int-LN rows (patch norm C = 96, norm1 C = 384, the 4C = 1536
    PatchMerging row) and swin_base's widest 3072 row, ragged M."""
    rng = np.random.RandomState(c)
    s_in = _ptf(rng, c, 0.013)
    args = [_i8(rng, (m, c)), torch.round(s_in / s_in.min()), s_in.min(),
            torch.from_numpy(rng.randn(c).astype(np.float32)),
            torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)),
            torch.from_numpy((np.abs(rng.randn(c)) * 0.03 + 0.01).astype(np.float32)), 1.0]
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    _same(intln.int_ln_requant(*args), intln.int_ln_requant_plain(*args))


@pytest.mark.parametrize("c", [96, 768])
def test_int_res_ln_requant_kernel(dev, c):
    rng = np.random.RandomState(c + 1)
    m = 2 * 3136 if c == 96 else 2 * 49
    args = [_i8(rng, (m, c)), _ptf(rng, c, 0.011), _i8(rng, (m, c)), torch.tensor(2.0**-5),
            _ptf(rng, c, 0.017), torch.from_numpy(rng.randn(c).astype(np.float32)),
            torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)), torch.tensor(2.0**-4), 1.0]
    args = [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]
    _same(intln.int_res_ln_requant(*args), intln.int_res_ln_requant_plain(*args))


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
        attention_lis.swin_lis_attention(a[0], a[1][:1], None, 1, *a[4:])
    x = torch.zeros(8, 3074, dtype=torch.int8, device=dev)
    with pytest.raises(ValueError, match="C % 4"):
        intln.int_ln_requant(x, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0)


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
    with pytest.raises(ValueError, match="C <= 256"):
        swin_stem.fused_swin_stem(args[0], torch.zeros(300, k, device=dev), *args[2:])


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
        attention_lis.swin_lis_attention_folded(qkv, bias[:1], None, 1, 7, *sc)
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
    """head_dim 16 (a TINY layer) on the card: ValueError naming fuse_layer=False."""
    rng = np.random.RandomState(12)
    c, hid = 32, 128
    v = lambda n: torch.ones(n, device=dev)  # noqa: E731
    args = [_i8(rng, (1, 17, c)).to(dev), _i8(rng, (1, 17, c)).to(dev), _i8(rng, (3 * c, c)).to(dev),
            v(3 * c), v(3 * c), 2, 1.0, 0.0625, 1.0, _i8(rng, (c, c)).to(dev), v(c), v(c), 1.0, v(c),
            v(c), v(c), v(c), v(c), 1.0, _i8(rng, (hid, c)).to(dev), v(hid), v(hid), 1.0,
            _i8(rng, (c, hid)).to(dev), v(c), v(c), 1.0, v(c), v(c), v(c), v(c), 1.0]
    with pytest.raises(ValueError, match="head_dim 16.*fuse_layer=False"):
        layer_fused.fused_vit_layer(*args)


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


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("fmt", ["bf16", "i8", "w8p", "w4p"])
@pytest.mark.parametrize("m,k,n", [(197, 384, 1152), (1576, 1536, 384), (5, 200, 70), (12608, 384, 1536)])
def test_wstream_matmul_kernel(dev, m, k, n, fmt, gelu):
    """Bit for bit against the plain version (exact panel sums)."""
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

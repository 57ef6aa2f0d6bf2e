"""The int4-store GEMM's plan and data flow, on the CPU: ``int4_requant_plan``
(the C entry's plan, mirrored), a replay of the kernel's walk over tiles and
K through ``packed_slices``, an emulation of the 64-byte-swizzled ring
stage in which the packed box is unpacked chunk to chunk, the wrapper's
half-K padding, and the plain version against the JAX kernel (interpret) at
K/2 not a multiple of 128.

The kernel (``csrc/gemm_wgmma.cuh``, ``requant_kernel<..., PACKED>``) runs
on the card only; these tests hold what it computes from the shapes: every
(m, n, k) product is taken exactly once, and the unpacked tiles are the
codes ``unpack_int4`` gives, so the kernel's exact int32 sums equal the plain
version's.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.ops.matmul_int8 import int4_matmul_requant as j_int4
from p2vit_tpu.ops.matmul_int8 import pack_int4 as j_pack_int4
from p2vit_tpu_torch.ops import matmul_int8 as mi

SMS = 132  # the H100's SMs
SWIZZLE = 64  # bytes a packed box row holds; 16-byte chunks XOR (row / 2) % 4


def _case(seed, m, k, n):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    r = (2.0 ** rng.randint(-12, -6, n)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, w, r, b


# (M, N, K, gelu): the DeiT-S chain's GEMMs at batches 1, 8 and 64, its head,
# the deit_base fc2 control, Swin widths and ragged N
PLAN_CASES = [(197, 1152, 384, False), (1576, 384, 384, False), (12608, 1536, 384, True),
              (12608, 384, 1536, False), (197, 768, 3072, False), (64, 1000, 384, False),
              (200_704, 96, 96, False), (3136, 288, 96, False), (1, 33, 288, False), (12608, 3072, 768, True)]


@pytest.mark.parametrize("m,n,k,gelu", PLAN_CASES)
def test_int4_plan_widths_stages_and_grid(m, n, k, gelu):
    """The packed plan keeps the int8 store's width, consumers, tiles, grid
    and stage bytes (the same rules, ``WIDTHS``/``GELU_WIDTHS``): its ring
    takes as many stages as shared memory holds beside a third barrier a
    stage, at least four, as many as the int8 store's or one fewer; its
    shared memory is the C layout's."""
    p8 = mi.requant_plan(m, n, k, SMS, gelu)
    p4 = mi.int4_requant_plan(m, n, k, SMS, gelu)
    assert (p4.bn, p4.nc, p4.tiles_m, p4.tiles_n, p4.grid) == (p8.bn, p8.nc, p8.tiles_m, p8.tiles_n, p8.grid)
    assert mi.stage_bytes(p4.bn) == (64 + p4.bn) * 128 == (2 * 64 + 2 * p4.bn) * mi.PACKED_K
    assert 4 <= p4.stages <= mi.MAX_STAGES and p8.stages - 1 <= p4.stages <= p8.stages
    assert p4.smem_bytes == mi.requant_smem(p4.bn, p4.nc, p4.stages, gelu, True) <= mi.MAX_SMEM
    assert p4.stages == mi.MAX_STAGES or mi.requant_smem(p4.bn, p4.nc, p4.stages + 1, gelu, True) > mi.MAX_SMEM
    assert p4.grid == min(SMS, p4.tiles)


def test_int4_plan_smem_layout():
    """The stated layout at BN 192 (two consumers, plain): 1024 B of slack,
    the ring, the output tiles, r and b, three barriers a stage and an
    order barrier a consumer."""
    assert mi.requant_smem(192, 2, 6, False, True) == (1024 + 6 * (64 + 192) * 128 + 2 * 64 * 208
                                                       + 2 * 8 * 192 + 24 * 6 + 8 * 2)
    assert mi.requant_smem(64, 6, 5, True, True) - mi.requant_smem(64, 6, 5, True) == 5 * 8


@pytest.mark.parametrize("k,err", [(0, "K > 0"), (48, "K/2 % 16"), (100, "K/2 % 16")])
def test_int4_plan_refuses(k, err):
    with pytest.raises(ValueError, match=re.escape(err)):
        mi.int4_requant_plan(64, 64, k, SMS)
    with pytest.raises(ValueError, match="2\\^31"):
        mi.int4_requant_plan(2 ** 31, 64, 64, SMS)
    with pytest.raises(ValueError, match="one SM"):
        mi.int4_requant_plan(64, 64, 64, 0)


def _walk_acc(x, wp, plan):
    """The kernel's sums, replayed: for each CTA's tiles and each ring stage
    of ``packed_slices``, the low x box against the low codes of the packed
    box and the high x box against its high codes, 32 codes a wgmma step,
    with TMA's zeros past x's K columns, past M and N and past the store's
    K/2. Returns (acc int64 (M, N), count of times each (m, n, k) product
    was taken)."""
    m_, k_ = x.shape
    n_, kh = wp.shape
    codes = mi.unpack_int4(torch.from_numpy(wp)).numpy().astype(np.int64)
    lo_codes, hi_codes = codes[:, :kh], codes[:, kh:]
    acc = np.zeros((m_, n_), np.int64)
    taken = np.zeros((m_, n_, k_), np.int32)
    for _, _, _, t in plan.walk():
        m0, n0 = plan.tile(t)
        rows, cols = slice(m0, min(m0 + 64, m_)), slice(n0, min(n0 + plan.bn, n_))
        for xl, xh, pc, steps in mi.packed_slices(k_):
            for half, x0, b in ((0, xl, lo_codes), (1, xh, hi_codes)):
                for j in range(32 * steps):
                    xc, bc = x0 + j, pc + j
                    if xc >= k_ or bc >= kh:  # a TMA zero on either side
                        continue
                    acc[rows, cols] += np.outer(x[rows, xc].astype(np.int64), b[cols, bc])
                    # the product of x column xc and code column half·kh + bc
                    assert xc == half * kh + bc
                    taken[rows, cols, xc] += 1
    return acc, taken


@pytest.mark.parametrize("k", [48, 96, 384, 1536, 3072, 260])
def test_packed_walk_takes_every_product_once(k):
    """Every (m, n, k) product exactly once, on a grid of 3 CTAs and two
    consumers over ragged tiles: low slice s against x columns [s·64, …),
    high slice against [K/2 + s·64, …); the low box's columns past K/2
    (the high half's codes) meet the packed box's zeros. K = 48 and 260 go
    through the wrapper's pad to K/2 % 16 == 0 first. The replayed sums
    equal the exact product."""
    m, n = 70, 40
    x, w, _, _ = _case(k, m, k, n)
    xp, wp = mi.int4_pad(torch.from_numpy(x), mi.pack_int4(torch.from_numpy(w)))
    xp, wp = xp.numpy(), wp.numpy()
    kp = xp.shape[1]
    assert kp % 32 == 0 and kp >= k
    plan = mi.int4_requant_plan(m, n, kp, 3)
    acc, taken = _walk_acc(xp, wp, plan)
    assert (taken == 1).all()
    np.testing.assert_array_equal(acc, x.astype(np.int64) @ w.astype(np.int64).T)


def _swizzle_offsets(rows):
    """Byte offset in a 64-byte-swizzled box of (row, column) for a
    ``rows`` × 64 box (512-byte aligned): address bits 4–5 XOR bits 7–8,
    the 16-byte chunk index XOR (row / 2) % 4, as TMA writes it and the
    wgmma descriptor (layout SWIZZLE_64B) reads it."""
    r = np.arange(rows)[:, None]
    c = np.arange(SWIZZLE)[None, :]
    return r * SWIZZLE + (((c >> 4) ^ ((r >> 1) & 3)) << 4) + (c & 15)


def _nib_sext(v):
    """``p2v::nib_sext`` on uint32 words: one nibble a byte to int8 codes."""
    return v | ((v & np.uint32(0x08080808)) * np.uint32(0x1E))


@pytest.mark.parametrize("bn", [256, 192, 144, 128, 96, 64])
def test_swizzled_unpack_chunk_to_chunk_equals_unpack_int4(bn):
    """One ring stage, emulated: the packed box at column s·64 written by
    TMA in the 64-byte swizzle (zeros past K/2 and past N), each 16-byte
    chunk unpacked as the unpackers do (nib_sext of the low nibbles in
    place, of the high nibbles into the high tile at the same offset);
    read back through the descriptor's swizzle, the two tiles are
    ``unpack_int4``'s low and high codes of that box."""
    n, k = bn - 8, 2 * 208  # a ragged last row block and K/2 = 208: the last box holds 16 columns
    w = np.random.RandomState(bn).randint(-8, 8, (n, k)).astype(np.int8)
    wp = mi.pack_int4(torch.from_numpy(w)).numpy()
    codes = mi.unpack_int4(torch.from_numpy(wp)).numpy()
    kh = k // 2
    off = _swizzle_offsets(bn)
    for s in range(0, kh, SWIZZLE):
        box = np.zeros((bn, SWIZZLE), np.uint8)
        part = wp[:, s:s + SWIZZLE].view(np.uint8)
        box[:part.shape[0], :part.shape[1]] = part
        smem = np.zeros(bn * SWIZZLE, np.uint8)
        smem[off] = box  # TMA's write
        words = smem.view(np.uint32)
        lo = _nib_sext(words & np.uint32(0x0F0F0F0F))  # chunk i → chunk i, in place
        hi = _nib_sext((words >> np.uint32(4)) & np.uint32(0x0F0F0F0F))
        lo_tile = lo.view(np.uint8)[off].view(np.int8)  # the descriptor's read
        hi_tile = hi.view(np.uint8)[off].view(np.int8)
        width = min(SWIZZLE, kh - s)
        np.testing.assert_array_equal(lo_tile[:n, :width], codes[:, s:s + width])
        np.testing.assert_array_equal(hi_tile[:n, :width], codes[:, kh + s:kh + s + width])
        assert not lo_tile[:, width:].any() and not hi_tile[:, width:].any() and not lo_tile[n:].any()


@pytest.mark.parametrize("k", [260, 96, 384])
def test_int4_pad_halves(k):
    """``int4_pad``: each half of x and the store's rows padded with zero
    codes to K/2 % 16 == 0; the plain version gives the same codes on the
    padded operands (zeros add nothing)."""
    x, w, r, b = map(torch.from_numpy, _case(k + 1, 33, k, 48))
    wp = mi.pack_int4(w)
    xp, wpp = mi.int4_pad(x, wp)
    kh, khp = k // 2, -(-(k // 2) // 16) * 16
    assert xp.shape == (33, 2 * khp) and wpp.shape == (48, khp)
    assert torch.equal(xp[:, :kh], x[:, :kh]) and torch.equal(xp[:, khp:khp + kh], x[:, kh:])
    assert not xp[:, kh:khp].any() and not xp[:, khp + kh:].any() and not wpp[:, kh:].any()
    assert torch.equal(mi.int4_matmul_requant_plain(xp, wpp, r, b), mi.int4_matmul_requant_plain(x, wp, r, b))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("k", [384, 1000])
def test_int4_plain_vs_jax_half_k_not_a_box(k, gelu):
    """K/2 = 192 (DeiT-S) and 500, no multiple of 128: the plain version
    equals the JAX kernel (interpret, which pads each half to 128) bit for
    bit, plain and with GELU at out_inv = 16."""
    m, n = 70, 72
    x, w, r, b = _case(k + 7, m, k, n)
    kw = dict(out_inv=16.0, gelu=True) if gelu else {}
    jx, jw, jr, jb = map(jnp.asarray, (x, w, r, b))
    want = np.asarray(j_int4(jx, j_pack_int4(jw), jr, jb, interpret=True, **kw))
    got = mi.int4_matmul_requant_plain(torch.from_numpy(x), mi.pack_int4(torch.from_numpy(w)),
                                       torch.from_numpy(r), torch.from_numpy(b), **kw)
    assert len(np.unique(want)) > 20
    np.testing.assert_array_equal(got.numpy(), want)

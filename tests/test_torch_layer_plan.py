"""The fused encoder layer's Hopper design and the ViT per-item attention
body, on the CPU.

``csrc/layer_fused.cu`` runs one layer as three phases of one cooperative
launch (one 384-thread CTA per SM): the qkv GEMM in 64 × 64 tiles, the
attention per (image, head) item, and proj, LN2, fc1 + GELU, fc2 and the next
LN per block of 64 whole rows, every product a 64-column chunk through a TMA
ring and ``wgmma``, the MLP input and the GELU codes in 128-byte-swizzled
shared-memory tiles. ``csrc/attention_rows.cuh`` is the attention item of
that phase and of ``lis_attention_fused`` / ``lis_attention``: q/k/v staged
with the keys padded to 32 and the head_dim to 32 or 64 by zero codes, the
query groups in chunks, the LIS weights as hi/lo byte planes.

Here:
* ``layer_plan`` / ``layer_layout`` and ``vit_attention_plan``, the C plans'
  mirrors: threads, rows per block, grid, shared memory per phase, query
  groups a chunk, at DeiT-T and DeiT-S, and the refusals;
* a PyTorch replay of the kernels' data flow (the padded item in 16-row
  query-group chunks with the hi/lo planes; phase C in 64-row blocks, the
  tiles written and read through the swizzle, fc1 in 64-column chunks of
  128-byte K-blocks into the resident GELU tile, design (a)), equal bit for
  bit to the plain versions, which equal JAX's ``lis_attention_fused`` and
  ``fused_vit_layer`` in interpret mode bit for bit, LIS on and off (the
  LIS-off arm can differ from JAX's float32 softmax by a code elsewhere,
  tests/test_torch_staged_lisoff.py; on these inputs no code does).
"""

import numpy as np
import pytest
import torch

from p2vit_tpu.ops.attention_lis import lis_attention_fused as j_attn
from p2vit_tpu.ops.layer_fused import fused_vit_layer as j_layer
from p2vit_tpu_torch.models import VIT_ZOO
from p2vit_tpu_torch.ops import attention_lis, layer_fused, matmul_int8, matmul_ln
from p2vit_tpu_torch.ops.fastmath import exp_rn


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


# ---------------------------------------------------------------------------
# (a) the plans
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 8, 64])
@pytest.mark.parametrize("name", ["deit_tiny_patch16_224", "deit_small_patch16_224"])
def test_layer_plan_zoo(name, b):
    """DeiT-T and DeiT-S at batches 1, 8 and 64: one 384-thread CTA per SM
    (three warpgroups, two-stage rings), blocks of 64 rows, the grid the
    largest phase's work up to 132 SMs, the whole 13 query groups a chunk,
    shared memory the largest phase's."""
    cfg = VIT_ZOO[name]
    n, c, heads, hid = cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.hidden_dim
    p = layer_fused.layer_plan(b, n, c, heads, hid)
    m = b * n
    assert (p.threads, p.ring, p.hdp, p.gc) == (384, 2, 64, 13)
    assert p.tiles == -(-m // 64) * 3 * c // 64 and p.items == b * heads
    assert p.grid == min(132, max(p.tiles, p.items)) >= p.blocks / 3
    # batch 64: one round of 132 64-row blocks, the other 4160 rows in 130
    # blocks of 32; batches 1 and 8: 32-row blocks, one round
    assert p.blocks_64 == (132 if b == 64 else 0)
    assert 64 * p.blocks_64 + 32 * (p.blocks - p.blocks_64) - m in range(32)
    assert p.chunks == 2 * c // 64 + hid // 64
    assert p.smem_bytes == max(p.smem_a, p.smem_b, p.smem_c) + layer_fused.BAR_BYTES <= layer_fused.MAX_SMEM
    lay = layer_fused.layer_layout(n, c, heads, hid)
    assert lay["gelu"] % 1024 == 0 and lay["mlp"] % 1024 == 0  # the wgmma tiles' alignment
    assert lay["gelu"] == 3 * 2 * 64 * 128  # after the three rings of phase C
    assert lay["mlp"] - lay["gelu"] == 64 * 128 * -(-hid // 128) and lay["res1"] - lay["mlp"] == 64 * 128 * -(-c // 128)
    if name == "deit_small_patch16_224":  # the GELU tile makes phase C the largest
        assert (p.smem_a, p.smem_b, p.smem_c, p.smem_bytes) == (114_688, 214_016, 229_888, 229_992)
    else:  # phase B's two stages and planes
        assert p.smem_bytes == p.smem_b + layer_fused.BAR_BYTES == 214_120


@pytest.mark.parametrize("dims,why", [
    ((197, 768, 12, 3072), "shared memory"), ((197, 1024, 16, 4096), "shared memory"),
    ((300, 768, 12, 3072), "N = 300"), ((577, 256, 2, 1024), "head_dim 128"),
    ((17, 992, 31, 4000), "multiples of 64"), ((197, 96, 1, 384), "head_dim 96"),
])
def test_layer_plan_refusals(dims, why):
    """DeiT-B and ViT-L, N = 300 at DeiT-B width, head_dim 128 at N = 577
    and C = 992 (padded to 1024) past shared memory, and head_dim 96, which
    JAX's assert refuses: refused with the reason and fuse_layer=False."""
    with pytest.raises(ValueError, match=f"{why}.*fuse_layer=False"):
        layer_fused.layer_plan(2, *dims)


def test_layer_plan_hooks():
    """The forced plans: a grid up to the SMs, a smaller attention chunk
    (phase B's bytes shrink, the rest stays)."""
    base = layer_fused.layer_plan(3, 197, 384, 6, 1536)
    assert layer_fused.layer_plan(3, 197, 384, 6, 1536, grid=1).grid == 1
    with pytest.raises(ValueError, match="SMs"):
        layer_fused.layer_plan(3, 197, 384, 6, 1536, grid=133)
    small = layer_fused.layer_plan(3, 197, 384, 6, 1536, gc=4)
    assert small.gc == 4 and small.smem_b < base.smem_b and small.smem_c == base.smem_c
    assert layer_fused.layer_plan(3, 197, 384, 6, 1536).blocks == 19
    assert layer_fused.layer_plan(3, 197, 384, 6, 1536, br=64).blocks == 10
    assert layer_fused.layer_plan(3, 197, 384, 6, 1536, br=64).blocks_64 == 10
    with pytest.raises(ValueError, match="32 or 64"):
        layer_fused.layer_plan(3, 197, 384, 6, 1536, br=16)
    # phase C's split: rounds of 64-row blocks, then 32-row blocks at 3/4 of
    # their time: batch 64, 1 + 3/4 rounds (132 and 130 blocks) against 2
    # (197 of 64) and 9/4 (394 of 32); batch 256, 6 rounds of 64 (788
    # blocks) against 5 + 2·3/4
    assert [layer_fused.block_split(b * 197, 132) for b in (1, 8, 64, 256)] == [0, 0, 132, 788]
    # N = 256: two stages leave room for 8 of the 16 groups a chunk (balanced)
    assert layer_fused.layer_plan(1, 256, 384, 6, 1536).gc == 8


@pytest.mark.parametrize("n", [5, 17, 64, 197, 256])
def test_vit_attention_plan(n):
    """The per-item kernels' plan at every head_dim: head_dim padded to 32 or
    64, keys to 32; the most CTAs an SM (4, 3, 2) whose shared memory holds
    one query group a chunk, then the fewest balanced chunks within it."""
    for hd in (1, 2, 4, 8, 16, 17, 32, 33, 64):
        for lis in (True, False):
            p = attention_lis.vit_attention_plan(n, hd, lis)
            assert p.hdp == (32 if hd <= 32 else 64) and p.kpad == -(-n // 32) * 32 and p.groups == -(-n // 16)
            per_sm = next(k for k in (4, 3, 2) if attention_lis.vit_attention_layout(n, hd, lis, 1, 1)["total"]
                          <= attention_lis.SM_SMEM // k - 1024)
            budget = attention_lis.SM_SMEM // per_sm - 1024
            assert p.smem_bytes <= budget and p.gc >= 1
            assert p.chunks == -(-p.groups // p.gc) and p.gc == -(-p.groups // p.chunks)
            if p.chunks > 1:  # one chunk fewer would not fit
                fewer = attention_lis.vit_attention_layout(n, hd, lis, 1, -(-p.groups // (p.chunks - 1)))
                assert fewer["total"] > budget
    # DeiT-S: LIS on, 3 CTAs an SM and one group a chunk; LIS off, 4 and 2
    assert attention_lis.vit_attention_plan(197, 64, True).gc == 1
    assert attention_lis.vit_attention_plan(197, 64, False).gc == 2
    with pytest.raises(ValueError, match="shared memory"):
        attention_lis.vit_attention_plan(800, 64)
    with pytest.raises(ValueError, match="head_dim"):
        attention_lis.vit_attention_plan(n, 129)


# ---------------------------------------------------------------------------
# (b) the attention item, replayed
# ---------------------------------------------------------------------------


def replay_item(q, k, v, scal, lis, gc):
    """One (image, head) item as the kernel runs it: q/k/v of (N, hd) int8
    staged into zero-padded (rows, HDP) / (kpad, HDP) tiles; per chunk of gc
    16-row query groups the int32 scores over every padded key, their codes,
    then LIS weights 2^(15−q) split into hi = w >> 8 and lo = w & 255 planes
    and attn@v = 256·(hi·V) + lo·V over the padded keys, or the softmax and
    the float64 sum in key order; output columns past hd dropped."""
    rq, s_attn, ro, x0, b_int, c_int = (torch.tensor(x, dtype=torch.float32) for x in scal)
    n, hd = q.shape
    lay = attention_lis.vit_attention_layout(n, hd, lis, 1, gc)
    hdp, kpad, ng = lay["hdp"], lay["kpad"], lay["groups"]

    def staged(t, rows):
        z = torch.zeros((rows, hdp), dtype=torch.int64)
        z[:n, :hd] = t.to(torch.int64)
        return z

    qs, ks, vs = staged(q, 16 * ng), staged(k, kpad), staged(v, kpad)
    out = torch.zeros((16 * ng, hdp), dtype=torch.int8)
    for g0 in range(0, ng, gc):
        r0, r1 = 16 * g0, 16 * min(g0 + gc, ng)
        acc = qs[r0:r1] @ ks.T  # int64: exact, any order
        codes = torch.clamp(torch.round(acc.to(torch.float32) * rq), -128, 127)[:, :n]
        if lis:
            big = attention_lis.lis_codes(codes, s_attn)
            w = torch.where(big < 16, torch.exp2((15 - big).to(torch.float32)), torch.zeros(())).to(torch.int64)
            w = torch.nn.functional.pad(w, (0, kpad - n))  # weight 0 past N
            hi, lo = w >> 8, w & 0xFF
            assert int(hi.max()) <= 128 and int(lo.max()) <= 255  # u8 planes
            av = (256 * (hi @ vs) + lo @ vs).to(torch.float32) * 2.0**-15
        else:
            logits = codes * s_attn
            e = exp_rn(logits - logits.amax(dim=-1, keepdim=True))
            p = (e / e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)).to(torch.float64)
            a = torch.zeros((r1 - r0, hdp), dtype=torch.float64)
            for j in range(n):  # key order; each product exact, each add rounded once
                a = a + p[:, j:j + 1] * vs[j].to(torch.float64)
            av = a.to(torch.float32)
        out[r0:r1] = torch.clamp(torch.round(av * ro), -128, 127).to(torch.int8)
    return out[:n, :hd]


def _attn_case(n, hd, heads=2, b=2, seed=0):
    rng = np.random.RandomState(seed + n + hd)
    c = heads * hd
    qkv = rng.randint(-128, 128, (b, n, 3 * c)).astype(np.int8)
    return qkv, heads, np.float32(2.0**-11), np.float32(2.0**-9), np.float32(2.0)


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("n", [5, 17, 64, 197])
@pytest.mark.parametrize("hd", [4, 8, 16, 32, 64])
def test_attention_item_replay(hd, n, lis):
    """The item replayed per (image, head), with the plan's chunks and with
    one group a chunk, equals ``lis_attention_fused_plain`` bit for bit; the
    plain version equals JAX's kernel in interpret mode, on both arms (no
    LIS-off code flips on these inputs)."""
    qkv, heads, rq, s_attn, ro = _attn_case(n, hd)
    b, c = qkv.shape[0], heads * hd
    want = attention_lis.lis_attention_fused_plain(T(qkv), heads, T(rq), T(s_attn), T(ro), lis=lis)
    sa = torch.tensor(s_attn)
    scal = (rq, s_attn, ro, *(float(x) for x in attention_lis.int_exp_consts(sa)))
    plan = attention_lis.vit_attention_plan(n, hd, lis)
    for gc in sorted({plan.gc, 1}):
        got = torch.zeros((b, n, c), dtype=torch.int8)
        for item in range(b * heads):
            img, h = divmod(item, heads)
            q, k, v = (T(qkv[img, :, w * c + h * hd:w * c + (h + 1) * hd]) for w in range(3))
            got[img, :, h * hd:(h + 1) * hd] = replay_item(q, k, v, scal, lis, gc)
        assert torch.equal(got, want)
    j = np.asarray(j_attn(qkv, heads, rq, s_attn, ro, lis=lis, interpret=True))
    d = np.abs(j.astype(np.int32) - want.numpy().astype(np.int32))
    assert int(d.max()) == 0


# ---------------------------------------------------------------------------
# (c) the layer's phase C, replayed
# ---------------------------------------------------------------------------


def _layer_args(b, n, c, heads, hid, seed):
    """A layer's numpy arguments at a narrow width: int8 codes, W4 weights,
    PoT requants, PTF residual scales (as the card tests')."""
    rng = np.random.RandomState(seed)
    i8 = lambda shape, lo=-128, hi=128: rng.randint(lo, hi, shape).astype(np.int8)  # noqa: E731
    pot = lambda k, lo, hi: (2.0 ** rng.randint(lo, hi, k)).astype(np.float32)  # noqa: E731
    ptf = lambda k, base: (base * 2.0 ** rng.randint(0, 4, k)).astype(np.float32)  # noqa: E731
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    return [i8((b, n, c)), i8((b, n, c)), i8((3 * c, c), -8, 8), pot(3 * c, -8, -6), f(rng.randn(3 * c)), heads,
            np.float32(2.0**-9), np.float32(2.0**-4), np.float32(4.0),
            i8((c, c), -8, 8), pot(c, -8, -6), f(rng.randn(c)), np.float32(2.0**-5), ptf(c, 0.011), ptf(c, 0.03),
            f(rng.randn(c)), f(rng.randn(c) * 0.1), f(np.abs(rng.randn(c)) * 0.03 + 0.01), pot(c, -1, 2),
            i8((hid, c), -8, 8), pot(hid, -10, -8), f(rng.randn(hid) * 0.5), np.float32(16.0),
            i8((c, hid), -8, 8), pot(c, -10, -8), f(rng.randn(c)), np.float32(2.0**-4), ptf(c, 0.04),
            f(rng.randn(c)), f(rng.randn(c) * 0.1), f(np.abs(rng.randn(c)) * 0.03 + 0.01), np.float32(1.0)]


def _swizzle_store(tile, rows, cols, codes):
    """codes (rows, cols) int8 into a byte tile at ``swizzle_offset``."""
    for r in range(rows):
        for col in range(cols):
            tile[layer_fused.swizzle_offset(r, col)] = int(codes[r, col]) & 0xFF


def _descriptor_read(tile, k):
    """The (64, K) A operand as the wgmma descriptors read it: K-block s
    (8 KB apart), row r at r·128, 16-byte chunk j at j ^ (r mod 8)."""
    out = np.zeros((64, -(-k // 128) * 128), np.uint8)
    for s in range(-(-k // 128)):
        for r in range(64):
            for j in range(8):
                base = s * 8192 + r * 128 + ((j ^ (r & 7)) << 4)
                out[r, 128 * s + 16 * j:128 * s + 16 * j + 16] = tile[base:base + 16]
    return torch.from_numpy(out[:, :k].view(np.int8).astype(np.int64))


def _chunked_nt(a, w):
    """Σ_k a[m,k]·w[n,k] over 128-byte K-blocks of 32-byte steps (int64:
    exact, the order the wgmma chunks take)."""
    k = a.shape[1]
    acc = torch.zeros((a.shape[0], w.shape[0]), dtype=torch.int64)
    for k0 in range(0, k, 32):
        acc += a[:, k0:k0 + 32] @ w[:, k0:k0 + 32].T.to(torch.int64)
    return acc.to(torch.int32)


def replay_phase_c(attn, xc, args):
    """Phase C per block of 64 rows: proj in 64-column chunks → the junction
    and LN2 (the junction kernel's chains, row-local) → the MLP input
    through the swizzled tile → fc1 chunks of 64 columns, GELU codes into
    the swizzled GELU tile → fc2 over it → the junction against res1 and the
    next LN."""
    (w_proj, prr, prb, smid, sprev, sres1, ln2w, ln2b, ln2o, ln2r, w_fc1, f1r, f1b, f1inv, w_fc2, f2r, f2b, smid2,
     sres2, lnnw, lnnb, lnno, lnnr) = (T(a) for a in args[9:])
    m, c = attn.shape
    hid = w_fc1.shape[0]
    pv, s1a = matmul_ln.res_ln_consts(c, "cpu", prr, prb, smid, sprev, sres1, ln2w, ln2b, ln2o, ln2r)
    f2v, s1b = matmul_ln.res_ln_consts(c, "cpu", f2r, f2b, smid2, sres1, sres2, lnnw, lnnb, lnno, lnnr)
    ho = torch.zeros((m, c), dtype=torch.int8)
    xo = torch.zeros((m, c), dtype=torch.int8)
    for m0 in range(0, m, 64):
        rows = min(64, m - m0)
        a = torch.zeros((64, c), dtype=torch.int64)
        a[:rows] = attn[m0:m0 + rows].to(torch.int64)  # TMA's zeros past M
        res = torch.zeros((64, c), dtype=torch.int8)
        res[:rows] = xc[m0:m0 + rows]
        acc = torch.cat([_chunked_nt(a, w_proj[n0:n0 + 64]) for n0 in range(0, c, 64)], dim=1)
        res1, mlp_in = matmul_ln.res_ln_epilogue_plain(acc, res, pv, s1a)
        mlp_tile = np.zeros(8192 * -(-c // 128), np.uint8)
        _swizzle_store(mlp_tile, 64, c, mlp_in.numpy())
        a1 = _descriptor_read(mlp_tile, c)
        gelu_tile = np.zeros(8192 * -(-hid // 128), np.uint8)
        for n0 in range(0, hid, 64):
            acc1 = _chunked_nt(a1, w_fc1[n0:n0 + 64])
            codes = matmul_int8.requant_epilogue_plain(acc1, f1r[n0:n0 + 64], f1b[n0:n0 + 64], f1inv, gelu=True)
            for r in range(64):
                for col in range(64):
                    gelu_tile[layer_fused.swizzle_offset(r, n0 + col)] = int(codes[r, col]) & 0xFF
        acc2 = torch.cat([_chunked_nt(_descriptor_read(gelu_tile, hid), w_fc2[n0:n0 + 64]) for n0 in range(0, c, 64)],
                         dim=1)
        res2, hn = matmul_ln.res_ln_epilogue_plain(acc2, res1, f2v, s1b)
        xo[m0:m0 + rows], ho[m0:m0 + rows] = res2[:rows], hn[:rows]
    return ho, xo


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("heads", [16, 8, 4, 2])
def test_layer_replay(heads, lis):
    """C = 64 at head_dims 4, 8, 16 and 32, hid 256, two images of 70 tokens (three
    blocks of 64 rows, the last of 12): phase A's qkv tiles, the attention
    items and phase C replayed equal ``fused_vit_layer_plain`` bit for bit,
    which equals JAX's kernel in interpret mode on both arms (no LIS-off
    flips on these inputs)."""
    b, n, c, hid = 2, 70, 64, 256
    args = _layer_args(b, n, c, heads, hid, seed=heads)
    targs = [T(a) if isinstance(a, np.ndarray) else a for a in args]
    want_h, want_x = layer_fused.fused_vit_layer_plain(*targs, lis=lis)
    h, xc, w_qkv, qr, qb = (T(a) for a in args[:5])
    m, hd = b * n, c // heads
    # A: 64 × 64 tiles of the qkv codes
    hq = torch.zeros((-(-m // 64) * 64, c), dtype=torch.int64)
    hq[:m] = h.reshape(m, c).to(torch.int64)
    qkv = torch.zeros((hq.shape[0], 3 * c), dtype=torch.int8)
    for m0 in range(0, m, 64):
        for n0 in range(0, 3 * c, 64):
            acc = _chunked_nt(hq[m0:m0 + 64], w_qkv[n0:n0 + 64])
            qkv[m0:m0 + 64, n0:n0 + 64] = matmul_int8.requant_epilogue_plain(acc, qr[n0:n0 + 64], qb[n0:n0 + 64])
    qkv = qkv[:m].reshape(b, n, 3 * c)
    # B: the items, in the layer plan's chunks
    sa = torch.tensor(args[7])
    scal = (args[6], args[7], args[8], *(float(x) for x in attention_lis.int_exp_consts(sa)))
    gc = layer_fused.layer_plan(b, n, c, heads, hid, lis).gc
    attn = torch.zeros((b, n, c), dtype=torch.int8)
    for item in range(b * heads):
        img, hh = divmod(item, heads)
        q, k, v = (qkv[img, :, w * c + hh * hd:w * c + (hh + 1) * hd] for w in range(3))
        attn[img, :, hh * hd:(hh + 1) * hd] = replay_item(q, k, v, scal, lis, gc)
    assert torch.equal(attn, attention_lis.lis_attention_fused_plain(qkv, heads, *map(T, args[6:9]), lis=lis))
    # C
    ho, xo = replay_phase_c(attn.reshape(m, c), xc.reshape(m, c), args)
    assert torch.equal(ho.reshape(b, n, c), want_h) and torch.equal(xo.reshape(b, n, c), want_x)
    assert len(torch.unique(want_h)) > 50
    jh, jx = map(np.asarray, j_layer(*args[:5], heads, *args[6:], lis=lis, interpret=True))
    assert n_diff(jh, want_h) == 0 and n_diff(jx, want_x) == 0

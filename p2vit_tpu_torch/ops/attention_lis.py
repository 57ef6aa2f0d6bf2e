"""int8 attention with Log-Int-Softmax or the LIS-off fp32 softmax
(counterpart of ``p2vit_tpu/ops/attention_lis.py``): the ViT qkv projection
+ attention ``lis_attention_qkv_fused``, the attention over (B, N, 3C) qkv
codes ``lis_attention_fused`` and over split q/k/v ``lis_attention``, and
the Swin windowed ``swin_lis_attention``.

Per image and head: qkv codes = clip(round(h·W_qkvᵀ·r + b)); scores
acc = q·kᵀ (int32) → attn codes clip(round(acc·rq)); LIS: I-BERT int-exp,
round(Σ/exp), ⌊log2⌋ with ties up → weight 2^-q (q ≤ 15) or 0 on overflow;
av = Σ_j w_j·v_j; out = clip(round(av·ro)).

Two sums are made exact and order-free, in the kernels AND the plain versions:

* ``exp_sum`` is summed exactly and rounded to float32 once
  (``exact_sum_f32``). Its terms reach c_int·2^32 ≈ 2.8·2^32/s² (the row
  maximum's): past 2^24, so the float32 sum of the JAX twin depends on its
  order, and past 2^63 for s ≤ 2^-11 (the scale random-init DeiT-S gets),
  so not even int64 holds it. Each term is split into 32-bit limbs summed
  in int64; exact while s_attn ≥ 2^-20 (``check_lis_scale``). The JAX sum
  can differ by an ulp, which flips a LIS code where round(Σ/exp) lands on
  a .5 or 1.5·2^k edge.
* attn@v is the paper's shift-accumulate: Σ_j v_j·2^(15−q_j) in int32, then
  ×2^-15. Exact while |av| < 2^9 (|av_int| < 2^24): with |v| ≤ 128 that
  holds while the LIS weights of a row sum below 4; they sum to about 1.
  The JAX twin's float32 product is exact in the same range, so the two
  agree bit for bit there.

LIS off (the reference's ``Config(lis=False)``): logits = code·s, e =
exp(logit − rowmax) through float64 rounded once (``fastmath.exp_rn``), the
row sum S and attn@v Σ_j p_j·v_j in float64, each rounded once to float32,
p = e / S. Each product p_j·v_j of a float32 and an int8 is exact in
float64, and both float64 sums are exact while every term of a row lies
within ~2^20 of the row's largest (24-bit mantissas, at most 256 terms of
magnitude ≤ 2^7). Beyond that the order can change only the last float64
bit, which reaches the float32 result only on an exact rounding tie. So the
kernels sum in any order and the plain version is a plain ``torch``
expression, and the two agree bit for bit. JAX sums in float32 in its own
order and its float32 ``exp`` is not correctly rounded, so against JAX the
LIS-off arm is held to |Δcode| ≤ 1 on a stated share of codes.

CUDA kernels (``csrc/attention_lis.cu``, N ≤ 256) replace the Pallas
kernels ``lis_attention_qkv_fused`` (``_qkv_fused_kernel``, head_dim 64),
``lis_attention_fused`` (``_fused_kernel``, head_dim 1, 2, 4, 8, 16, 32 or 64) and
``lis_attention`` (``_kernel``, any head_dim ≤ 64).

The qkv-fused kernel runs one thread-block cluster per (image, head) of
ceil(N/64) CTAs (``qkv_cluster_plan``). CTA r computes the head's q/k/v
codes of token rows [64r, 64r + 64) with ``mma.sync`` int8 into its own
shared memory; the CTAs then copy the whole head's K and V (V transposed)
and their query rows out of each other's shared memory (distributed shared
memory), so no qkv code goes through HBM. Each CTA attends its share of the
16-row query groups: q·kᵀ on int8 ``mma.sync`` (exact int32 sums, so equal
to any order), ``p2v::lis_row`` per row, and attn@v on u8·s8 ``mma.sync``
over the LIS weights split into two byte planes, w = 256·hi + lo with
hi = w >> 8 and lo = w & 0xFF both ≤ 128, which keeps the integer sum
exact. LIS off keeps ``p2v::softmax_row`` and the scalar float64 attn@v.
What bounds it on the H100: the per-row LIS chain, about half of a CTA's
time, and the qkv GEMM on ``mma.sync``, about a third (``phase_ns``); LIS
off, the float64 attn@v. The other two kernels run one (image, head) item
per CTA on the same bodies (``csrc/attention_rows.cuh``, which the fused
encoder layer's attention phase runs too): the item's q/k/v rows staged by
``cp.async`` with the keys padded to 32 and the head_dim to 32 or 64 by
zero codes, q·kᵀ, ``p2v::lis_row`` into the hi/lo planes and attn@v on
``mma.sync``; LIS off ``p2v::softmax_row`` and the float64 attn@v in key
order. The query groups go in chunks of ``gc`` so that as many CTAs as
shared memory allows share an SM (``vit_attention_plan``); output columns
past the true head_dim are never written.

CUDA kernels (``csrc/swin_attention.cu``) replace the Pallas kernels
``p2vit_tpu/ops/attention_lis.py:swin_lis_attention`` (``_swin_kernel`` →
``_swin_head_loop``), on (B·nW, 49, 3C) window panels with d = 32, and
``swin_lis_attention_folded`` (``_swin_folded_kernel``), on the (B, res,
res, 3C) raster qkv grid: per head, q·kᵀ → attn1 codes → + rel-pos bias →
·1/s2 round/clip (qact2 codes) → + the shift mask/s2, unrounded → LIS or
the fp softmax at s2 → @v → qact3 codes. The two entries share one body
and differ only in the address of a window's rows: the folded one reads and
writes raster pixels moved by the block's cyclic shift, so window_partition,
window_reverse and the two rolls never run as copies. A persistent grid
(``swin_attention_plan``) walks the (window, head) items head-major, then
window, each CTA taking its next item from a counter in device memory: it
stages bias[h] in shared memory when the head changes, prefetches the next
item's q/k/v rows and mask by ``cp.async``, runs q·kᵀ and the LIS attn@v (hi/lo weight planes)
on int8 ``mma.sync`` and ``p2v::lis_row`` per row; LIS off keeps
``p2v::softmax_row`` and the float64 attn@v in key order, over v codes
converted to float64 once per item. The JAX kernels pad rows 49 → 56 and
keys to 64 and park padded keys at −2^30; the CUDA kernel pads rows and
keys to 64 with zero codes and weight 0, the plain versions do not pad.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch, library
from .fastmath import exp2i, exp_rn, floor_log2i
from .matmul_int8 import int8_matmul_requant_plain

EXP_N = 32  # range-reduction steps of the int-exp
_COEF = (0.35815147, 0.96963238, 1.0)  # int-exp polynomial
MIN_LIS_SCALE = 2.0**-20  # exact_sum_f32's limbs fit int64 above this attn scale
AV_SHIFT = 15  # LIS weights 2^-q, q ≤ 15, as integers 2^(15-q)


def check_lis_scale(attn_scale) -> None:
    """Raise if the LIS input scale is below the exact ``exp_sum`` bound
    (each exp term ≤ (1/c0)/s²·2^32 < 2^74, its high limb < 2^42)."""
    if float(attn_scale) < MIN_LIS_SCALE:
        raise ValueError(
            f"LIS attention scale {float(attn_scale)} < 2^-20: the exact exp_sum "
            f"limbs could overflow; this scale is outside the ported kernel's range")


def exact_sum_f32(t: torch.Tensor) -> torch.Tensor:
    """Σ over the last axis (keepdim) of non-negative integer-valued float32
    terms, exact, rounded once to float32 (round to nearest even).

    hi = ⌊t·2^-32⌋ and lo = t − hi·2^32 are exact; their int64 sums are
    exact in any order. V = S_hi·2^32 + S_lo: below 2^63 it converts
    directly; above, S_lo can only act as a sticky bit, so V rounds as
    (2·S_hi + [S_lo ≠ 0])·2^31. ``csrc/attention_lis.cu`` does the same."""
    hi_f = torch.floor(t * 2.0**-32)
    lo = (t - hi_f * 2.0**32).to(torch.int64).sum(dim=-1, keepdim=True)
    hi = hi_f.to(torch.int64).sum(dim=-1, keepdim=True) + (lo >> 32)
    lo = lo & 0xFFFFFFFF
    small = ((hi << 32) + lo).to(torch.float32)
    big = ((hi << 1) | (lo != 0).to(torch.int64)).to(torch.float32) * 2.0**31
    return torch.where(hi < 2**31, small, big)


def _full(v, t):
    return torch.full_like(t, v)


def int_exp_consts(s_attn: torch.Tensor):
    """x0_int, b_int, c_int of the int-exp for scale ``s_attn`` (0-d float32),
    as the JAX twin forms them: float32 constants divided by s."""
    c0, c1, c2 = _COEF
    x0_int = torch.floor(_full(-0.6931, s_attn) / s_attn)
    b_int = torch.floor(_full(c1 / c0, s_attn) / s_attn)
    c_int = torch.floor(_full(c2 / c0, s_attn) / (s_attn * s_attn))
    return x0_int, b_int, c_int


def lis_codes(attn_c: torch.Tensor, s_attn: torch.Tensor) -> torch.Tensor:
    """LIS exponent per score from attention codes (last axis = keys): int32
    q with weight 2^-q; q ≥ 2^lis_bits means weight 0."""
    x0_int, b_int, c_int = int_exp_consts(s_attn)
    x_int = attn_c - attn_c.amax(dim=-1, keepdim=True)
    x_int = torch.maximum(x_int, EXP_N * x0_int)
    q = torch.floor(x_int / x0_int)
    r = x_int - x0_int * q
    poly = r * (r + b_int) + c_int
    exp_int = torch.clamp(torch.floor(poly * exp2i(EXP_N - q.to(torch.int32))), min=0.0)
    exp_sum = exact_sum_f32(exp_int)
    softmax_out = torch.round(exp_sum / exp_int)
    big = floor_log2i(softmax_out)
    tie = softmax_out >= 1.5 * exp2i(big)
    return big + tie.to(torch.int32)


def _scores(q_q, k_q, score_requant):
    """int8 q·kᵀ (exact, float64) → attention codes clip(round(acc·rq))."""
    acc = (q_q.to(torch.float64) @ k_q.to(torch.float64).transpose(-1, -2)).to(torch.float32)
    return torch.clamp(torch.round(acc * score_requant), -128, 127)


def _attend(scores, v_q, s_attn, out_requant, lis_bits, lis):
    """Softmax of score codes ``scores`` (scale ``s_attn``) @ v codes →
    clip(round(av·ro)) int8. LIS: integer weights 2^(15−q) and the exact
    shift-accumulate; otherwise the fp32 softmax of the dequantized scores
    with float64 sums, each rounded once (module docstring)."""
    if lis:
        if lis_bits > 4:
            raise ValueError(f"lis_bits={lis_bits}: the LIS codes are uint4 (lis_bits <= 4)")
        big = lis_codes(scores, s_attn)
        keep = big < 2**lis_bits
        w_int = torch.where(keep, exp2i(AV_SHIFT - big), torch.zeros_like(scores))
        av_int = w_int.to(torch.float64) @ v_q.to(torch.float64)  # exact integers
        av = av_int.to(torch.float32) * 2.0**-AV_SHIFT
    else:
        logits = scores * s_attn
        e = exp_rn(logits - logits.amax(dim=-1, keepdim=True))
        p = e / e.to(torch.float64).sum(dim=-1, keepdim=True).to(torch.float32)
        av = (p.to(torch.float64) @ v_q.to(torch.float64)).to(torch.float32)
    ro = torch.as_tensor(out_requant, dtype=torch.float32, device=scores.device)
    return torch.clamp(torch.round(av * ro), -128, 127).to(torch.int8)


HEAD_DIM = 64  # the qkv-fused kernel's head_dim (every ViT/DeiT in the zoo)
MAX_N = 256  # tokens the ViT attention kernels take (197 at 224²/16²)
MAX_HEAD_DIM = 64  # the widest head_dim of the per-item kernels (lis_attention takes any d up to it)
# lis_attention_fused's head_dims: those JAX's assert (d % 128 == 0 or 128 % d == 0) admits up to 64,
# the divisors of 128
FUSED_HEAD_DIMS = (1, 2, 4, 8, 16, 32, 64)
MAX_SMEM = 232_448  # dynamic shared memory one CTA may use on the H100
SM_SMEM = 233_472  # an SM's shared memory, 1 KB of it reserved per CTA


def vit_attention_layout(n: int, hd: int, lis: bool = True, stages: int = 1, gc: int = 1) -> dict:
    """Byte offsets of the per-item attention body's shared memory
    (``csrc/attention_rows.cuh`` ``layout``): ``stages`` stage buffers of
    the item's q rows (16·⌈N/16⌉), k and v rows (⌈N/32⌉·32), q/k rows
    HDP + 16 bytes apart, v rows dense; then, with LIS, V transposed; the
    score / hi plane and, with LIS, the lo plane, 16·gc rows of kpad + 16
    bytes each. HDP: the head_dim padded to 32 or 64."""
    hdp = 32 if hd <= 32 else 64
    qld, kpad, ng = hdp + 16, -(-n // 32) * 32, -(-n // 16)
    vld = kpad + 16
    k_off = 16 * ng * qld
    v_off = k_off + kpad * qld
    stage = v_off + kpad * hdp
    vt = stages * stage
    s_off = vt + (hdp * vld if lis else 0)
    lo = s_off + 16 * gc * vld
    total = lo + (16 * gc * vld if lis else 0)
    return dict(hdp=hdp, qld=qld, kpad=kpad, groups=ng, vld=vld, k_off=k_off, v_off=v_off, stage=stage, vt=vt,
                s=s_off, lo=lo, total=total)


def vit_attention_gc(n: int, hd: int, lis: bool, stages: int, budget: int, force: int = 0) -> int:
    """Query groups a chunk (``csrc/attention_rows.cuh`` ``fit_gc``): the
    fewest chunks whose layout fits ``budget``, their groups balanced;
    ``force`` > 0 takes min(force, groups); 0 where one group does not fit."""
    ng = -(-n // 16)
    if force > 0:
        return min(force, ng)
    most = next((g for g in range(ng, 0, -1) if vit_attention_layout(n, hd, lis, stages, g)["total"] <= budget), 0)
    if most == 0:
        return 0
    chunks = -(-ng // most)
    return -(-ng // chunks)


@dataclasses.dataclass(frozen=True)
class VitAttentionPlan:
    """The launch of ``lis_attention_fused`` / ``lis_attention`` at N tokens
    and head_dim hd (``csrc/attention_lis.cu`` ``launch_rows``): one item
    per CTA of 256 threads, one stage buffer."""

    hdp: int  # head_dim padded to 32 or 64
    kpad: int  # keys padded to a multiple of 32
    groups: int  # 16-row query groups
    gc: int  # groups a chunk
    smem_bytes: int  # dynamic shared memory per CTA

    @property
    def chunks(self) -> int:
        return -(-self.groups // self.gc)


def vit_attention_plan(n: int, hd: int, lis: bool = True, gc: int = 0) -> VitAttentionPlan:
    """The per-item kernels' plan (``csrc/attention_lis.cu`` ``rows_gc``):
    the most CTAs an SM, 4, 3 or 2, whose shared memory (``SM_SMEM``/k −
    1 KB each) holds one query group a chunk, then the fewest balanced
    chunks within it; or ``gc`` > 0 groups a chunk (a measurement hook, up
    to a whole CTA's shared memory). Raises where the kernels do not run
    (N > 256, head_dim > 64)."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"attention kernel needs 1 <= N <= {MAX_N}; got N={n}")
    if not 1 <= hd <= MAX_HEAD_DIM:
        raise ValueError(f"attention kernel needs head_dim <= {MAX_HEAD_DIM}; got head_dim {hd}")
    budgets = [SM_SMEM // k - 1024 for k in (4, 3, 2)] + [MAX_SMEM]
    g = vit_attention_gc(n, hd, lis, 1, MAX_SMEM, gc) if gc > 0 else next(
        (g for g in (vit_attention_gc(n, hd, lis, 1, b) for b in budgets) if g > 0), 0)
    lay = vit_attention_layout(n, hd, lis, 1, g)
    if g == 0 or lay["total"] > MAX_SMEM:
        raise ValueError(f"attention kernel needs {lay['total']} B of shared memory at N={n}, gc={gc}")
    return VitAttentionPlan(lay["hdp"], lay["kpad"], lay["groups"], g, lay["total"])


def vit_attention_info(n: int, hd: int, lis: bool = True, gc: int = 0) -> dict:
    """The built per-item kernel's launch facts, from the CUDA runtime:
    padded head_dim, groups a chunk, shared memory, registers and spill
    bytes per thread, CTAs per SM. Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * 6)()
    rc = lib.p2v_vit_attention_info(int(n), int(hd), int(bool(lis)), int(gc), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_vit_attention_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    return dict(zip(("hdp", "gc", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm"), list(info)))


def _check_lis_bits(lis, lis_bits):
    if lis and lis_bits != 4:
        raise ValueError(f"the CUDA attention kernels implement LIS with uint4 codes "
                         f"(lis_bits=4); got lis_bits={lis_bits}")


def _vit_scalars(score_requant, attn_scale, out_requant, device):
    """The ViT kernels' scalars: rq, s_attn, ro, x0_int, b_int, c_int."""
    sa = torch.as_tensor(attn_scale, dtype=torch.float32, device=device)
    return f32_scalars(score_requant, sa, out_requant, *int_exp_consts(sa), device=device)


def lis_attention_plain(q_q, k_q, v_q, score_requant, attn_scale, out_requant,
                        lis_bits=4, lis=True):
    """Attention on (..., N, d) int8 q/k/v codes → (..., N, d) int8 codes;
    the plain version of ``lis_attention``."""
    sa = torch.as_tensor(attn_scale, dtype=torch.float32, device=q_q.device)
    return _attend(_scores(q_q, k_q, score_requant), v_q, sa, out_requant, lis_bits, lis)


def _split_operands(q_q, k_q, v_q, lis, lis_bits, gc=0):
    """The split kernel's operand checks; returns (BH, N, d)."""
    bh, n, d = q_q.shape
    for name, t in (("q_q", q_q), ("k_q", k_q), ("v_q", v_q)):
        check_cuda_operand(t, name, torch.int8, (bh, n, d))
    _check_lis_bits(lis, lis_bits)
    vit_attention_plan(n, d, lis, gc)
    return bh, n, d


def lis_attention(q_q, k_q, v_q, score_requant, attn_scale, out_requant, lis_bits=4, lis=True):
    """Attention per (batch·head) over split codes.

    Args:
      q_q/k_q/v_q: (BH, N, d) int8 codes of the qact1 node.
      score_requant: s_qkv²·head_scale/s_attn; attn_scale: s_attn (the
        softmax input scale); out_requant: s_qkv/s_out.
    Returns (BH, N, d) int8 codes of the qact2 node. CPU tensors take the
    plain version; CUDA tensors launch the kernel (d ≤ 64, N ≤ 256) or raise.
    """
    dev = device_of(q_q, k_q, v_q)
    if dev.type == "cpu":
        return lis_attention_plain(q_q, k_q, v_q, score_requant, attn_scale, out_requant,
                                   lis_bits, lis)
    bh, n, d = _split_operands(q_q, k_q, v_q, lis, lis_bits)
    out = torch.empty((bh, n, d), dtype=torch.int8, device=dev)
    launch("p2v_lis_attention", q_q, k_q, v_q,
           _vit_scalars(score_requant, attn_scale, out_requant, dev), out, bh, n, d, int(bool(lis)))
    lis_attention.launches += 1
    return out


def lis_attention_forced(q_q, k_q, v_q, score_requant, attn_scale, out_requant, lis_bits=4, lis=True, *, gc):
    """``lis_attention`` on CUDA tensors with ``gc`` query groups a chunk
    (``vit_attention_plan``'s hook); not counted as a launch."""
    bh, n, d = _split_operands(q_q, k_q, v_q, lis, lis_bits, gc)
    out = torch.empty((bh, n, d), dtype=torch.int8, device=q_q.device)
    launch("p2v_lis_attention_forced", q_q, k_q, v_q,
           _vit_scalars(score_requant, attn_scale, out_requant, q_q.device), out, bh, n, d, int(bool(lis)), gc)
    return out


lis_attention.launches = 0


def _split_heads(qkv, num_heads):
    """(B, N, 3C) → q, k, v of (B, H, N, d)."""
    b, n, c3 = qkv.shape
    return qkv.reshape(b, n, 3, num_heads, c3 // (3 * num_heads)).permute(2, 0, 3, 1, 4)


def _merge_heads(av):
    """(B, H, N, d) → (B, N, H·d)."""
    b, h, n, d = av.shape
    return av.permute(0, 2, 1, 3).reshape(b, n, h * d)


def lis_attention_fused_plain(qkv_q, num_heads, score_requant, attn_scale, out_requant,
                              lis_bits=4, lis=True):
    """Plain PyTorch version of the kernel."""
    q, k, v = _split_heads(qkv_q, num_heads)
    return _merge_heads(lis_attention_plain(q, k, v, score_requant, attn_scale, out_requant,
                                            lis_bits, lis))


def _fused_operands(qkv_q, num_heads, lis, lis_bits, gc=0):
    """The fused kernel's operand checks; returns (B, N, C)."""
    b, n, c3 = qkv_q.shape
    c = c3 // 3
    check_cuda_operand(qkv_q, "qkv_q", torch.int8)
    _check_lis_bits(lis, lis_bits)
    if c3 != 3 * c or c % num_heads or c // num_heads not in FUSED_HEAD_DIMS or n > MAX_N:
        raise ValueError(f"attention kernel needs head_dim in {FUSED_HEAD_DIMS} and N <= {MAX_N}; "
                         f"got C={c}, heads={num_heads}, N={n}")
    vit_attention_plan(n, c // num_heads, lis, gc)
    return b, n, c


def lis_attention_fused(qkv_q, num_heads, score_requant, attn_scale, out_requant,
                        lis_bits=4, lis=True):
    """Attention over the (B, N, 3C) fused-qkv codes: the heads are sliced
    inside the kernel, so no head split or merge is materialized.

    Args as ``lis_attention``. Returns (B, N, C) int8 codes of the qact2
    node. CPU tensors take the plain version; CUDA tensors launch the kernel
    (head_dim 1, 2, 4, 8, 16, 32 or 64, N ≤ 256) or raise.
    """
    dev = qkv_q.device
    if dev.type == "cpu":
        return lis_attention_fused_plain(qkv_q, num_heads, score_requant, attn_scale,
                                         out_requant, lis_bits, lis)
    b, n, c = _fused_operands(qkv_q, num_heads, lis, lis_bits)
    out = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    launch("p2v_lis_attention_fused", qkv_q,
           _vit_scalars(score_requant, attn_scale, out_requant, dev), out, b, n, c, num_heads,
           int(bool(lis)))
    lis_attention_fused.launches += 1
    return out


def lis_attention_fused_forced(qkv_q, num_heads, score_requant, attn_scale, out_requant, lis_bits=4, lis=True,
                               *, gc):
    """``lis_attention_fused`` on CUDA tensors with ``gc`` query groups a
    chunk (``vit_attention_plan``'s hook); not counted as a launch."""
    b, n, c = _fused_operands(qkv_q, num_heads, lis, lis_bits, gc)
    out = torch.empty((b, n, c), dtype=torch.int8, device=qkv_q.device)
    launch("p2v_lis_attention_fused_forced", qkv_q,
           _vit_scalars(score_requant, attn_scale, out_requant, qkv_q.device), out, b, n, c, num_heads,
           int(bool(lis)), gc)
    return out


lis_attention_fused.launches = 0


def lis_attention_qkv_fused_plain(h_q, w_q, requant_vec, bias_vec, num_heads,
                                  score_requant, attn_scale, out_requant,
                                  lis_bits=4, lis=True):
    """Plain PyTorch version of the kernel."""
    b, n, c_in = h_q.shape
    qkv = int8_matmul_requant_plain(h_q.reshape(-1, c_in), w_q, requant_vec, bias_vec)
    return lis_attention_fused_plain(qkv.reshape(b, n, -1), num_heads, score_requant, attn_scale,
                                     out_requant, lis_bits, lis)


ROWS_PER_CTA = 64  # token rows whose q/k/v codes one CTA of the cluster computes
QGROUP = 16  # query rows per MMA row tile
GEMM_STAGE_BYTES = 2 * (64 + 3 * HEAD_DIM) * 80  # Gemm<64, 192>'s two cp.async stages


@dataclasses.dataclass(frozen=True)
class QkvClusterPlan:
    """The qkv-fused kernel's launch for N tokens (``csrc/attention_mma.cuh``
    ``QkvPlan``, which the kernel computes itself from N)."""

    cluster: int  # CTAs per (image, head) cluster, ceil(N/64)
    groups: tuple  # (first 16-row query group, number of groups) of each CTA
    kpad: int  # keys padded to a multiple of 32 (the MMA depth), zeros past N
    smem_bytes: int  # dynamic shared memory per CTA


def qkv_cluster_plan(n: int, c_in: int) -> QkvClusterPlan:
    """Cluster size, query groups per CTA and shared memory of the
    qkv-fused kernel at N tokens and C_in input channels; raises where the
    kernel does not take them (N > 256, C_in % 16, shared memory).

    The ceil(N/16) query groups are balanced across the cluster (4/3/3/3 at
    N = 197). Shared memory: the CTA's own q/k/v tiles (3·64·64 B), then K
    (kpad rows of 80 B), V transposed (64 rows of kpad + 16 B), the CTA's
    q rows (80 B each) and two planes of scores and weights (kpad + 16 B a
    row); the own tiles and what follows overlay the GEMM's stages."""
    if not 1 <= n <= MAX_N:
        raise ValueError(f"qkv-fused attention kernel needs 1 <= N <= {MAX_N}; got N={n}")
    if c_in % 16:
        raise ValueError(f"qkv-fused attention kernel needs C_in % 16 == 0; got C_in={c_in}")
    cluster = -(-n // ROWS_PER_CTA)
    groups = -(-n // QGROUP)
    kpad = -(-n // 32) * 32
    vld = kpad + 16
    rows = QGROUP * -(-groups // cluster)
    own = 3 * ROWS_PER_CTA * HEAD_DIM
    smem = max(GEMM_STAGE_BYTES,
               own + kpad * (HEAD_DIM + 16) + HEAD_DIM * vld + rows * (HEAD_DIM + 16) + 2 * rows * vld)
    if smem > MAX_SMEM:
        raise ValueError(f"qkv-fused attention kernel needs {smem} B of shared memory per CTA "
                         f"at N={n}, above the card's {MAX_SMEM}")
    q, rem = divmod(groups, cluster)
    spans = tuple((r * q + min(r, rem), q + (1 if r < rem else 0)) for r in range(cluster))
    return QkvClusterPlan(cluster, spans, kpad, smem)


def qkv_kernel_info(n: int, lis: bool = True) -> dict:
    """The built qkv-fused kernel's launch facts at N tokens, from the CUDA
    runtime: CTAs per cluster, shared memory per CTA, registers and spill
    bytes per thread, the clusters the card can hold at once and CTAs per SM.
    Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * 6)()
    rc = lib.p2v_lis_attention_qkv_info(int(n), int(bool(lis)), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_lis_attention_qkv_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    keys = ("cluster", "smem_bytes", "registers", "spill_bytes", "max_active_clusters", "ctas_per_sm")
    return dict(zip(keys, list(info)))


QKV_PHASES = ("qkv GEMM", "K/V/q copy", "scores", "LIS weights", "attn@v")


def lis_attention_qkv_fused(h_q, w_q, requant_vec, bias_vec, num_heads,
                            score_requant, attn_scale, out_requant,
                            lis_bits=4, lis=True, phase_ns=None):
    """qkv projection + attention over the attention input codes.

    Args:
      h_q: (B, N, C_in) int8 codes (qact0 node). w_q: (3C, C_in) int8.
      requant_vec/bias_vec: (3C,) float32 = s_act·s_w/s_qact1, bias/s_qact1.
      score_requant: s_qact1²·head_scale/s_attn; attn_scale: s_attn (the
        softmax input scale); out_requant: s_qact1/s_out.
    Returns (B, N, C) int8 codes of the qact2 node, bit for bit those of
    ``int8_matmul_requant`` followed by ``lis_attention_fused``. CPU tensors
    take the plain version; CUDA tensors launch the kernel (head_dim 64,
    C_in % 16 == 0, N ≤ 256; ``qkv_cluster_plan``) or raise. w_q may be a
    tensor-parallel shard's, with C_out = 64·num_heads ≠ C_in.
    ``phase_ns``: a (6,) int64 CUDA tensor that receives the %globaltimer
    (ns) of one CTA (rank 0 of the middle cluster) at its start and after
    each of
    ``QKV_PHASES`` (LIS off: the softmax and attn@v rows end at the fifth
    stamp, and the sixth repeats it); a measurement hook.
    """
    dev = device_of(h_q, w_q)
    if dev.type == "cpu":
        return lis_attention_qkv_fused_plain(h_q, w_q, requant_vec, bias_vec, num_heads,
                                             score_requant, attn_scale, out_requant,
                                             lis_bits, lis)
    b, n, c_in = h_q.shape
    c3 = w_q.shape[0]
    c = c3 // 3
    check_cuda_operand(h_q, "h_q", torch.int8)
    check_cuda_operand(w_q, "w_q", torch.int8, (c3, c_in))
    _check_lis_bits(lis, lis_bits)
    if c3 != 3 * c or c != HEAD_DIM * num_heads:
        raise ValueError(f"attention kernel needs head_dim {HEAD_DIM}; got C={c}, heads={num_heads}")
    qkv_cluster_plan(n, c_in)
    scal = _vit_scalars(score_requant, attn_scale, out_requant, dev)
    r = f32_vec(requant_vec, c3, dev)
    bias = f32_vec(bias_vec, c3, dev)
    out = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    if phase_ns is None:
        launch("p2v_lis_attention_qkv_fused", h_q, w_q, r, bias, scal, out,
               b, n, c_in, c, num_heads, int(bool(lis)))
    else:
        check_cuda_operand(phase_ns, "phase_ns", torch.int64, (6,))
        launch("p2v_lis_attention_qkv_fused_timed", h_q, w_q, r, bias, scal, out,
               b, n, c_in, c, num_heads, int(bool(lis)), phase_ns)
    lis_attention_qkv_fused.launches += 1
    return out


lis_attention_qkv_fused.launches = 0


# ---------------------------------------------------------------------------
# Swin windowed attention
# ---------------------------------------------------------------------------

SWIN_HEAD_DIM = 32  # the kernel's head_dim (every Swin in the zoo); smaller ones are zero-padded to it
SWIN_MAX_N = 64  # tokens per window the kernel takes (49 for 7×7 windows)
_SWIN_QLD = SWIN_HEAD_DIM + 16  # bytes per staged q / k row
_SWIN_STAGE = 2 * SWIN_MAX_N * _SWIN_QLD + SWIN_MAX_N * SWIN_HEAD_DIM  # one item's q, k, v rows
_SWIN_WLD = SWIN_MAX_N + 16  # bytes per row of V transposed and of the score / hi plane
_SWIN_OFF_ROWS = 2  # LIS off: rows a warp sums side by side
SWIN_PHASES = ("q/k/v and mask wait", "bias, V transpose", "scores", "LIS weights", "attn@v")
SWIN_PHASES_LISOFF = ("q/k/v and mask wait", "bias, v to float64", "scores", "softmax and attn@v")


def swin_attention_smem(n: int, lis: bool = True) -> int:
    """Shared memory of one CTA of the Swin kernel at N tokens
    (``csrc/swin_attention.cu`` ``layout``): two rows of token indices, two
    stage buffers of q, k, v rows and two of masks, the score/hi plane and
    bias[h] (N² float32 each, 16-byte rounded); LIS: V transposed (the lo
    plane lies over the item's spent q/k rows); LIS off: v as float64 and
    each warp's rows of p as float64."""
    nn = -(-n * n * 4 // 16) * 16
    end = 2 * SWIN_MAX_N * 4 + 2 * _SWIN_STAGE + 3 * nn + SWIN_MAX_N * _SWIN_WLD
    if lis:
        return end + SWIN_HEAD_DIM * _SWIN_WLD
    return end + -(-n * SWIN_HEAD_DIM * 8 // 16) * 16 + 8 * _SWIN_OFF_ROWS * SWIN_MAX_N * 8


@dataclasses.dataclass(frozen=True)
class SwinAttentionPlan:
    """The Swin kernel's launch (``csrc/swin_attention.cu``, which computes
    it itself): a persistent grid whose CTAs take (window, head) items,
    ordered head-major, then window, from a counter in device memory, each
    CTA one item ahead of the one it computes."""

    windows: int  # W: B·nW windows
    n_windows: int  # windows per image: window w takes mask[w mod nW]
    heads: int
    n: int  # tokens per window
    grid: int  # CTAs: min(items, SMs × CTAs per SM), or the forced grid
    smem_bytes: int  # dynamic shared memory per CTA

    @property
    def items(self) -> int:
        return self.windows * self.heads

    def item(self, it: int) -> tuple:
        """(head, window) of item ``it`` = head·W + window."""
        return divmod(it, self.windows)

    def walk(self):
        """(CTA, head, window) of every item in the order the counter hands
        them out when the CTAs take them at one pace (item c + k·grid is CTA
        c's k-th); on the card the order between CTAs is the race's."""
        for it in range(self.items):
            yield (it % self.grid, *self.item(it))

    def bias_stagings(self) -> int:
        """bias[h] stagings over the grid in ``walk``'s order: a CTA stages it
        when its next item's head differs from its last."""
        last, n = {}, 0
        for c, h, _ in self.walk():
            n += last.get(c) != h
            last[c] = h
        return n

    @property
    def warp_tiles(self) -> tuple:
        """(scores, attn@v) MMA tiles each of the 8 warps takes per item at
        most: (16-row group, 8-key tile) and (group, 8-dim tile) pairs."""
        groups, kpad = -(-self.n // 16), -(-self.n // 32) * 32
        return -(-groups * kpad // 8 // 8), -(-groups * SWIN_HEAD_DIM // 8 // 8)


def swin_attention_plan(windows: int, n_windows: int, heads: int, n: int, sms: int = 132,
                        ctas_per_sm: int = 4, grid: int = 0, lis: bool = True) -> SwinAttentionPlan:
    """The Swin kernel's plan: ``windows`` windows of N tokens, ``n_windows``
    per image (the mask's period), ``heads`` heads, on ``sms`` SMs holding
    ``ctas_per_sm`` CTAs each (``swin_attention_info`` reads both on the
    card; the H100 holds 4 at N = 49 with LIS, 3 without). ``grid`` > 0
    forces the grid (a measurement hook). Raises where the kernel does not
    run (N > 64, shared memory)."""
    if not 1 <= n <= SWIN_MAX_N:
        raise ValueError(f"Swin attention kernel needs 1 <= N <= {SWIN_MAX_N}; got N={n}")
    smem = swin_attention_smem(n, lis)
    if smem > MAX_SMEM:
        raise ValueError(f"Swin attention kernel needs {smem} B of shared memory, above {MAX_SMEM}")
    items = windows * heads
    return SwinAttentionPlan(windows, n_windows, heads, n, min(items, grid if grid > 0 else sms * ctas_per_sm),
                             smem)


def swin_attention_info(n: int, lis: bool = True, fold: bool = False) -> dict:
    """The built Swin kernel's launch facts at N tokens, from the CUDA
    runtime: shared memory per CTA, registers and spill bytes per thread,
    CTAs per SM and SMs. Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * 5)()
    rc = lib.p2v_swin_attention_info(int(n), int(bool(lis)), int(bool(fold)), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_swin_attention_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    return dict(zip(("smem_bytes", "registers", "spill_bytes", "ctas_per_sm", "sms"), list(info)))


def swin_attention_scalars(score_requant, attn_scale, s2, out_requant, device, lis=True):
    """The kernel's scalars (rq, s1, 1/s2, ro, x0_int, b_int, c_int, s2); the
    softmax runs at the qact2 scale s2, which with LIS must clear the
    exact-sum bound. That check reads s2 on the host, so it runs here only
    for a host value (a number or a CPU tensor): for a serving state on the
    card, ``serving_swin.serving_forward`` checks the smallest s2 that
    ``convert`` recorded, with no read from the card per call."""
    if lis and not (isinstance(s2, torch.Tensor) and s2.device.type != "cpu"):
        check_lis_scale(s2)
    s2t = torch.as_tensor(s2, dtype=torch.float32, device=device)
    inv_s2 = torch.ones_like(s2t) / s2t
    return f32_scalars(score_requant, attn_scale, inv_s2, out_requant, *int_exp_consts(s2t), s2t,
                       device=device)


def _swin_windows_plain(qkv_q, bias, mask, num_heads, n_windows, score_requant, attn_scale, s2,
                        out_requant, lis_bits, lis):
    """The windowed attention over (W, N, 3C) panels, shared by both plain
    versions. The folded one calls this and not ``swin_lis_attention_plain``,
    so that a recorder of the panel version's calls (``chip_smoke.py``, the
    launch-count tests) sees the panel kernel's calls only."""
    w, n, c3 = qkv_q.shape
    c = c3 // 3
    d = c // num_heads
    scal = swin_attention_scalars(score_requant, attn_scale, s2, out_requant, qkv_q.device, lis)
    rq, s1, inv_s2, ro = scal[0], scal[1], scal[2], scal[3]
    qkv = qkv_q.reshape(w, n, 3, num_heads, d).permute(2, 0, 3, 1, 4)
    attn_c = _scores(qkv[0], qkv[1], rq)
    attn2 = torch.clamp(torch.round((attn_c * s1 + bias.to(torch.float32)[None]) * inv_s2), -128, 127)
    if mask is not None:
        attn2 = (attn2.reshape(w // n_windows, n_windows, num_heads, n, n)
                 + mask.to(torch.float32)[None, :, None]).reshape(w, num_heads, n, n)
    out = _attend(attn2, qkv[2], scal[7], ro, lis_bits, lis)
    return out.permute(0, 2, 1, 3).reshape(w, n, c)


def swin_lis_attention_plain(qkv_q, bias, mask, num_heads, n_windows, score_requant,
                             attn_scale, s2, out_requant, lis_bits=4, lis=True):
    """Plain PyTorch version of the kernel, the twin of the JAX package's
    ``serving_swin._window_attention_codes_vals``. s2 is a power of two
    (a minmax PoT node), so the multiply by 1/s2 equals the twin's divide."""
    return _swin_windows_plain(qkv_q, bias, mask, num_heads, n_windows, score_requant,
                               attn_scale, s2, out_requant, lis_bits, lis)


def _check_swin_operands(qkv, bias, mask, c3, n, num_heads, n_windows, lis, lis_bits):
    """The Swin kernels' operand checks; returns (head_dim, bias, mask) as
    the kernels take them."""
    c = c3 // 3
    check_cuda_operand(qkv, "qkv", torch.int8)
    _check_lis_bits(lis, lis_bits)
    d = c // num_heads
    if c3 != 3 * c or c != d * num_heads or not 1 <= d <= SWIN_HEAD_DIM or n > SWIN_MAX_N:
        raise ValueError(f"Swin attention kernel needs head_dim <= {SWIN_HEAD_DIM} and "
                         f"N <= {SWIN_MAX_N}; got C={c}, heads={num_heads}, N={n}")
    bias = bias.to(torch.float32).contiguous()
    check_cuda_operand(bias, "bias", torch.float32, (num_heads, n, n))
    if mask is not None:
        mask = mask.to(torch.float32).contiguous()
        check_cuda_operand(mask, "mask", torch.float32, (n_windows, n, n))
    return d, bias, mask


def swin_pad_heads(qkv, num_heads: int, d: int):
    """(..., 3·H·d) qkv codes → (..., 3·H·32): each head's q, k and v
    columns zero-padded to the kernel's head_dim. Zero columns add nothing
    to the integer scores (``score_requant`` carries the true d^-0.5) and
    give zero output columns, which ``swin_unpad_heads`` drops."""
    if d == SWIN_HEAD_DIM:
        return qkv
    lead = qkv.shape[:-1]
    out = qkv.new_zeros((*lead, 3 * num_heads, SWIN_HEAD_DIM))
    out[..., :d] = qkv.reshape(*lead, 3 * num_heads, d)
    return out.reshape(*lead, 3 * num_heads * SWIN_HEAD_DIM)


def swin_unpad_heads(out, num_heads: int, d: int):
    """(..., H·32) output codes → (..., H·d), each head's first d columns."""
    if d == SWIN_HEAD_DIM:
        return out
    lead = out.shape[:-1]
    return out.reshape(*lead, num_heads, SWIN_HEAD_DIM)[..., :d].reshape(*lead, num_heads * d).contiguous()


def _swin_hooks(grid, phase_ns, cta_ns, items, n, lis, fold):
    """The measurement hooks' C arguments (grid, stamps, CTA spans);
    phase_ns is zeroed (the kernel adds its phase sums into it), and cta_ns
    must hold two stamps for each CTA of the launch."""
    if phase_ns is not None:
        check_cuda_operand(phase_ns, "phase_ns", torch.int64, (9,))
        phase_ns.zero_()
    if cta_ns is not None:
        check_cuda_operand(cta_ns, "cta_ns", torch.int64)
        info = swin_attention_info(n, lis, fold)
        ctas = min(items, grid if grid > 0 else info["sms"] * info["ctas_per_sm"])
        if cta_ns.numel() < 2 * ctas:
            raise ValueError(f"cta_ns holds {cta_ns.numel()} stamps; the launch has {ctas} CTAs")
    return int(grid), phase_ns, cta_ns


def swin_lis_attention(qkv_q, bias, mask, num_heads, n_windows, score_requant, attn_scale,
                       s2, out_requant, lis_bits=4, lis=True, *, grid=0, phase_ns=None, cta_ns=None):
    """Windowed attention over (W, N, 3C) int8 qkv codes of B·nW windows.

    Args:
      bias: (H, N, N) float32 dequantized relative-position-bias values.
      mask: (nW, N, N) float32 shift mask ALREADY divided by s2, or None;
        window i takes mask[i % n_windows].
      score_requant: s_qkv²·d^-0.5/s_attn1; attn_scale: s_attn1;
      s2: the qact2 scale (LIS input); out_requant: s_qkv/s_qact3.
    Returns (W, N, C) int8 codes of the qact3 node. CPU tensors take the
    plain version; CUDA tensors launch the kernel (N ≤ 64;
    ``swin_attention_plan``; a head_dim d < 32 runs with each head's q, k,
    v zero-padded to 32 by ``swin_pad_heads``) or raise. Measurement
    hooks: ``grid`` > 0 launches that many CTAs instead of the plan's; ``phase_ns``, a (9,)
    int64 CUDA tensor, receives the middle CTA's time per phase summed over
    its items (``SWIN_PHASES``; LIS off ``SWIN_PHASES_LISOFF`` and a zero),
    its total ns, its items, the grid and its bias stagings; ``cta_ns``, a
    (2·grid,) int64 CUDA tensor, every CTA's %globaltimer at its start and
    end.
    """
    dev = device_of(qkv_q, bias, *(() if mask is None else (mask,)))
    if dev.type == "cpu":
        return swin_lis_attention_plain(qkv_q, bias, mask, num_heads, n_windows, score_requant,
                                        attn_scale, s2, out_requant, lis_bits, lis)
    w, n, c3 = qkv_q.shape
    d, bias, mask = _check_swin_operands(qkv_q, bias, mask, c3, n, num_heads, n_windows, lis,
                                         lis_bits)
    if mask is not None and w % n_windows:
        raise ValueError(f"{w} windows are not whole images of {n_windows} windows")
    scal = swin_attention_scalars(score_requant, attn_scale, s2, out_requant, dev, lis)
    qkv_q = swin_pad_heads(qkv_q, num_heads, d)
    c = SWIN_HEAD_DIM * num_heads
    out = torch.empty((w, n, c), dtype=torch.int8, device=dev)
    nw = n_windows if mask is not None else 1
    if grid or phase_ns is not None or cta_ns is not None:
        launch("p2v_swin_attention_hook", qkv_q, bias, mask, scal, out, w, n, nw, c, num_heads, 0,
               int(bool(lis)), 0, *_swin_hooks(grid, phase_ns, cta_ns, w * num_heads, n, lis, False))
    else:
        launch("p2v_swin_lis_attention", qkv_q, bias, mask, scal, out, w, n, c, num_heads, nw,
               int(bool(lis)))
    swin_lis_attention.launches += 1
    return swin_unpad_heads(out, num_heads, d)


swin_lis_attention.launches = 0


def _folded_geometry(qkv_r, mask, window):
    """The JAX kernel's guards on the raster layout; returns (B, res, g, N)."""
    b, res, res2, _ = qkv_r.shape
    ws = window
    if not (res == res2 and res % ws == 0 and res > ws):
        raise ValueError(f"folded layout needs a square grid of >1 whole windows: "
                         f"res={res}x{res2}, window={ws}")
    g, n = res // ws, ws * ws
    if mask is not None and tuple(mask.shape) != (g * g, n, n):
        raise ValueError(f"mask shape {tuple(mask.shape)} != expected {(g * g, n, n)} "
                         f"(one (n,n) mask per window of the {g}x{g} grid)")
    return b, res, g, n


def swin_lis_attention_folded_plain(qkv_r, bias, mask, num_heads, window, score_requant,
                                    attn_scale, s2, out_requant, lis_bits=4, lis=True, shift=0):
    """Plain PyTorch version of the kernel: roll by −shift → window
    partition → the panel attention → window reverse → roll by +shift."""
    b, res, g, n = _folded_geometry(qkv_r, mask, window)
    ws, c3 = window, qkv_r.shape[-1]
    if shift:
        qkv_r = torch.roll(qkv_r, (-shift, -shift), (1, 2))
    hw = qkv_r.reshape(b, g, ws, g, ws, c3).permute(0, 1, 3, 2, 4, 5).reshape(b * g * g, n, c3)
    out = _swin_windows_plain(hw, bias, mask, num_heads, g * g, score_requant, attn_scale, s2,
                              out_requant, lis_bits, lis)
    out = out.reshape(b, g, g, ws, ws, -1).permute(0, 1, 3, 2, 4, 5).reshape(b, res, res, -1)
    return torch.roll(out, (shift, shift), (1, 2)) if shift else out


def swin_lis_attention_folded(qkv_r, bias, mask, num_heads, window, score_requant, attn_scale,
                              s2, out_requant, lis_bits=4, lis=True, shift=0, *, grid=0, phase_ns=None,
                              cta_ns=None):
    """Windowed attention over the raster-layout qkv codes, no partition or
    roll copies.

    Args:
      qkv_r: (B, res, res, 3C) int8 qkv codes in image-raster layout, NOT
        rolled; res a multiple of ``window``, > window.
      bias: (H, N, N) float32, N = window². mask: (g·g, N, N) float32 shift
        mask already divided by s2 (window (wy, wx) of the rolled grid takes
        mask[wy·g + wx]), or None. Scales as ``swin_lis_attention``.
      shift: the block's cyclic shift: the attention runs on the grid
        rolled by −shift and its output is rolled back by +shift, both in
        the kernel's addresses.
    Returns (B, res, res, C) int8 qact3 codes in raster layout, bit for bit
    roll(+shift) of window_reverse of ``swin_lis_attention`` on the
    partitioned panels of roll(−shift) of ``qkv_r``. CPU tensors take the
    plain version; CUDA tensors launch the kernel (head_dim ≤ 32, padded as
    ``swin_lis_attention`` pads it; N ≤ 64) or raise. ``grid``,
    ``phase_ns`` and ``cta_ns``: the measurement hooks of
    ``swin_lis_attention``.
    """
    dev = device_of(qkv_r, bias, *(() if mask is None else (mask,)))
    if dev.type == "cpu":
        return swin_lis_attention_folded_plain(qkv_r, bias, mask, num_heads, window,
                                               score_requant, attn_scale, s2, out_requant,
                                               lis_bits, lis, shift)
    b, res, g, n = _folded_geometry(qkv_r, mask, window)
    d, bias, mask = _check_swin_operands(qkv_r, bias, mask, qkv_r.shape[-1], n, num_heads, g * g,
                                         lis, lis_bits)
    scal = swin_attention_scalars(score_requant, attn_scale, s2, out_requant, dev, lis)
    qkv_r = swin_pad_heads(qkv_r, num_heads, d)
    c = SWIN_HEAD_DIM * num_heads
    out = torch.empty((b, res, res, c), dtype=torch.int8, device=dev)
    shift = int(shift) % res
    if grid or phase_ns is not None or cta_ns is not None:
        launch("p2v_swin_attention_hook", qkv_r, bias, mask, scal, out, b, res, window, c, num_heads,
               shift, int(bool(lis)), 1, *_swin_hooks(grid, phase_ns, cta_ns, b * g * g * num_heads, n, lis, True))
    else:
        launch("p2v_swin_lis_attention_folded", qkv_r, bias, mask, scal, out, b, res, window, c,
               num_heads, shift, int(bool(lis)))
    swin_lis_attention_folded.launches += 1
    return swin_unpad_heads(out, num_heads, d)


swin_lis_attention_folded.launches = 0

"""The serving integer LayerNorm (counterpart of ``p2vit_tpu/ops/intln.py``):
the shared chain ``ln_mn_chain`` and two standalone LN kernels.

One definition of the chain serves every plain version; ``csrc/common.cuh``
holds the same chain as a ``__device__`` function, op for op:

  mean = Σx/C · s1 ;  std = (s1/C)·√(C·Σx² − (Σx)²)
  A    = (s1/std)·w_os → sign; N = clip(7−⌊log2|A|⌋, 0, 31) from the
         exponent field; M = ⌊|A|·2^N⌋ clipped to 255
  B    = round((b_os − (mean/std)·w_os) · 2^N)
  y    = round((sign·M·x + B) · 2^−N)

The row sums Σx and Σx² are taken EXACTLY in integers and rounded to
float32 once (``row_sums``), so the result is independent of summation
order. The JAX twin sums in float32; the two agree while the sums stay
below 2^24 and can differ by an ulp past it.

Every division here is tensor by tensor on one device: PyTorch's CUDA
``div`` by a Python scalar multiplies by the reciprocal, which is not the
IEEE quotient.

The two kernels (``csrc/intln.cu``), on (M, C) int8 codes:

* ``int_ln_requant`` replaces the Pallas kernel
  ``p2vit_tpu/ops/intln.py:int_ln_requant`` (``_kernel``):
  x = codes·mask → ``ln_mn_chain`` → clip(round(y·ratio)). On the Swin path:
  the patch norm, each stage's first norm1 and the PatchMerging norms
  (4C channels, ``expand=4`` in the caller), 8 calls per Swin-T forward.
* ``int_res_ln_requant`` replaces ``p2vit_tpu/ops/intln.py:int_res_ln_requant``
  (``_res_kernel``): the residual requant-add res = clip(round((a·s_a +
  b·s_b)·(1/s_out))), rounded twice as written, then the LN of res·mask;
  two outputs. On the Swin path: the attention-side junction after
  ``window_reverse``, once per block.

They move 2 and 4 bytes an element but issue ~29 and ~44 instructions an
element (the LN chain, the residual chain), so on the H100 the SMs' issue
rate bounds them, not memory. ``ln_plan`` sizes the launch to C: G lanes
per row so that no lane idles at C = 96, each lane holding whole 16-byte
chunks of its row in registers from the one read to the one write, the
column vectors staged in shared memory once per CTA, a persistent grid;
the row sums are exact integers (see ``csrc/intln.cu``).

Widths: the wrappers zero-pad C to a multiple of 16 (``ln_pad``; the
kernel counts the true C, ``c_true``), as the JAX wrappers pad it to 128,
and serve C up to what JAX's own VMEM estimate admits at its floor
``block_m = 128`` under TPU's 16 MiB of scoped VMEM: ~27 bytes per block
element for ``int_ln_requant`` (``p2vit_tpu/ops/intln.py:123-126``),
128·C_pad·27 ≤ 2^24 gives C_pad ≤ 4854, so C ≤ 4736 (``MAX_C``); ~30 for
``int_res_ln_requant`` (``:231-233``) gives C ≤ 4352 (``MAX_RES_C``). Past
them the wrappers raise, as JAX's kernels fail to fit.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from ..profiling import count, op_span
from ._lib import check_cuda_operand, device_of, f32_vec, launch, library, pad_cols
from .fastmath import exp2i, floor_log2i, sqrt_rn

_VMEM = 2 ** 24  # scoped VMEM on the TPU, bytes
MAX_C = (_VMEM // (128 * 27)) // 128 * 128  # 4736: int_ln_requant's widest row, as JAX admits it
MAX_RES_C = (_VMEM // (128 * 30)) // 128 * 128  # 4352: int_res_ln_requant's
CHUNK = 16  # bytes a lane loads and stores at once; the wrappers pad C to a multiple
THREADS = 256  # threads per CTA, 8 warps
RUN = 3  # the chunks per lane the plan aims at
K_SET = (1, 2, 3, 4, 6, 8, 10)  # the chunks per lane the kernel is built for
LD = 17  # float4s a chunk's column vectors take in shared memory (16 and one of padding)
_I8 = (-128, 127)


def scalar_like(v, t: torch.Tensor) -> torch.Tensor:
    """``v`` as a float32 0-d tensor on ``t``'s device."""
    return torch.as_tensor(v, dtype=torch.float32, device=t.device)


def row_sums(x: torch.Tensor):
    """Exact Σx and Σx² over the last axis of integer-valued float ``x``,
    each rounded once to float32 (keepdim)."""
    xi = x.to(torch.int64)
    sx = xi.sum(dim=-1, keepdim=True).to(torch.float32)
    sxx = (xi * xi).sum(dim=-1, keepdim=True).to(torch.float32)
    return sx, sxx


def ln_mn_chain(x, sx, sxx, s1, c_true, w_os, b_os):
    """M·2^-N LN on PTF-aligned codes ``x`` with row sums given; returns
    y = round((sign(A)·M·x + B)·2^-N)."""
    c = scalar_like(c_true, x)
    mean = (sx / c) * s1
    std = (s1 / c) * sqrt_rn(c * sxx - sx * sx)
    a = (s1 / std) * w_os
    a_sign = torch.sign(a)
    a_abs = a.abs()
    n = torch.clamp(7 - floor_log2i(a_abs), 0, 31)
    p2n = exp2i(n)
    m = torch.clamp(torch.floor(a_abs * p2n), 0.0, 255.0)
    bb = torch.round((b_os - (mean / std) * w_os) * p2n)
    return torch.round((a_sign * m * x + bb) * exp2i(-n))


def ln_codes(x, s1, w_os, b_os, ratio, qmin=-128, qmax=127, c_true=None):
    """LN of aligned codes ``x`` (M, C) with exact row sums, then
    clip(round(y·ratio)) as int8: every plain LN epilogue. The LN counts
    ``c_true`` columns (default C: a zero-padded row counts its true width)."""
    sx, sxx = row_sums(x)
    y = ln_mn_chain(x, sx, sxx, s1, float(x.shape[-1] if c_true is None else c_true), w_os, b_os)
    return torch.clamp(torch.round(y * ratio), qmin, qmax).to(torch.int8)


@dataclasses.dataclass(frozen=True)
class LnPlan:
    """Launch plan of the two int-LN kernels (``csrc/intln.cu``, ``LnPlan``)."""

    g: int  # lanes per row; 32 / g rows share a warp
    k: int  # 16-byte chunks per lane: lane l of a row owns chunks l, l + g, …, l + (k − 1)·g
    c_pad: int  # the width the kernel sees (multiple of 16)
    rows: int  # rows per CTA per block, 256 / g
    blocks: int  # row blocks of ``rows`` rows
    grid: int  # persistent CTAs: min(blocks, SMs × CTAs per SM)
    smem_bytes: int  # the column vectors: LD float4s a chunk (residual: two such)

    @property
    def chunks(self) -> int:
        return self.c_pad // CHUNK

    def lane_chunks(self, lane: int) -> list:
        """The chunks lane ``lane`` (0 ≤ lane < g) of a row owns."""
        return [j for j in range(lane, self.k * self.g, self.g) if j < self.chunks]


@functools.lru_cache(maxsize=256)
def ln_plan(m: int, c: int, res: bool = False, sms: int = 132, ctas_per_sm: int = 4, g: int = 0) -> LnPlan:
    """The plan of ``int_ln_requant`` (``res``: ``int_res_ln_requant``) at
    (M, C), as the C entry computes it at the padded width on ``sms`` SMs
    holding ``ctas_per_sm`` CTAs each (``ln_kernel_info`` reads both on the
    card). G: the fewest lanes, a power of two from 2 to 32, with at most 3
    chunks a lane (C = 96: 2 lanes of 3 chunks; 384: 8; 1536: 32); k: the
    chunks per lane rounded up into ``K_SET``. ``g`` > 0 forces G (a
    measurement hook). Raises past the width JAX serves."""
    limit = MAX_RES_C if res else MAX_C
    if not 1 <= c <= limit:
        raise ValueError(f"{'int_res_ln_requant' if res else 'int_ln_requant'} kernel needs 1 <= C <= {limit} "
                         f"(JAX's VMEM estimate at block_m = 128), got C={c}")
    if not 0 <= m < 2 ** 31:
        raise ValueError(f"int-LN kernel needs 0 <= M < 2^31, got M={m}")
    if sms < 1 or ctas_per_sm < 1:
        raise ValueError(f"int-LN kernel needs SMs and CTAs per SM >= 1, got {sms}, {ctas_per_sm}")
    c_pad = -(-c // CHUNK) * CHUNK
    nch = c_pad // CHUNK
    lanes = 2
    while lanes < 32 and -(-nch // lanes) > RUN:
        lanes *= 2
    if g:
        if g not in (1, 2, 4, 8, 16, 32):
            raise ValueError(f"int-LN kernel takes G in 1, 2, 4, …, 32 lanes per row, got {g}")
        lanes = g
    k = next((kk for kk in K_SET if kk * lanes >= nch), None)
    if k is None:
        raise ValueError(f"int-LN kernel: {nch} chunks do not fit {lanes} lanes of at most {K_SET[-1]}")
    rows = THREADS // lanes
    blocks = -(-m // rows)
    return LnPlan(lanes, k, c_pad, rows, blocks, min(blocks, sms * ctas_per_sm), nch * LD * 16 * (2 if res else 1))


def ln_pad(vecs: torch.Tensor, *codes: torch.Tensor):
    """The kernel's operands: each (M, C) code tensor and the (n, C) column
    vectors zero-padded to a multiple of 16 columns (the tensors themselves
    where C needs none). Zero vectors make the padded columns' x = code·mask
    zero (and the residual codes zero), so Σx and Σx² are those of the true
    C; the LN must still count the true C."""
    return (pad_cols(vecs, CHUNK),) + tuple(pad_cols(t, CHUNK) for t in codes)


_INFO_KEYS = ("g", "k", "rows", "blocks", "grid", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm", "sms")


def ln_kernel_info(m: int, c: int, res: bool = False, g: int = 0) -> dict:
    """The built kernel's launch facts at (M, C) from the CUDA runtime: the
    plan (``g`` as ``ln_plan``), registers and spill bytes per thread, CTAs
    per SM and SMs. Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * len(_INFO_KEYS))()
    c_pad = -(-c // CHUNK) * CHUNK
    rc = lib.p2v_int_ln_info(int(m), c_pad, int(res), int(g), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_int_ln_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    return dict(zip(_INFO_KEYS, list(info)))


def ln_chain_check(device=None) -> tuple:
    """The kernel's LN chain rewrites against ``p2v::ln_elem``'s, over all
    2^32 float32 bit patterns on the card: (inputs whose 2^N or 2^-N bits
    differ, inputs whose unit-ratio fold differs). Both must be 0."""
    bad = torch.zeros(2, dtype=torch.int64, device=device or torch.device("cuda", torch.cuda.current_device()))
    launch("p2v_ln_chain_check", bad)
    return tuple(int(v) for v in bad.tolist())


class LnConsts(NamedTuple):
    """An int-LN kernel's constants: the per-column vectors and s1."""

    vecs: torch.Tensor  # (4, C) or, residual, (7, C); padded to 16 columns where prepared
    s1: torch.Tensor  # (1,) float32


def _ln_launch(entry, codes, vecs, s1, c, res, g):
    """Check, pad and launch the C entry ``entry`` on ``codes`` (one tensor,
    or the residual's two operands) and the constants (vectors at C or
    already padded); returns the output tensor(s), (M, C)."""
    m = codes[0].shape[0]
    dev = codes[0].device
    plan = ln_plan(m, c, res, g=g)  # the width and G checks; the C entry plans the grid itself
    vecs, *padded = ln_pad(vecs, *codes)
    check_cuda_operand(vecs, "vecs", torch.float32, (7 if res else 4, plan.c_pad))
    check_cuda_operand(s1, "s1", torch.float32, (1,))
    outs = [torch.empty((m, plan.c_pad), dtype=torch.int8, device=dev) for _ in range(2 if res else 1)]
    launch(entry, *padded, vecs, s1, *outs, m, plan.c_pad, c, g)
    if plan.c_pad != c:
        outs = [o[:, :c].contiguous() for o in outs]
    return tuple(outs) if res else outs[0]


# ---------------------------------------------------------------------------
# int_ln_requant
# ---------------------------------------------------------------------------


def ln_requant_consts(c, device, ptf_mask, s1, ln_w, ln_b, out_scale, ratio) -> LnConsts:
    """Per-column vectors (4, C) — mask, w/osc, b/osc, ratio, with the JAX
    kernel's 1e-30 floor on out_scale — and s1 as (1,)."""
    count("consts_formed")
    v = lambda a: f32_vec(a, c, device)  # noqa: E731
    osc = torch.clamp(v(out_scale), min=1e-30)
    vecs = torch.stack([v(ptf_mask), v(ln_w) / osc, v(ln_b) / osc, v(ratio)])
    return LnConsts(vecs, torch.as_tensor(s1, dtype=torch.float32, device=device).reshape(1))


def ln_prepared(c, device, *args) -> LnConsts:
    """``ln_requant_consts(c, device, *args)`` with the vectors zero-padded
    to the kernel's width (``ln_pad``): what ``int_ln_requant_prepared``
    reads, formed once per serving state."""
    vecs, s1 = ln_requant_consts(c, device, *args)
    return LnConsts(pad_cols(vecs, CHUNK), s1)


def ln_requant_codes(codes, vecs, s1, c_true=None):
    """The kernel's chain on its constants (``ln_requant_consts``, maybe
    padded by ``ln_pad``); the LN counts ``c_true`` columns (default C)."""
    mask, w_os, b_os, ratio_v = (row[None, :] for row in vecs)
    return ln_codes(codes.to(torch.float32) * mask, s1[0], w_os, b_os, ratio_v, c_true=c_true)


def int_ln_requant_plain(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio):
    """Plain PyTorch version of the kernel."""
    return ln_requant_codes(codes, *ln_requant_consts(codes.shape[-1], codes.device, ptf_mask, s1, ln_w, ln_b,
                                                      out_scale, ratio))


def int_ln_requant_prepared_plain(codes, consts):
    """Plain version of ``int_ln_requant_prepared``."""
    return ln_requant_codes(codes, consts.vecs[:, :codes.shape[-1]], consts.s1)


def _int_ln(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio, g):
    if codes.device.type != "cuda":
        raise ValueError(f"int_ln_requant kernel needs CUDA tensors, got {codes.device}")
    c = codes.shape[1]
    check_cuda_operand(codes, "codes", torch.int8)
    vecs, s1v = ln_requant_consts(c, codes.device, ptf_mask, s1, ln_w, ln_b, out_scale, ratio)
    return _ln_launch("p2v_int_ln_requant", (codes,), vecs, s1v, c, False, g)


def int_ln_requant_forced(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio, g=0):
    """The kernel launched with ``g`` lanes per row (0: the plan's). A
    measurement hook for CUDA tensors; not counted in
    ``int_ln_requant.launches``."""
    return _int_ln(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio, g)


@op_span
def int_ln_requant(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio):
    """Integer LN on (M, C) int8 codes → (M, C) int8 codes of the consumer.

    Args:
      ptf_mask: (C,) round(in_scale / in_scale.min()); s1: in_scale.min().
      ln_w/ln_b: (C,) LayerNorm affine. out_scale: (C,) consumer scale.
      ratio: (C,) post-LN code multiplier (1 on the Swin path).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (any C ≤ ``MAX_C``, zero-padded to a multiple of 16) or raise.
    """
    if codes.device.type == "cpu":
        return int_ln_requant_plain(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio)
    out = _int_ln(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio, 0)
    int_ln_requant.launches += 1
    return out


int_ln_requant.launches = 0


@op_span(of=int_ln_requant)
def int_ln_requant_prepared(codes, consts):
    """``int_ln_requant`` on its constants formed beforehand
    (``ln_prepared``): the serving forwards' entry, which forms nothing per
    call. CPU tensors take ``int_ln_requant_prepared_plain``; CUDA tensors
    launch the kernel (counted in ``int_ln_requant.launches``) or raise."""
    if codes.device.type == "cpu":
        return int_ln_requant_prepared_plain(codes, consts)
    if codes.device.type != "cuda":
        raise ValueError(f"int_ln_requant kernel needs CUDA tensors, got {codes.device}")
    check_cuda_operand(codes, "codes", torch.int8)
    out = _ln_launch("p2v_int_ln_requant", (codes,), consts.vecs, consts.s1, codes.shape[1], False, 0)
    int_ln_requant.launches += 1
    return out


# ---------------------------------------------------------------------------
# int_res_ln_requant
# ---------------------------------------------------------------------------


def res_ln_requant_consts(c, device, s_a, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio) -> LnConsts:
    """Per-column vectors (7, C) — s_a, s_b, 1/max(s_out, 1e-30), PTF mask,
    w/osc, b/osc, ratio — and s1 = min(s_out) as (1,), formed as the JAX
    twin forms them."""
    count("consts_formed")
    v = lambda a: f32_vec(a, c, device)  # noqa: E731
    s_out_v = v(s_out)
    s1 = s_out_v.min()
    osc = torch.clamp(v(ln_out_scale), min=1e-30)
    vecs = torch.stack([
        v(s_a), v(s_b), torch.ones_like(s_out_v) / torch.clamp(s_out_v, min=1e-30),
        torch.round(s_out_v / s1), v(ln_w) / osc, v(ln_b) / osc, v(ratio),
    ])
    return LnConsts(vecs, s1.reshape(1))


def res_ln_requant_prepared(c, device, *scales) -> LnConsts:
    """``res_ln_requant_consts(c, device, *scales)`` with the vectors
    zero-padded to the kernel's width: what ``int_res_ln_requant_prepared``
    reads, formed once per serving state."""
    vecs, s1 = res_ln_requant_consts(c, device, *scales)
    return LnConsts(pad_cols(vecs, CHUNK), s1)


def res_ln_requant_codes(a_q, b_q, vecs, s1, c_true=None):
    """The kernel's chain on its constants (``res_ln_requant_consts``, maybe
    padded by ``ln_pad``); the LN counts ``c_true`` columns (default C).
    Returns (res_codes, ln_codes)."""
    sa, sb, inv_out, mask, w_os, b_os, ratio_v = (row[None, :] for row in vecs)
    val = a_q.to(torch.float32) * sa + b_q.to(torch.float32) * sb
    res = torch.clamp(torch.round(val * inv_out), *_I8)
    return res.to(torch.int8), ln_codes(res * mask, s1[0], w_os, b_os, ratio_v, c_true=c_true)


def int_res_ln_requant_plain(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio):
    """Plain PyTorch version of the kernel; the twin of
    ``int_res_ln_requant_ref`` op for op. Returns (res_codes, ln_codes)."""
    return res_ln_requant_codes(a_q, b_q, *res_ln_requant_consts(a_q.shape[-1], device_of(a_q, b_q), s_a, s_b,
                                                                 s_out, ln_w, ln_b, ln_out_scale, ratio))


def int_res_ln_requant_prepared_plain(a_q, b_q, consts):
    """Plain version of ``int_res_ln_requant_prepared``."""
    return res_ln_requant_codes(a_q, b_q, consts.vecs[:, :a_q.shape[-1]], consts.s1)


def _res_ln_operands(a_q, b_q):
    """The residual kernel's operand checks; returns (device, C)."""
    dev = device_of(a_q, b_q)
    if dev.type != "cuda":
        raise ValueError(f"int_res_ln_requant kernel needs CUDA tensors, got {dev}")
    m, c = a_q.shape
    check_cuda_operand(a_q, "a_q", torch.int8)
    check_cuda_operand(b_q, "b_q", torch.int8, (m, c))
    return dev, c


def _int_res_ln(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio, g):
    dev, c = _res_ln_operands(a_q, b_q)
    vecs, s1 = res_ln_requant_consts(c, dev, s_a, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio)
    return _ln_launch("p2v_int_res_ln_requant", (a_q, b_q), vecs, s1, c, True, g)


def int_res_ln_requant_forced(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio, g=0):
    """The kernel launched with ``g`` lanes per row, as
    ``int_ln_requant_forced``; not counted in ``int_res_ln_requant.launches``."""
    return _int_res_ln(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio, g)


@op_span
def int_res_ln_requant(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio):
    """Residual requant-add + integer LN; returns (res_codes, ln_codes), both
    (M, C) int8.

    Args:
      a_q/b_q: (M, C) int8 operand codes with scales s_a/s_b (scalar or (C,)).
      s_out: the residual node's scale (scalar or (C,)), also the LN input
        scale (s1 = min, PTF mask = round(s_out/s1)).
      ln_w/ln_b: (C,) affine; ln_out_scale: consumer scale; ratio: post-LN
        code multiplier.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (any C ≤ ``MAX_RES_C``, zero-padded to a multiple of 16) or raise.
    """
    if device_of(a_q, b_q).type == "cpu":
        return int_res_ln_requant_plain(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio)
    out = _int_res_ln(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio, 0)
    int_res_ln_requant.launches += 1
    return out


int_res_ln_requant.launches = 0


@op_span(of=int_res_ln_requant)
def int_res_ln_requant_prepared(a_q, b_q, consts):
    """``int_res_ln_requant`` on its constants formed beforehand
    (``res_ln_requant_prepared``): the serving forwards' entry, which forms
    nothing per call. CPU tensors take
    ``int_res_ln_requant_prepared_plain``; CUDA tensors launch the kernel
    (counted in ``int_res_ln_requant.launches``) or raise. Returns
    (res_codes, ln_codes)."""
    if device_of(a_q, b_q).type == "cpu":
        return int_res_ln_requant_prepared_plain(a_q, b_q, consts)
    _, c = _res_ln_operands(a_q, b_q)
    out = _ln_launch("p2v_int_res_ln_requant", (a_q, b_q), consts.vecs, consts.s1, c, True, 0)
    int_res_ln_requant.launches += 1
    return out

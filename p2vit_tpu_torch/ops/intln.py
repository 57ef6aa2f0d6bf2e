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

Both are bound by memory on the card (a few flops per byte): one warp owns
a row (C ≤ 3072), reads it as 4-byte words, sums Σx in int32 and Σx² in
int64 (C·(128·8)² passes 2^31 at C = 2048) with warp shuffles, then reads
the row again from L1/L2 for the elementwise chain and writes 4-byte words.
"""

from __future__ import annotations

import torch

from ._lib import check_cuda_operand, device_of, f32_vec, launch
from .fastmath import exp2i, floor_log2i, sqrt_rn

MAX_LN_ROW = 3072  # swin_base's 4·768 PatchMerging row is the widest in the zoo
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


def _check_rows(name, c):
    if c % 4 or c > MAX_LN_ROW:
        raise ValueError(f"{name} kernel needs C % 4 == 0 and C <= {MAX_LN_ROW}; got C={c}")


# ---------------------------------------------------------------------------
# int_ln_requant
# ---------------------------------------------------------------------------


def ln_requant_consts(c, device, ptf_mask, s1, ln_w, ln_b, out_scale, ratio):
    """Per-column vectors (4, C) — mask, w/osc, b/osc, ratio, with the JAX
    kernel's 1e-30 floor on out_scale — and s1 as (1,)."""
    v = lambda a: f32_vec(a, c, device)  # noqa: E731
    osc = torch.clamp(v(out_scale), min=1e-30)
    vecs = torch.stack([v(ptf_mask), v(ln_w) / osc, v(ln_b) / osc, v(ratio)])
    return vecs, torch.as_tensor(s1, dtype=torch.float32, device=device).reshape(1)


def int_ln_requant_plain(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio):
    """Plain PyTorch version of the kernel."""
    vecs, s1v = ln_requant_consts(codes.shape[-1], codes.device, ptf_mask, s1, ln_w, ln_b,
                                  out_scale, ratio)
    mask, w_os, b_os, ratio_v = (row[None, :] for row in vecs)
    return ln_codes(codes.to(torch.float32) * mask, s1v[0], w_os, b_os, ratio_v)


def int_ln_requant(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio):
    """Integer LN on (M, C) int8 codes → (M, C) int8 codes of the consumer.

    Args:
      ptf_mask: (C,) round(in_scale / in_scale.min()); s1: in_scale.min().
      ln_w/ln_b: (C,) LayerNorm affine. out_scale: (C,) consumer scale.
      ratio: (C,) post-LN code multiplier (1 on the Swin path).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (C % 4 == 0, C ≤ 3072) or raise.
    """
    if codes.device.type == "cpu":
        return int_ln_requant_plain(codes, ptf_mask, s1, ln_w, ln_b, out_scale, ratio)
    m, c = codes.shape
    check_cuda_operand(codes, "codes", torch.int8)
    _check_rows("int_ln_requant", c)
    vecs, s1v = ln_requant_consts(c, codes.device, ptf_mask, s1, ln_w, ln_b, out_scale, ratio)
    out = torch.empty((m, c), dtype=torch.int8, device=codes.device)
    launch("p2v_int_ln_requant", codes, vecs, s1v, out, m, c)
    int_ln_requant.launches += 1
    return out


int_ln_requant.launches = 0


# ---------------------------------------------------------------------------
# int_res_ln_requant
# ---------------------------------------------------------------------------


def res_ln_requant_consts(c, device, s_a, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio):
    """Per-column vectors (7, C) — s_a, s_b, 1/max(s_out, 1e-30), PTF mask,
    w/osc, b/osc, ratio — and s1 = min(s_out) as (1,), formed as the JAX
    twin forms them."""
    v = lambda a: f32_vec(a, c, device)  # noqa: E731
    s_out_v = v(s_out)
    s1 = s_out_v.min()
    osc = torch.clamp(v(ln_out_scale), min=1e-30)
    vecs = torch.stack([
        v(s_a), v(s_b), torch.ones_like(s_out_v) / torch.clamp(s_out_v, min=1e-30),
        torch.round(s_out_v / s1), v(ln_w) / osc, v(ln_b) / osc, v(ratio),
    ])
    return vecs, s1.reshape(1)


def int_res_ln_requant_plain(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio):
    """Plain PyTorch version of the kernel; the twin of
    ``int_res_ln_requant_ref`` op for op. Returns (res_codes, ln_codes)."""
    dev = device_of(a_q, b_q)
    vecs, s1 = res_ln_requant_consts(a_q.shape[-1], dev, s_a, s_b, s_out, ln_w, ln_b,
                                     ln_out_scale, ratio)
    sa, sb, inv_out, mask, w_os, b_os, ratio_v = (row[None, :] for row in vecs)
    val = a_q.to(torch.float32) * sa + b_q.to(torch.float32) * sb
    res = torch.clamp(torch.round(val * inv_out), *_I8)
    return res.to(torch.int8), ln_codes(res * mask, s1[0], w_os, b_os, ratio_v)


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
    (C % 4 == 0, C ≤ 3072) or raise.
    """
    dev = device_of(a_q, b_q)
    if dev.type == "cpu":
        return int_res_ln_requant_plain(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio)
    m, c = a_q.shape
    check_cuda_operand(a_q, "a_q", torch.int8)
    check_cuda_operand(b_q, "b_q", torch.int8, (m, c))
    _check_rows("int_res_ln_requant", c)
    vecs, s1 = res_ln_requant_consts(c, dev, s_a, s_b, s_out, ln_w, ln_b, ln_out_scale, ratio)
    res_out = torch.empty((m, c), dtype=torch.int8, device=dev)
    ln_out = torch.empty((m, c), dtype=torch.int8, device=dev)
    launch("p2v_int_res_ln_requant", a_q, b_q, vecs, s1, res_out, ln_out, m, c)
    int_res_ln_requant.launches += 1
    return res_out, ln_out


int_res_ln_requant.launches = 0

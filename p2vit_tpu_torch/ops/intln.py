"""The serving integer-LayerNorm chain (counterpart of ``ln_mn_chain`` in
``p2vit_tpu/ops/intln.py``).

One definition serves every plain version; ``csrc/common.cuh`` holds the
same chain as a ``__device__`` function, op for op:

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
"""

from __future__ import annotations

import torch

from .fastmath import exp2i, floor_log2i, sqrt_rn


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

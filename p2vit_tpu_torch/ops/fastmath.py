"""Exact exponent-field integer math (counterpart of ``p2vit_tpu/ops/fastmath.py``).

* ``floor_log2i(x)``: the unbiased IEEE-754 exponent of float32 ``x``, which
  for positive normal x IS ⌊log2 x⌋ exactly; -127 for ±0 and subnormals,
  128 for ±inf/NaN.
* ``exp2i(k)``: 2^k built by placing k+127 in the exponent field; exact for
  k ∈ [-126, 127], +inf for 128, +0 for -127.

Both are bitcasts (``Tensor.view``), so they agree bit for bit with the JAX
twins and with the ``__device__`` helpers in ``csrc/common.cuh``.
"""

from __future__ import annotations

import torch


def floor_log2i(x: torch.Tensor) -> torch.Tensor:
    """Unbiased exponent of float32 ``x`` as int32 (sign bit ignored)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def exp2i(k: torch.Tensor) -> torch.Tensor:
    """2.0**k for int32 ``k`` ∈ [-127, 128] by exponent construction."""
    return ((k.to(torch.int32) + 127) << 23).contiguous().view(torch.float32)


def sqrt_rn(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 sqrt. PyTorch's vectorized CPU sqrt is not
    (about 0.7% of random inputs land one ulp off); a float64 sqrt rounded
    once to float32 is, and equals ``__fsqrt_rn`` on the card."""
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def exp_rn(x: torch.Tensor) -> torch.Tensor:
    """float32 exp through float64, rounded once. The CUDA kernels use the
    same form, so kernel and plain version agree bit for bit whatever the
    float32 ``exp`` of either library does."""
    return torch.exp(x.to(torch.float64)).to(torch.float32)

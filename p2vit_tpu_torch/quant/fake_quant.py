"""Fake-quantization primitives (counterpart of ``p2vit_tpu/quant/fake_quant.py``).

Plain functions on tensors. All rounding is round-half-to-even
(``torch.round``), as ``jnp.round``.
"""

from __future__ import annotations

import torch

from .bit_type import BitType


def lp_loss(pred, tgt, p: float = 2.0):
    """Mean |pred - tgt|^p, the metric of every calibration search."""
    return ((pred - tgt).abs() ** p).mean()


def round_to_pot(x):
    """Exponent of the power of two nearest to positive ``x`` (ties down).

    ``y = floor(log2 x)``, plus one where ``x - 2^y > 2^(y+1) - x``. Returned
    as a float tensor. ``torch.log2`` is exact at powers of two; the JAX
    twin's XLA log2 is not at some of them above 1 (see the pin in
    ``tests/test_torch_quant_core.py``).
    """
    y = torch.floor(torch.log2(x))
    up = (x - 2.0**y) > (2.0 ** (y + 1) - x)
    return y + up.to(y.dtype)


def floor_pot_exponent(x):
    """``floor(log2 x)``."""
    return torch.floor(torch.log2(x))


def quantize(x, scale, zero_point, bit_type: BitType):
    """``clamp(round(x / scale + zp), qmin, qmax)``."""
    q = torch.round(x / scale + zero_point)
    return torch.clamp(q, bit_type.lower_bound, bit_type.upper_bound)


def dequantize(q, scale, zero_point):
    return (q - zero_point) * scale


def fake_quant(x, scale, zero_point, bit_type: BitType):
    """quantize → dequantize round trip."""
    return dequantize(quantize(x, scale, zero_point, bit_type), scale, zero_point)


def fake_quant_dyn(x, scale, zero_point, qmin, qmax):
    """Fake-quant with bounds given as tensors (per-layer bit choice as data)."""
    q = torch.clamp(torch.round(x / scale + zero_point), qmin, qmax)
    return (q - zero_point) * scale


def log2_quantize(x, bit_type: BitType):
    """``round(-log2 x)`` clamped to [0, 2^bits - 1], with the overflow mask."""
    rounds = torch.round(-torch.log2(x))
    mask = rounds >= 2**bit_type.bits
    codes = torch.clamp(rounds, 0, 2**bit_type.bits - 1)
    return codes, mask


def log2_dequantize(codes, mask):
    out = 2.0 ** (-codes)
    return torch.where(mask, torch.zeros_like(out), out)


def fake_quant_log2(x, bit_type: BitType):
    codes, mask = log2_quantize(x, bit_type)
    return log2_dequantize(codes, mask)


def weight_scale_reshape(scale, weight_ndim: int):
    """Per-out-channel scale → broadcastable against an (O, ...) weight."""
    scale = torch.as_tensor(scale)
    if scale.ndim == 0:
        return scale
    return scale.reshape((-1,) + (1,) * (weight_ndim - 1))


def act_scale_reshape(scale, act_ndim: int):
    """Per-channel scale → broadcastable against a channel-last activation."""
    scale = torch.as_tensor(scale)
    if scale.ndim == 0:
        return scale
    return scale.reshape((1,) * (act_ndim - 1) + (-1,))

"""Integer LayerNorm and Log-Int-Softmax, simulation path (counterpart of
``p2vit_tpu/quant/intops.py``).

Float-simulated semantics used by calibration and ``quant_forward``:
everything stays float32, but every value is integral where the
integer pipeline's is. The serving kernels in ``p2vit_tpu_torch/ops``
realize the same math on int8 codes.
"""

from __future__ import annotations

import torch

from ..ops.fastmath import exp2i, sqrt_rn
from .bit_type import BitType


def _pow2(n):
    """Exact 2.0**n for an integer-valued float tensor, over the whole float32
    domain: normals by exponent construction, subnormals for n ∈ [-149, -127]
    by a mantissa bit, 0 below, inf above 127."""
    n_i = n.to(torch.int32)
    normal = exp2i(torch.clamp(n_i, -126, 128))
    sub = (torch.ones_like(n_i) << torch.clamp(n_i + 149, 0, 22)).view(torch.float32)
    zero = torch.zeros_like(normal)
    out = torch.where(n_i >= -126, normal, torch.where(n_i >= -149, sub, zero))
    return out.to(torch.promote_types(n.dtype, torch.float32))


def get_mn(x: torch.Tensor):
    """Positive multiplier → M·2^-N with N = clamp(7 - floor(log2 x), 0, 31),
    M = clamp(floor(x·2^N), 0, 255)."""
    bit = 7
    n = torch.clamp(bit - torch.floor(torch.log2(x)), 0, 31)
    m = torch.clamp(torch.floor(x * _pow2(n)), 0, 2 ** (bit + 1) - 1)
    return m, n


def int_layernorm(x, weight, bias, in_scale, out_scale, in_scale_expand: int = 1):
    """Integer LayerNorm with PTF shift alignment and M·2^-N output requant.

    Same op sequence as the JAX twin: codes = round(x/in_scale), aligned to
    the smallest PTF scale, integer mean/std, then the M·2^-N epilogue onto
    ``out_scale``.
    """
    channel_nums = x.shape[-1]
    in_scale = torch.as_tensor(in_scale, dtype=x.dtype, device=x.device)
    out_scale = torch.as_tensor(out_scale, dtype=x.dtype, device=x.device)
    if in_scale_expand != 1:
        in_scale = in_scale.repeat(in_scale_expand)
    in_scale = in_scale.reshape(1, 1, -1) if in_scale.ndim else in_scale
    out_scale = out_scale.reshape(1, 1, -1) if out_scale.ndim else out_scale

    x_q = torch.round(x / in_scale)
    in_scale1 = in_scale.min()
    in_scale_mask = torch.round(in_scale / in_scale1)
    x_q = x_q * in_scale_mask

    mean_x_q = x_q.mean(dim=-1) * in_scale1
    std_x_q = (in_scale1 / channel_nums) * sqrt_rn(
        channel_nums * (x_q**2).sum(dim=-1) - x_q.sum(dim=-1) ** 2
    )
    a = (in_scale1 / std_x_q)[..., None] * weight.reshape(1, 1, -1) / out_scale
    a_sign = torch.sign(a)
    m, n = get_mn(a.abs())
    p2n = _pow2(n)
    b = torch.round(
        (bias.reshape(1, 1, -1) - (mean_x_q / std_x_q)[..., None] * weight.reshape(1, 1, -1))
        / out_scale
        * p2n
    )
    x_q = torch.round((a_sign * m * x_q + b) / p2n)
    return x_q * out_scale


def log_round(x: torch.Tensor):
    """Round positive ``x`` to the nearest power of two in the log2 domain,
    ties UP: floor(log2 x) plus mantissa bit 22. Read off the bit pattern,
    exact for every positive normal; other lanes follow ``floor(log2 x)``."""
    xf = x.to(torch.float32)
    bits = xf.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    tie = (bits >> 22) & 1
    res = (e + tie).to(torch.float32)
    big = torch.floor(torch.log2(xf))
    normal = (bits >= 0) & (e > -127) & (e < 128)
    return torch.where(normal, res, big).to(torch.promote_types(x.dtype, torch.float32))


def int_polynomial(x_int, scaling_factor):
    """2nd-order integer polynomial for exp on [-ln2, 0]."""
    coef0, coef1, coef2 = 0.35815147, 0.96963238, 1.0
    coef1 = coef1 / coef0
    coef2 = coef2 / coef0
    b_int = torch.floor(coef1 / scaling_factor)
    c_int = torch.floor(coef2 / scaling_factor**2)
    z = x_int + b_int
    z = x_int * z
    z = z + c_int
    return z, coef0 * scaling_factor**2


def int_exp(x_int, scaling_factor):
    """Range-reduced integer exp, n = 32."""
    x0 = -0.6931
    n = 32
    x0_int = torch.floor(x0 / scaling_factor)
    x_int = torch.maximum(x_int, n * x0_int)
    q = torch.floor(x_int / x0_int)
    r = x_int - x0_int * q
    exp_int, exp_sf = int_polynomial(r, scaling_factor)
    exp_int = torch.clamp(torch.floor(exp_int * _pow2(n - q)), min=0.0)
    return exp_int, exp_sf / 2.0**n


def int_softmax(x, scaling_factor):
    """Integer softmax numerator and denominator along the last axis."""
    x_int = x / scaling_factor
    x_int = x_int - x_int.amax(dim=-1, keepdim=True)
    exp_int, _ = int_exp(x_int, scaling_factor)
    exp_int_sum = exp_int.sum(dim=-1, keepdim=True)
    return exp_int, exp_int_sum


def log_int_softmax(x, scale, bit_type: BitType):
    """int exp → round(sum/exp) → log2-round → exact 2^-q (0 on overflow)."""
    exp_int, exp_int_sum = int_softmax(x, scale)
    softmax_out = torch.round(exp_int_sum / exp_int)
    rounds = log_round(softmax_out)
    mask = rounds >= 2**bit_type.bits
    qlog = torch.clamp(rounds, 0, 2**bit_type.bits - 1)
    p = _pow2(-qlog)
    return torch.where(mask, torch.zeros_like(p), p)

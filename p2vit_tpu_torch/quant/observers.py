"""Range observers and scale solvers, incl. the P²-ViT PoT search
(counterpart of ``p2vit_tpu/quant/observers.py``).

Statistics: running min/max (``collect_minmax``/``merge_minmax``), the EMA
merge (``merge_ema``) and the percentile-clipped range
(``collect_percentile``/``merge_percentile``). Solvers: the minmax observer
with the 4-candidate power-of-two search (activations and output-aware
weights), the PTF observer for LayerNorm inputs, the plain float scale of
the ema and percentile observers (``float_scale_params``) and the omse
range-shrink search (``omse_params``).

Every divisor of the float-scale solvers is a tensor on the operand's
device: PyTorch's CUDA division by a Python scalar multiplies by its
reciprocal, which can differ in the last bit.

All tensors are channel-last activations or (out, in...) weights.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .bit_type import BitType
from .fake_quant import fake_quant, lp_loss

EPS = float(torch.finfo(torch.float32).eps)

# candidate exponent offsets searched around floor(log2(scale))
POT_CANDIDATE_OFFSETS = (-1.0, 0.0, 1.0, 2.0)


class MinMaxStats(NamedTuple):
    """Per-channel (or scalar, layer-wise) running min/max."""

    min_val: torch.Tensor
    max_val: torch.Tensor


def channel_view(v: torch.Tensor, kind: str) -> torch.Tensor:
    """(channels, everything else): weights fold onto the out-channel axis,
    activations onto the last (feature) axis."""
    if kind == "weight":
        return v.reshape(v.shape[0], -1)
    if kind == "activation":
        return v.reshape(-1, v.shape[-1]).T
    raise NotImplementedError(kind)


def collect_minmax(v: torch.Tensor, kind: str, layer_wise: bool) -> MinMaxStats:
    m = channel_view(v, kind)
    mx = m.amax(dim=1)
    mn = m.amin(dim=1)
    if layer_wise:
        mx = mx.amax()
        mn = mn.amin()
    return MinMaxStats(min_val=mn, max_val=mx)


def merge_minmax(a: MinMaxStats, b: MinMaxStats) -> MinMaxStats:
    return MinMaxStats(
        min_val=torch.minimum(a.min_val, b.min_val),
        max_val=torch.maximum(a.max_val, b.max_val),
    )


def merge_ema(a: MinMaxStats, b: MinMaxStats, sigma: float = 0.01) -> MinMaxStats:
    """EMA min/max update: ``a + sigma·(b − a)``."""
    return MinMaxStats(
        min_val=a.min_val + sigma * (b.min_val - a.min_val),
        max_val=a.max_val + sigma * (b.max_val - a.max_val),
    )


def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _quantile(srt: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(x, q)`` (linear) from ``srt``, the ascending float32
    elements of x, in JAX's float32 arithmetic: ``q·(n − 1)`` is a float32
    product of float32 operands (so past 2^24 elements the index rounds as
    JAX's does), its floor and ceil are clamped to [0, n − 1], and the two
    order statistics are weighted ``lo·(1 − w) + hi·w``. ``jnp.quantile`` is
    jitted, and XLA:CPU contracts that sum into ``fma(hi, w, lo·(1 − w))``;
    the port computes the fma in float64, where the product is exact, and
    rounds once to float32."""
    n1 = _f32(float(srt.numel()), srt) - 1.0
    pos = _f32(q, srt) * n1
    low, high = torch.floor(pos), torch.ceil(pos)
    w_hi = pos - low
    w_lo = 1.0 - w_hi
    zero = torch.zeros_like(n1)
    lo_i = torch.minimum(torch.maximum(low, zero), n1).to(torch.int64)
    hi_i = torch.minimum(torch.maximum(high, zero), n1).to(torch.int64)
    low_part = (srt[lo_i] * w_lo).to(torch.float64)
    return (srt[hi_i].to(torch.float64) * w_hi.to(torch.float64) + low_part).to(torch.float32)


def collect_percentile(v: torch.Tensor, kind: str, alpha: float = 0.99999) -> MinMaxStats:
    """Percentile-clipped layer-wise range: the ``1 − alpha`` and ``alpha``
    quantiles of every element, from one ``torch.sort`` on the tensor's
    device (``torch.quantile`` refuses inputs of more than 2^24 elements).
    Quantiles ignore the order, so the elements are taken as they lie, not
    through ``channel_view``'s transposed copy."""
    srt = torch.sort(v.reshape(-1).to(torch.float32)).values
    return MinMaxStats(min_val=_quantile(srt, 1.0 - alpha), max_val=_quantile(srt, alpha))


def merge_percentile(a: MinMaxStats, b: MinMaxStats, sigma: float = 0.01) -> MinMaxStats:
    """The percentile observer merges batches by EMA."""
    return merge_ema(a, b, sigma)


def float_scale_params(stats: MinMaxStats, bit_type: BitType, symmetric: bool):
    """Plain float scale of the ema and percentile observers (no PoT
    rounding). Returns (scale, zero_point), the zero point a float of
    integral value."""
    qmax, qmin = bit_type.upper_bound, bit_type.lower_bound
    if symmetric:
        max_val = torch.maximum(-stats.min_val, stats.max_val)
        scale = torch.clamp(max_val / _f32(float(qmax - qmin) / 2, max_val), min=EPS)
        return scale, torch.zeros_like(scale)
    scale = torch.clamp((stats.max_val - stats.min_val) / _f32(float(qmax - qmin), stats.max_val), min=EPS)
    zero_point = torch.clamp(qmin - torch.round(stats.min_val / scale), qmin, qmax)
    return scale, zero_point


OMSE_STEPS = 90


def omse_params(stats: MinMaxStats, x: torch.Tensor, bit_type: BitType):
    """OMSE range-shrink search: the range shrunk by ``1 − 0.01·i`` for i in
    0..89, each candidate (scale, zp) scored by the L2 fake-quant error of
    ``x``; the first minimum wins (strict improvement only, as the
    reference). Returns (scale, zero_point)."""
    qmax, qmin = bit_type.upper_bound, bit_type.lower_bound
    steps = 1.0 - 0.01 * torch.arange(OMSE_STEPS, dtype=torch.float32, device=x.device)
    span = _f32(float(qmax - qmin), x)
    scales, zps, losses = [], [], []
    for step in steps:
        new_max = stats.max_val * step
        new_min = stats.min_val * step
        scale = torch.clamp((new_max - new_min) / span, min=EPS)
        zp = torch.clamp(qmin - torch.round(new_min / scale), qmin, qmax)
        losses.append(lp_loss(x, fake_quant(x, scale, zp, bit_type)))
        scales.append(scale)
        zps.append(zp)
    idx = torch.argmin(torch.stack(losses))  # the first minimum
    return torch.stack(scales)[idx], torch.stack(zps)[idx]


def _pot_candidate_scales(scale0: torch.Tensor):
    """The 4 candidate PoT scales 2^(floor(log2 s0) + {-1,0,1,2}), stacked on
    a leading axis: [4] or [4, C]."""
    af = torch.floor(torch.log2(torch.clamp(scale0, min=EPS)))
    offs = torch.tensor(POT_CANDIDATE_OFFSETS, dtype=af.dtype, device=af.device)
    alphas = af[None, ...] + offs.reshape((-1,) + (1,) * af.ndim)
    return af, 2.0**alphas


def _symmetric_scale0(stats: MinMaxStats, bit_type: BitType):
    qmax, qmin = bit_type.upper_bound, bit_type.lower_bound
    max_val = torch.maximum(-stats.min_val, stats.max_val)
    return max_val / (float(qmax - qmin) / 2)


def minmax_pot_act_params(stats: MinMaxStats, x: torch.Tensor, bit_type: BitType):
    """Layer-wise symmetric PoT scale for an activation: each candidate
    fake-quantizes the calibration tensor; the first minimum of the L2 loss
    wins. Returns (scale, zero_point) scalars."""
    scale0 = _symmetric_scale0(stats, bit_type)
    af, cand = _pot_candidate_scales(scale0)
    losses = torch.stack([lp_loss(x, fake_quant(x, s, 0.0, bit_type)) for s in cand])
    idx = torch.argmin(losses)
    alpha = af - 1.0 + idx.to(af.dtype)
    scale = torch.clamp(2.0**alpha, min=EPS)
    return scale, torch.zeros_like(scale)


def minmax_pot_weight_params(
    stats: MinMaxStats,
    weight2d: torch.Tensor,
    x2d: torch.Tensor,
    bit_type: BitType,
    channel_wise: bool,
):
    """Output-aware PoT weight scale: for each candidate exponent, the L2
    loss of the LAYER OUTPUT (x @ Wᵀ) against fp, per out-channel when
    ``channel_wise``. Bias cancels in the difference and is omitted.

    Args:
      weight2d: (O, K) folded weight. x2d: (M, K) folded calibration input.
    Returns (scale, zero_point): shape [O] if channel_wise else scalars.
    """
    scale0 = _symmetric_scale0(stats, bit_type)
    af, cand = _pot_candidate_scales(scale0)
    out_fp = x2d @ weight2d.T
    if channel_wise:
        losses = torch.stack([
            ((out_fp - x2d @ fake_quant(weight2d, s_c[:, None], 0.0, bit_type).T) ** 2).mean(dim=0)
            for s_c in cand
        ])
        idx = torch.argmin(losses, dim=0)
    else:
        losses = torch.stack([
            ((out_fp - x2d @ fake_quant(weight2d, s, 0.0, bit_type).T) ** 2).mean()
            for s in cand
        ])
        idx = torch.argmin(losses)
    alpha = af - 1.0 + idx.to(af.dtype)
    scale = torch.clamp(2.0**alpha, min=EPS)
    return scale, torch.zeros_like(scale)


def ptf_params(stats: MinMaxStats, x: torch.Tensor, bit_type: BitType):
    """Per-channel power-of-two-factor scale for LayerNorm inputs: one global
    symmetric scale8 (not PoT-rounded), then per channel a multiplier in
    {1,2,4,8} on scale8/8 minimizing the channel's fake-quant L2 error.

    Returns (scale[C], zero_point scalar 0, mask[C] in {1,2,4,8}).
    """
    qmax, qmin = bit_type.upper_bound, bit_type.lower_bound
    max_val_t = torch.maximum(-stats.min_val.amin(), stats.max_val.amax())
    scale8 = torch.clamp(2.0 * max_val_t / float(qmax - qmin), min=EPS)
    scale1 = scale8 / 8.0
    scales = torch.stack([scale1, scale1 * 2, scale1 * 4, scale8])
    lead = tuple(range(x.ndim - 1))
    losses = torch.stack([
        ((x - fake_quant(x, s, 0.0, bit_type)) ** 2).mean(dim=lead) for s in scales
    ])
    idx = torch.argmin(losses, dim=0)
    mask = 2.0 ** idx.to(torch.float32)
    scale = scale1 * mask
    zero_point = torch.zeros((), dtype=torch.float32, device=x.device)
    return scale, zero_point, mask

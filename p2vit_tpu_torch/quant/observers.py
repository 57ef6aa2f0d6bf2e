"""Range observers and scale solvers, incl. the P²-ViT PoT search
(counterpart of ``p2vit_tpu/quant/observers.py``).

Ported: running min/max statistics, the minmax observer with the
4-candidate power-of-two search (activations and output-aware weights), and
the PTF observer for LayerNorm inputs. The ema, percentile and omse
observers are not ported yet (ROADMAP.md, queue 1) and raise.

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


def _not_ported(name: str):
    raise NotImplementedError(
        f"the {name} observer is not ported to p2vit_tpu_torch yet; it is "
        "listed in ROADMAP.md (queue 1). Use quant_method='minmax'."
    )


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

"""Per-node calibration solvers (counterpart of ``p2vit_tpu/quant/solve.py``).

Observe one calibration tensor, emit its quantization parameters, for every
activation method of the reference CLI (``ACT_METHODS``). Multi-batch
statistics accumulate through ``accumulate_act_stats(..., prev=)`` and reach
the solve through ``stats``.
"""

from __future__ import annotations

import torch

from .bit_type import WEIGHT_CALIB_BIT_TYPES, BitType
from .fake_quant import fake_quant, lp_loss, weight_scale_reshape
from .observers import (
    MinMaxStats,
    collect_minmax,
    collect_percentile,
    float_scale_params,
    merge_ema,
    merge_minmax,
    merge_percentile,
    minmax_pot_act_params,
    minmax_pot_weight_params,
    omse_params,
    ptf_params,
)

ACT_METHODS = ("minmax", "ema", "omse", "percentile", "ptf")


def accumulate_act_stats(method: str, x: torch.Tensor, prev: MinMaxStats | None = None) -> MinMaxStats:
    """Observe one calibration batch for an activation node, merged into the
    running stats of earlier batches (``prev=None``: this batch alone).

    minmax, omse and ptf keep the running min/max (ptf per channel, the
    others layer-wise); ema merges the layer-wise min/max by EMA; percentile
    merges its clipped range by EMA."""
    if method == "ptf":
        cur = collect_minmax(x, "activation", layer_wise=False)
        return cur if prev is None else merge_minmax(prev, cur)
    if method == "percentile":
        cur = collect_percentile(x, "activation")
        return cur if prev is None else merge_percentile(prev, cur)
    if method not in ACT_METHODS:
        raise NotImplementedError(method)
    cur = collect_minmax(x, "activation", layer_wise=True)
    if prev is None:
        return cur
    if method == "ema":
        return merge_ema(prev, cur)
    return merge_minmax(prev, cur)


def solve_act(method: str, x: torch.Tensor, bit_type: BitType, stats: MinMaxStats | None = None):
    """(scale, zero_point) for one activation node, all on the symmetric
    path; ``ptf`` also returns its mask: (scale[C], zp, mask[C]).

    minmax: the 4-candidate PoT search; ema and percentile: the plain float
    scale of their range; omse: the 90-step range-shrink search; ptf: the
    per-channel power-of-two factor. ``stats`` defaults to this batch's."""
    if method == "ptf":
        if stats is None:
            stats = collect_minmax(x, "activation", layer_wise=False)
        return ptf_params(stats, x, bit_type)
    if method == "percentile":
        if stats is None:
            stats = collect_percentile(x, "activation")
        return float_scale_params(stats, bit_type, symmetric=True)
    if method not in ACT_METHODS:
        raise NotImplementedError(method)
    if stats is None:
        stats = collect_minmax(x, "activation", layer_wise=True)
    if method == "minmax":
        return minmax_pot_act_params(stats, x, bit_type)
    if method == "ema":
        return float_scale_params(stats, bit_type, symmetric=True)
    return omse_params(stats, x, bit_type)


def solve_weight_all_bits(weight2d: torch.Tensor, x2d: torch.Tensor):
    """Per-bit-type output-aware PoT weight scales and weight L2 distances.

    Sweeps [uint3, uint4, int4, int8]: layer-wise for int8, channel-wise
    otherwise, all on the symmetric path (the reference never rebinds its
    observer's ``symmetric`` flag, so the unsigned formats clamp negative
    weights to 0).

    Returns wscale (n_bits, O), one row per ``WEIGHT_CALIB_BIT_TYPES`` entry
    (the int8 scalar broadcast over O), and distance (n_bits,).
    """
    o = weight2d.shape[0]
    scales, dists = [], []
    for bt in WEIGHT_CALIB_BIT_TYPES:
        channel_wise = bt.name != "int8"
        stats = collect_minmax(weight2d, "weight", layer_wise=not channel_wise)
        scale, _ = minmax_pot_weight_params(stats, weight2d, x2d, bt, channel_wise)
        wq = fake_quant(weight2d, weight_scale_reshape(scale, 2), 0.0, bt)
        dists.append(lp_loss(weight2d, wq))
        scales.append(torch.broadcast_to(scale, (o,)))
    return torch.stack(scales), torch.stack(dists)

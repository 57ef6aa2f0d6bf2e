"""Per-node calibration solvers (counterpart of ``p2vit_tpu/quant/solve.py``).

Observe one calibration tensor, emit its quantization parameters. Only the
methods whose observers are ported are served here: ``minmax`` for
activations and ``ptf`` for LayerNorm inputs.
"""

from __future__ import annotations

import torch

from .bit_type import WEIGHT_CALIB_BIT_TYPES, BitType
from .fake_quant import fake_quant, lp_loss, weight_scale_reshape
from .observers import (
    MinMaxStats,
    _not_ported,
    collect_minmax,
    merge_minmax,
    minmax_pot_act_params,
    minmax_pot_weight_params,
    ptf_params,
)

ACT_METHODS = ("minmax", "ptf")


def _check_method(method: str):
    if method in ("ema", "omse", "percentile"):
        _not_ported(method)
    if method not in ACT_METHODS:
        raise NotImplementedError(method)


def accumulate_act_stats(method: str, x: torch.Tensor, prev: MinMaxStats | None = None) -> MinMaxStats:
    """Observe one calibration batch for an activation node, merged into the
    running stats of earlier batches (``prev=None``: this batch alone)."""
    _check_method(method)
    cur = collect_minmax(x, "activation", layer_wise=method != "ptf")
    return cur if prev is None else merge_minmax(prev, cur)


def solve_act(method: str, x: torch.Tensor, bit_type: BitType, stats: MinMaxStats | None = None):
    """(scale, zero_point) for one activation node; ``ptf`` also returns its
    mask: (scale[C], zp, mask[C])."""
    _check_method(method)
    if method == "ptf":
        if stats is None:
            stats = collect_minmax(x, "activation", layer_wise=False)
        return ptf_params(stats, x, bit_type)
    if stats is None:
        stats = collect_minmax(x, "activation", layer_wise=True)
    return minmax_pot_act_params(stats, x, bit_type)


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

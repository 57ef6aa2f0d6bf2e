"""PoT-rounded SmoothQuant channel scaling (counterpart of
``p2vit_tpu/quant/smoothquant.py``).

The activation outlier energy moves into the weight through a
per-input-channel scale rounded to a power of two, so the smoothing
division is an exponent shift in the integer serving path.
"""

from __future__ import annotations

import torch

from .fake_quant import round_to_pot
from .observers import EPS

# alpha pools of the reference: attention qkv and MLP fc1
ATTN_ALPHA_POOL = (0.35,)
MLP_ALPHA_POOL = (0.5,)


def pot_smooth_channel_scale(x: torch.Tensor, weight: torch.Tensor, alpha: float):
    """``2^round_to_pot(max|x|^alpha / max(max|W|^(1-alpha), eps))`` per input
    channel. x: (..., C) activation; weight: (O, C). Returns (C,)."""
    global_max_x = x.abs().reshape(-1, x.shape[-1]).amax(dim=0)
    max_weight = weight.abs().amax(dim=0)
    channel_scale = global_max_x**alpha / torch.clamp(max_weight ** (1.0 - alpha), min=EPS)
    exp = round_to_pot(torch.clamp(channel_scale, min=EPS))
    return 2.0**exp

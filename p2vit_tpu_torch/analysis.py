"""Activation-distribution analysis and plotting (counterpart of
``p2vit_tpu/analysis.py``).

``collect_activations`` runs the float ViT forward and returns the seven
attention- and MLP-path tensors of the chosen blocks; ``channel_ranges``
gives their per-channel max and min; ``plot_distribution`` draws those as
one SVG per tensor. matplotlib is imported only inside
``plot_distribution``, and its absence raises there, naming it.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from .models import vit
from .models.common import ViTConfig


@torch.no_grad()
def collect_activations(params, cfg: ViTConfig, x, blocks=None) -> dict:
    """The float forward (``vit.fp_forward``), capturing {name: tensor} for
    the selected blocks (default: the last): ``block{i}.attn_in``,
    ``.qkv_out``, ``.attn_scores``, ``.attn_v``, ``.proj_out``, ``.mlp_in``,
    ``.mlp_out``."""
    blocks = set([cfg.depth - 1] if blocks is None else blocks)
    acts: dict = {}

    def hook(i, name, t):
        if i in blocks:
            acts[f"block{i}.{name}"] = t

    vit.fp_forward(params, cfg, x, hook=hook)
    return acts


def channel_ranges(act) -> tuple:
    """Per-channel (max, min) over all leading dims, as numpy arrays."""
    a = act.detach().cpu().numpy() if isinstance(act, torch.Tensor) else np.asarray(act)
    m = a.reshape(-1, a.shape[-1])
    return m.max(axis=0), m.min(axis=0)


def plot_distribution(acts: dict, name: str, quant: bool, outdir: str = "figs"):
    """Per-channel max/min line plots, one SVG per activation, written as
    ``{outdir}/{name}_{key}_{quant|fp}.svg``; returns the paths. Raises
    ImportError, naming matplotlib, where it is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError("plot_distribution needs matplotlib, which is not installed here") from e

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(outdir, exist_ok=True)
    tag = "quant" if quant else "fp"
    paths = []
    for key, act in acts.items():
        mx, mn = channel_ranges(act)
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(mx, label="max", linewidth=0.8)
        ax.plot(mn, label="min", linewidth=0.8)
        ax.set_title(f"{name} {key} ({tag})")
        ax.set_xlabel("channel")
        ax.legend()
        path = os.path.join(outdir, f"{name}_{key}_{tag}.svg")
        fig.savefig(path)
        plt.close(fig)
        paths.append(path)
    return paths

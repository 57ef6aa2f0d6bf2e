"""Seeded weights and images, made on the device in a few large calls.

One CUDA ``torch.Generator`` seeded with the run's seed draws, in this
order, every truncated-normal weight (one call over a flat buffer), then
the calibration images, then the request images; zero biases and unit
LayerNorm weights are views of one zero and one unit buffer. The same seed
gives the same tensors, so the reference draws its own copy.
"""

from __future__ import annotations

import numpy as np
import torch


def tn(*shape):
    return ("tn", shape)


def zeros(*shape):
    return ("zeros", shape)


def ones(*shape):
    return ("ones", shape)


def _leaves(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaves(v, out)
    elif isinstance(tree, list):
        for v in tree:
            _leaves(v, out)
    elif tree is not None:
        out.append(tree)
    return out


def build(spec, gen: torch.Generator, device) -> dict:
    """The tree ``spec`` (dicts, lists, ``tn``/``zeros``/``ones`` leaves,
    None) with each leaf replaced by a float32 tensor: truncated normal
    σ = 0.02 cut at 2σ, zeros or ones."""
    sizes = {"tn": 0, "zeros": 0, "ones": 0}
    for kind, shape in _leaves(spec, []):
        sizes[kind] += int(np.prod(shape))
    bufs = {k: torch.empty(n, dtype=torch.float32, device=device) for k, n in sizes.items()}
    torch.nn.init.trunc_normal_(bufs["tn"], std=1.0, a=-2.0, b=2.0, generator=gen)
    bufs["tn"].mul_(0.02)
    bufs["zeros"].zero_()
    bufs["ones"].fill_(1.0)
    at = {k: 0 for k in sizes}

    def fill(tree):
        if isinstance(tree, dict):
            return {k: fill(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [fill(v) for v in tree]
        if tree is None:
            return None
        kind, shape = tree
        n = int(np.prod(shape))
        t = bufs[kind][at[kind]:at[kind] + n].view(shape)
        at[kind] += n
        return t

    return fill(spec)


def images(gen: torch.Generator, n: int, size: int, device) -> torch.Tensor:
    """``n`` uniform random uint8 images (n, 3, size, size) on ``device``."""
    return torch.randint(0, 256, (n, 3, size, size), dtype=torch.uint8, generator=gen, device=device)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % 2 ** 64)

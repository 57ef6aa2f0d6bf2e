"""Shared scaffolding of the per-GEMM weight-store tools (counterpart of
the JAX package's ``tools/_gemm_bench.py``): the DeiT-S serving GEMMs, the
depth, the seeded constants and the tools' common command line."""

from __future__ import annotations

import argparse

import numpy as np
import torch

# (name, K, N, gelu): DeiT-S encoder GEMMs in serving order
DEIT_S_GEMMS = (
    ("qkv", 384, 1152, False),
    ("proj", 384, 384, False),
    ("fc1", 384, 1536, True),
    ("fc2", 1536, 384, False),
)
DEPTH = 12
MS = (197, 1576)  # token rows: batch 1 and 8
# the big-K control GEMM at deit_base fc2 width, where the packed stores
# reach their full byte ratios
CONTROL = ("fc2_b", 3072, 768, False)


def make_consts(rng: np.random.RandomState, k: int, n: int, rexp=(-12, -4), device="cpu"):
    """Synthetic per-GEMM constants: int4-valued codes (so every store, the
    packed int4 ones included, serves the same weights), power-of-two row
    scales with exponents in [rexp[0], rexp[1]), and a normal bias.
    Returns (w int8 (n, k), r, b)."""
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    r = (2.0 ** rng.randint(*rexp, n)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (w, r, b))


def layer_consts(rng, depth: int, rexp=(-12, -4), device="cpu"):
    """``depth`` layers of the four DeiT-S GEMMs' constants."""
    return [[make_consts(rng, k, n, rexp, device) for _, k, n, _ in DEIT_S_GEMMS] for _ in range(depth)]


def parse_args(argv, description):
    """The tools' command line: --device, --iters, --depth."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the plain versions")
    ap.add_argument("--iters", type=int, default=20, help="timed calls per window (best of 3 windows)")
    ap.add_argument("--depth", type=int, default=DEPTH, help="layers of the GEMM chain")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit(f"{description.split(':')[0]}: no CUDA device; pass --device cpu to run the "
                         "plain versions on the CPU")
    return args


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"

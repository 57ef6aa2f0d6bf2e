"""Mixed-precision bit allocation: Pareto-frontier sampling + evolutionary
search (counterpart of ``p2vit_tpu/search.py``).

Pure Python and numpy, a copy of the JAX package's module: for the same
``random.Random`` state both give the same configs, fronts and populations.
It follows the reference P²-ViT CLI's search (its test_quant.py:316-463).
The search is sequential; every candidate evaluation is one call of the
caller's ``validate_fn``.

Layout invariants (test_quant.py:329-334): configs pair adjacent layers
(qkv/proj share a bit, fc1/fc2 share a bit), patch-embed is pinned to
max(bit_choice), head is free; the model-size proxy is Σ FLOPs[i]·bits[i]
constrained to ≤ 1.1× the all-4-bit size (:323,336-338).
"""

from __future__ import annotations

import random
from typing import Callable, Sequence

import numpy as np

BIT_CHOICE = (4, 8)


def vit_layout(n: int) -> list:
    """Gene groups for the reference's ViT layout: slot 0 (patch) is pinned
    by the sampler; [qkv,proj] and [fc1,fc2] pairs share one gene; the head
    is its own gene (test_quant.py:329-334)."""
    return [[1 + 2 * i, 2 + 2 * i] for i in range((n - 2) // 2)] + [[n - 1]]


def sample_bit_configs(
    flops: Sequence[int],
    rng: random.Random,
    bit_choice=BIT_CHOICE,
    max_configs: int = 51,
    constraint_ratio: float = 1.1,
    max_attempts: int = 4_000_000,
    layout: list | None = None,
) -> list:
    """Random grouped configs under the model-size constraint
    (test_quant.py:322-341): slot 0 pinned to max(bit_choice), each gene
    group drawn once per candidate (ViT pairing by default; pass
    ``swin.mixed_layout(cfg)[0]`` for Swin's geometry).

    Deliberate fix vs. the reference: its draw loop runs up to 2^(n-1)
    iterations (2^49 for depth-12 ViT) with no attempt bound, which can
    stall for hours when the size constraint makes accepts rare
    (test_quant.py:324-341). Sampling semantics are unchanged; the loop is
    capped at ``max_attempts`` draws and vectorized. The cap must be
    generous: at deit_base geometry the 1.1× budget admits only ~9% of
    FLOPs at 8-bit, an acceptance rate of ~2.7e-5/draw — filling 51
    configs needs ~2M draws (a 50k cap returned an EMPTY front on chip,
    2026-08-19). Vectorized draws keep even the 4M worst case under ~2 s.
    """
    n = len(flops)
    groups = vit_layout(n) if layout is None else layout
    f = np.asarray(flops, dtype=np.float64)
    constraint = constraint_ratio * float(f.sum()) * 4.0
    base = [max(bit_choice)] * n
    base_size = float(np.dot(f, base))
    # per-group size DELTA for each bit choice relative to the all-max base
    bits = np.asarray(bit_choice, dtype=np.float64)
    gsum = np.asarray([f[g].sum() for g in groups])  # (G,)
    delta = gsum[:, None] * (bits[None, :] - max(bit_choice))  # (G, B)
    total = min(2 ** (n - 1), max_attempts)
    # deterministic per rng: derive the numpy stream from the caller's seed
    nprng = np.random.RandomState(rng.randrange(2**32))
    out, seen = [], set()
    chunk = 65_536
    drawn = 0
    while drawn < total and len(out) < max_configs:
        m = min(chunk, total - drawn)
        drawn += m
        idx = nprng.randint(0, len(bit_choice), size=(m, len(groups)))
        sizes = base_size + delta[
            np.arange(len(groups))[None, :], idx
        ].sum(axis=1)
        for row in idx[sizes <= constraint]:
            cand = list(base)
            for g, b in zip(groups, row):
                for s in g:
                    cand[s] = bit_choice[b]
            key = tuple(cand)
            if key not in seen:
                seen.add(key)
                out.append(cand)
                if len(out) >= max_configs:
                    break
    return out


def omega(
    bit_config: Sequence[int],
    global_distance,
    mean_hessian: Sequence[float],
    bit_choice=BIT_CHOICE,
    distances_include_patch: bool = False,
) -> float:
    """Ω(config) = Σ_i mean_hessian[i] · distance[i][k(bit_i)].

    Reference quirk replicated: k is the index of the bit in bit_choice
    (0 or 1), which indexes the 4-column distance rows at the uint3/uint4
    entries — NOT at int4/int8 (the reference CLI's test_quant.py:350-352; the
    distance rows are [uint3, uint4, int4, int8] per
    ptq/layers.py:178-201). The patch-embed slot (i=0) is skipped (:348).

    ``distances_include_patch``: ViT's global_distance has no patch row
    (QConv2d appends none, SURVEY §2.2); Swin's calibration records one per
    weight layer including patch — its row for slot i is i, not i-1.
    """
    gd = np.asarray(global_distance)
    total = 0.0
    for i, bit in enumerate(bit_config):
        if i == 0:
            continue
        k = bit_choice.index(bit)
        row = i if distances_include_patch else i - 1
        total += mean_hessian[i - 1] * float(gd[row][k])
    return total


def pareto_front(
    flops,
    global_distance,
    mean_hessian,
    rng: random.Random,
    bit_choice=BIT_CHOICE,
    constraint_ratio: float = 1.1,
    layout: list | None = None,
    distances_include_patch: bool = False,
) -> list:
    """Sampled configs sorted by ascending Ω (test_quant.py:343-372)."""
    configs = sample_bit_configs(
        flops, rng, bit_choice, constraint_ratio=constraint_ratio, layout=layout
    )
    scored = [
        (c, omega(c, global_distance, mean_hessian, bit_choice,
                  distances_include_patch))
        for c in configs
    ]
    scored.sort(key=lambda t: t[1])
    return scored


def evolutionary_search(
    validate_fn: Callable[[Sequence[int]], float],
    seed_configs: list,
    flops,
    rng: random.Random,
    bit_choice=BIT_CHOICE,
    pop_size: int = 25,
    evo_iter: int = 8,
    mutate_size: int = 10,
    mutate_prob: float = 0.5,
    crossover_size: int = 10,
    crossover_prob: float = 0.5,
    constraint_ratio: float = 1.1,
) -> list:
    """Population search over bit configs (test_quant.py:393-462).

    ``validate_fn(bit_config) -> top1`` is the (expensive) evaluator; the
    reference runs a full ImageNet-val pass per candidate.

    Deliberate fixes vs. the reference:
      * when a mutated/crossed config violates the size constraint, the
        reference re-appends the PREVIOUS candidate's stale accuracy under
        the new config (test_quant.py:420-426); here violating candidates
        are skipped outright.
      * both child loops are attempt-capped, and crossover is skipped
        entirely once the population holds fewer than two DISTINCT configs —
        the reference's ``if p1 == p2: continue`` (test_quant.py:432-436)
        spins forever on a collapsed population, and its mutate loop
        likewise spins when the gene space is smaller than ``mutate_size``
        (same practical-hang standard as sample_bit_configs' cap).
    """
    constraint = constraint_ratio * sum(f * 4 for f in flops)

    def size_ok(cfg):
        return sum(f * b for f, b in zip(flops, cfg)) <= constraint

    population = [(list(c), validate_fn(c)) for c in seed_configs[:pop_size]]
    population.sort(key=lambda t: t[1], reverse=True)

    for _ in range(evo_iter):
        children = []
        seen: list = []
        attempts = 20 * (mutate_size + 1)
        while len(seen) <= mutate_size and attempts > 0:
            attempts -= 1
            old = rng.choice(population)[0]
            new = [
                b if rng.random() < mutate_prob else rng.choice(bit_choice)
                for b in old
            ]
            if new not in seen:
                seen.append(new)
                if size_ok(new):
                    children.append((new, validate_fn(new)))
        seen = []
        attempts = 20 * (crossover_size + 1)
        distinct = len({tuple(c) for c, _ in population}) >= 2
        while distinct and len(seen) <= crossover_size and attempts > 0:
            attempts -= 1
            p1, p2 = rng.choice(population)[0], rng.choice(population)[0]
            if p1 == p2:
                continue
            new = [
                b1 if rng.random() < crossover_prob else b2
                for b1, b2 in zip(p1, p2)
            ]
            if new not in seen:
                seen.append(new)
                if size_ok(new):
                    children.append((new, validate_fn(new)))
        worst = population[-1][1]
        population += [c for c in children if c[1] > worst]
        population.sort(key=lambda t: t[1], reverse=True)
        population = population[:pop_size]
    return population

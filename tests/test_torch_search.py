"""The port's mixed-precision search (``p2vit_tpu_torch/search.py``) and
sensitivity tables against the JAX package's: the same configs, Ω values,
fronts and populations for the same ``random.Random`` seeds, bit for bit.

The inputs are JAX's own: ``vit_flops``/``swin_flops`` and
``mixed_layout`` of zoo geometries, ``MEAN_HESSIAN``, and global distances
drawn from a seed; ``validate_fn`` is a deterministic function of the
config.
"""

import random

import numpy as np
import pytest

from p2vit_tpu import hessian_tables as jtables
from p2vit_tpu import search as jsearch
from p2vit_tpu.models import swin
from p2vit_tpu.models.common import ViTConfig, vit_flops
from p2vit_tpu_torch import hessian_tables as ttables
from p2vit_tpu_torch import search as tsearch
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin

VIT = {"deit_tiny": ViTConfig(embed_dim=192, depth=12, num_heads=3),
       "deit_base": ViTConfig(embed_dim=768, depth=12, num_heads=12)}


def _distances(n_rows, seed):
    return np.random.RandomState(seed).rand(n_rows, 4).astype(np.float32) * 0.01


def _validate(config):
    """A deterministic stand-in for top-1: favors 8-bit early layers."""
    return float(sum(b * (len(config) - i) for i, b in enumerate(config)) % 997) / 9.97


def test_tables_equal_jax():
    assert ttables.MEAN_HESSIAN == jtables.MEAN_HESSIAN
    assert sorted(ttables.MEAN_HESSIAN) == ["deit_base", "deit_tiny"]
    assert all(len(v) == 49 for v in ttables.MEAN_HESSIAN.values())


@pytest.mark.parametrize("n", [6, 10, 50])
def test_layout_and_omega_equal_jax(n):
    assert tsearch.vit_layout(n) == jsearch.vit_layout(n)
    gd = _distances(n - 1, n)
    mh = list(np.random.RandomState(n + 1).rand(n - 1))
    rng = random.Random(5)
    for _ in range(20):
        cfg = [rng.choice((4, 8)) for _ in range(n)]
        assert tsearch.omega(cfg, gd, mh) == jsearch.omega(cfg, gd, mh)
    gd_swin = _distances(n, n + 2)
    assert tsearch.omega(cfg, gd_swin, mh, distances_include_patch=True) == \
        jsearch.omega(cfg, gd_swin, mh, distances_include_patch=True)


@pytest.mark.parametrize("model", list(VIT))
@pytest.mark.parametrize("seed", [0, 7])
def test_pareto_front_and_evolution_equal_jax_vit(model, seed):
    cfg = VIT[model]
    flops = vit_flops(cfg)
    assert tcommon.vit_flops(tcommon.ViTConfig(embed_dim=cfg.embed_dim, depth=12, num_heads=cfg.num_heads)) == flops
    gd, mh = _distances(len(flops) - 1, seed), ttables.MEAN_HESSIAN[model]
    tf = tsearch.pareto_front(flops, gd, mh, random.Random(seed))
    jf = jsearch.pareto_front(flops, gd, mh, random.Random(seed))
    assert tf == jf and 0 < len(tf) <= 51
    assert [o for _, o in tf] == sorted(o for _, o in tf)
    t_rng, j_rng = random.Random(seed + 1), random.Random(seed + 1)
    t_seen, j_seen = [], []
    tp = tsearch.evolutionary_search(lambda c: t_seen.append(list(c)) or _validate(c), [c for c, _ in tf],
                                     flops, t_rng)
    jp = jsearch.evolutionary_search(lambda c: j_seen.append(list(c)) or _validate(c), [c for c, _ in jf],
                                     flops, j_rng)
    assert tp == jp and t_seen == j_seen and len(t_seen) > 25
    assert t_rng.random() == j_rng.random()


def test_pareto_front_and_evolution_equal_jax_swin():
    cfg = swin.SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24))
    tcfg = tswin.SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24))
    flops, layout = swin.swin_flops(cfg), swin.mixed_layout(cfg)[0]
    assert tswin.swin_flops(tcfg) == flops and tswin.mixed_layout(tcfg)[0] == layout
    gd = _distances(len(flops), 3)
    mh = list(np.random.RandomState(4).rand(len(flops) - 1))
    kw = dict(layout=layout, distances_include_patch=True)
    tf = tsearch.pareto_front(flops, gd, mh, random.Random(2), **kw)
    jf = jsearch.pareto_front(flops, gd, mh, random.Random(2), **kw)
    assert tf == jf and len(tf) > 0
    tp = tsearch.evolutionary_search(_validate, [c for c, _ in tf], flops, random.Random(3), pop_size=10,
                                     evo_iter=3)
    jp = jsearch.evolutionary_search(_validate, [c for c, _ in jf], flops, random.Random(3), pop_size=10,
                                     evo_iter=3)
    assert tp == jp


def test_sample_bit_configs_equal_jax_under_a_tight_budget():
    """deit_base at a 1.05× budget: accepts are rare, so the capped draw
    loop decides the count; both give the same configs."""
    flops = vit_flops(VIT["deit_base"])
    t = tsearch.sample_bit_configs(flops, random.Random(11), constraint_ratio=1.05, max_attempts=200_000)
    j = jsearch.sample_bit_configs(flops, random.Random(11), constraint_ratio=1.05, max_attempts=200_000)
    assert t == j
    limit = 1.05 * sum(flops) * 4
    assert all(sum(f * b for f, b in zip(flops, c)) <= limit and c[0] == 8 for c in t)

"""The port's data-free generator (``p2vit_tpu_torch/datafree.py``) against
the JAX package's (``p2vit_tpu/datafree.py``) on the same numpy inputs, at
TINY ViT and TINY Swin.

Tolerances:
* the loss primitives (``total_variation``, ``kde_differential_entropy``,
  ``patch_similarity_entropy``) and ``generation_loss``: 1e-5 relative
  (float32 sums in another order; XLA forms the KDE's divide by the
  constant 2·var as a multiply inside jit);
* ``_cosine_lr``: equal, every step (plain Python on both sides);
* the gradient of ``generation_loss`` (autograd against ``jax.grad``):
  3e-4 in relative norm (measured at these draws: ≤ 1.2e-4 at TINY ViT,
  ≤ 9e-6 at TINY Swin) and the largest entry at the same pixel, since the
  KDE exponentiates squared distances over 2e-4 and amplifies rounding;
* a short ``generate_data`` from the same start: Adam's first steps move a
  pixel by about lr_t·sign(g), so a gradient whose sign rounding decides
  can move a pixel by up to 2·lr_t a step. The test states the share of
  pixels within 1e-4 of JAX's (at least 99 %), and bounds every pixel by
  2·R·Σ lr_t, with R = (1 − β1)/√(1 − β2) / √(1 − β1²/β2) the most an Adam
  step moves per unit learning rate (β1 0.5, β2 0.9: R ≈ 1.86).
"""

import dataclasses
import math
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import datafree as jdf
from p2vit_tpu.models import swin, vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import datafree as tdf
from p2vit_tpu_torch import interop
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models import vit as tvit

VTINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 2), window_size=4)
FAMILIES = {"vit": (VTINY, vit, tcommon.ViTConfig), "swin": (STINY, swin, tswin.SwinConfig)}


def T(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(FAMILIES))
def model(request):
    cfg, jm, tcfg_cls = FAMILIES[request.param]
    params = jm.init_params(jax.random.PRNGKey(2), cfg)

    def jloss(x, labels, var_pred, off, flip):
        return jdf.generation_loss(x, params, cfg, labels, var_pred, off, flip)

    return dict(fam=request.param, cfg=cfg, jm=jm, tcfg=tcfg_cls(**dataclasses.asdict(cfg)), params=params,
                tp=interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
                jgrad=jax.jit(jax.value_and_grad(jloss)))  # one executable a family: off, flip traced


def test_total_variation():
    x = np.random.RandomState(0).randn(3, 3, 17, 13).astype(np.float32)
    assert rel(tdf.total_variation(T(x)), jdf.total_variation(jnp.asarray(x))) < 1e-5


@pytest.mark.parametrize("scale", [0.3, 1.0])
def test_kde_differential_entropy(scale):
    sims = np.tanh(np.random.RandomState(1).randn(4, 300) * scale).astype(np.float32)
    assert rel(tdf.kde_differential_entropy(T(sims)), jdf.kde_differential_entropy(jnp.asarray(sims))) < 1e-5


@pytest.mark.parametrize("drop_cls", [True, False])
def test_patch_similarity_entropy(drop_cls):
    rng = np.random.RandomState(2)
    maps = [rng.randn(2, 17, 32).astype(np.float32) for _ in range(3)]
    got = tdf.patch_similarity_entropy([T(m) for m in maps], drop_cls=drop_cls)
    want = jdf.patch_similarity_entropy([jnp.asarray(m) for m in maps], drop_cls=drop_cls)
    assert rel(got, want) < 1e-5


def test_cosine_lr_every_step():
    for iters in (3, 150):
        assert [tdf._cosine_lr(0.2, it, iters) for it in range(iters)] == [
            jdf._cosine_lr(0.2, it, iters) for it in range(iters)]


def test_attn_tap_and_start_draws(model):
    """``fp_forward(attn_tap=)`` appends one map a block in JAX's order and
    shapes; ``start_image`` is the same on every call and device-free."""
    x = np.random.RandomState(3).randn(2, 3, 32, 32).astype(np.float32)
    def jfwd(p, xx):
        taps = []
        model["jm"].fp_forward(p, model["cfg"], xx, attn_tap=taps)
        return taps

    jt, tt = jax.jit(jfwd)(model["params"], jnp.asarray(x)), []
    (tswin if model["fam"] == "swin" else tvit).fp_forward(model["tp"], model["tcfg"], T(x), attn_tap=tt)
    assert len(tt) == len(jt) == (4 if model["fam"] == "swin" else 2)
    for a, b in zip(tt, jt):
        assert a.shape == b.shape and rel(a, b) < 1e-5
    a = tdf.start_image(model["tcfg"], 2, 5, device="cpu")
    assert torch.equal(a, tdf.start_image(model["tcfg"], 2, 5, device="cpu")) and a.shape == (2, 3, 32, 32)


@pytest.mark.parametrize("off,flip", [(0, False), (3, True), (-5, False)])
def test_generation_loss_and_grad(model, off, flip):
    rng = np.random.RandomState(4)
    im = rng.randn(2, 3, 32, 32).astype(np.float32)
    labels = np.array([1, 7])
    var_pred = 2600.5

    jl, jg = model["jgrad"](jnp.asarray(im), jnp.asarray(labels), var_pred, jnp.asarray(off), jnp.asarray(flip))
    x = T(im).requires_grad_(True)
    tl = tdf.generation_loss(x, model["tp"], model["tcfg"], torch.tensor(labels), var_pred, off, flip)
    (tg,) = torch.autograd.grad(tl, x)
    assert rel(tl.detach(), jl) < 1e-5
    assert rel(tg, jg) < 3e-4
    assert int(np.argmax(np.abs(np.asarray(jg)))) == int(tg.abs().argmax())


def test_short_generate_data_from_the_same_start(model):
    """JAX's ``generate_data(iterations_per_epoch=3)`` against the port's
    loop from JAX's own start (``jax.random.normal(PRNGKey(seed))``) with
    the labels and TV target of ``random.Random(seed)``: 6 Adam steps."""
    seed, b, k = 3, 2, 3
    cfg, tcfg = model["cfg"], model["tcfg"]
    want = np.asarray(jdf.generate_data(model["params"], cfg, batch_size=b, seed=seed, iterations_per_epoch=k))
    start = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (b, 3, cfg.img_size, cfg.img_size)))
    rng = random.Random(seed)
    labels, var_pred = tdf.draw_targets(tcfg, b, rng, torch.device("cpu"))
    seen = []
    got = tdf.optimize(model["tp"], tcfg, T(start), labels, var_pred, rng, iterations_per_epoch=k,
                       on_step=lambda e, i, terms: seen.append((e, i, terms)))
    assert [(e, i) for e, i, _ in seen] == [(e, i) for e in range(2) for i in range(k)]
    assert all(len(t) == 3 and all(bool(torch.isfinite(v)) for v in t) for _, _, t in seen)
    d = np.abs(got.numpy() - want)
    lr_sum = sum(jdf._cosine_lr(0.2, it, k) for it in range(k)) * 2
    r = 0.5 / math.sqrt(0.1) / math.sqrt(1 - 0.25 / 0.9)
    assert (d < 1e-4).mean() >= 0.99
    assert d.max() <= 2 * r * lr_sum
    assert not np.allclose(got.numpy(), start, atol=1e-3)  # the loop moved the images


def test_generate_data_draws_and_device(model):
    """``generate_data`` is ``start_image`` + ``draw_targets`` +
    ``optimize`` on the params' device, with one ``random.Random(seed)``."""
    tcfg = model["tcfg"]
    got = tdf.generate_data(model["tp"], tcfg, batch_size=2, seed=1, iterations_per_epoch=1)
    rng = random.Random(1)
    start = tdf.start_image(tcfg, 2, 1, "cpu")
    labels, var_pred = tdf.draw_targets(tcfg, 2, rng, torch.device("cpu"))
    assert torch.equal(got, tdf.optimize(model["tp"], tcfg, start, labels, var_pred, rng, iterations_per_epoch=1))
    assert got.device.type == "cpu" and got.shape == (2, 3, 32, 32)

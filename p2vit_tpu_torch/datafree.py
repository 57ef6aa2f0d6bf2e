"""PSAQ-ViT-style data-free calibration images (counterpart of
``p2vit_tpu/datafree.py``).

Gaussian-noise images are optimized against the float model so that:

  1. the cross-entropy to random pseudo-labels falls,
  2. the total-variation prior approaches a target drawn from U[2500, 3000],
  3. the differential entropy of a Gaussian KDE over the patch cosine
     similarities of each block's attn@v map rises (the loss subtracts it),

under jitter and flip augmentation, a per-channel colour clip, Adam(0.5,
0.9) and a per-epoch cosine learning rate with a 100-step warm-up. The
attn@v maps come from ``fp_forward(..., attn_tap=)`` of the ViT or Swin
model; the gradient is PyTorch's autograd through it.

``generate_data`` is split so that a caller can feed the loop its own start:
``start_image`` (``torch.randn`` from a ``torch.Generator`` seeded by
``seed``), ``draw_targets`` (the pseudo-labels and the TV target from
``random.Random(seed)``, in the JAX module's order) and ``optimize`` (the
Adam loop, which draws one jitter offset and one flip a step from the same
``random.Random``). JAX draws its start from ``jax.random``, so the two
packages start from different noise unless a caller hands both the same.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from .models import swin, vit
from .models.common import ViTConfig, target_device

_KDE_BANDWIDTH = 0.01
_KDE_POINTS = 10

# ImageNet normalization of the colour clip
_CLIP_MEAN = np.array([0.485, 0.456, 0.406])
_CLIP_STD = np.array([0.229, 0.224, 0.225])


def total_variation(x: torch.Tensor) -> torch.Tensor:
    """Sum of the L2 norms (over the whole flattened array) of the four
    directional pixel differences."""
    d1 = x[:, :, :, :-1] - x[:, :, :, 1:]
    d2 = x[:, :, :-1, :] - x[:, :, 1:, :]
    d3 = x[:, :, 1:, :-1] - x[:, :, :-1, 1:]
    d4 = x[:, :, :-1, :-1] - x[:, :, 1:, 1:]
    return sum(torch.linalg.vector_norm(d) for d in (d1, d2, d3, d4))


def _linspace(lo: torch.Tensor, hi: torch.Tensor, num: int) -> torch.Tensor:
    """``jnp.linspace(lo, hi, num)`` as JAX forms it, differentiable in both
    ends: lo·(1 − s) + hi·s for s = i/(num − 1), then hi itself."""
    step = torch.arange(num - 1, dtype=lo.dtype, device=lo.device) / (num - 1)
    return torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])


def kde_differential_entropy(sims: torch.Tensor) -> torch.Tensor:
    """Differential entropy of a Gaussian KDE over flattened similarities.

    sims: (B, M) per-sample patch-similarity values. The KDE is evaluated at
    10 points spanning the batch's min and max (shared by the batch, so the
    images are coupled) and −p·log(p) is integrated with the trapezoidal
    rule; the mean over the batch is returned.
    """
    b = sims.shape[0]
    xs = _linspace(sims.amin(), sims.amax(), _KDE_POINTS)
    var = _KDE_BANDWIDTH**2
    coef = 1.0 / math.sqrt(2 * math.pi * var)
    diffs = xs[None, :, None] - sims[:, None, :]  # (B, 10, M)
    pdf = (coef * torch.exp(-(diffs**2) / (2 * var))).mean(dim=-1)  # (B, 10)
    pdf = pdf + 1e-4
    f = -pdf * torch.log(pdf)
    return torch.trapezoid(f, xs[None, :].expand(b, -1), dim=-1).mean()


def patch_similarity_entropy(attn_maps, drop_cls: bool = True) -> torch.Tensor:
    """Σ over blocks of the differential entropy of the cosine similarities
    between patch features of each (B, N, C) attn@v map; the class token is
    dropped for ViT (``drop_cls``; Swin windows have none)."""
    total = 0.0
    for a in attn_maps:
        p = a[:, 1:, :] if drop_cls else a
        p = p / torch.clamp(torch.linalg.vector_norm(p, dim=-1, keepdim=True), min=1e-8)
        sims = torch.einsum("bnc,bmc->bnm", p, p)
        total = total + kde_differential_entropy(sims.reshape(a.shape[0], -1))
    return total


def _cosine_lr(base_lr, it, iters, warmup=100):
    """The cosine learning-rate policy with a linear warm-up."""
    if it < warmup:
        return base_lr * (it + 1) / warmup
    e, es = it - warmup, iters - warmup
    return 0.5 * (1 + math.cos(math.pi * e / es)) * base_lr


def generation_terms(im, params, cfg, labels, var_pred, off, flip):
    """(−patch-similarity entropy, cross-entropy, |TV − target|) of one
    jittered view: ``im`` rolled by (off, off) pixels, then mirrored when
    ``flip``."""
    is_vit = isinstance(cfg, ViTConfig)
    im_jit = torch.roll(im, (int(off), int(off)), dims=(2, 3))
    if bool(flip):
        im_jit = torch.flip(im_jit, dims=[3])
    taps: list = []
    logits = (vit if is_vit else swin).fp_forward(params, cfg, im_jit, attn_tap=taps)
    logp = torch.log_softmax(logits, dim=-1)
    loss_oh = -torch.take_along_dim(logp, labels[:, None], dim=1).mean()
    loss_tv = torch.abs(total_variation(im_jit) - var_pred)
    loss_entropy = -patch_similarity_entropy(taps, drop_cls=is_vit)
    return loss_entropy, loss_oh, loss_tv


def _objective(terms):
    loss_entropy, loss_oh, loss_tv = terms
    return loss_entropy + 1.0 * loss_oh + 0.05 * loss_tv


def generation_loss(im, params, cfg, labels, var_pred, off, flip):
    """The PSAQ objective for one jittered view: cross-entropy to the
    pseudo-labels + 0.05 · the TV prior − the patch-similarity entropy."""
    return _objective(generation_terms(im, params, cfg, labels, var_pred, off, flip))


def start_image(cfg, batch_size: int, seed: int, device="cuda") -> torch.Tensor:
    """The optimization's start: (batch_size, 3, H, W) standard normal
    noise from a CPU ``torch.Generator`` seeded by ``seed`` (the same numbers
    on any device), moved to ``device`` (the card unless it says otherwise)."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    shape = (batch_size, 3, cfg.img_size, cfg.img_size)
    return torch.randn(shape, generator=gen).to(target_device(device))


def draw_targets(cfg, batch_size: int, rng: random.Random, device):
    """The pseudo-labels (``batch_size`` ``randint``s) then the TV target
    (one ``uniform``), drawn from ``rng`` in the JAX module's order."""
    labels = torch.tensor([rng.randint(0, cfg.num_classes - 1) for _ in range(batch_size)], device=device)
    return labels, rng.uniform(2500, 3000)


def optimize(params, cfg, img, labels, var_pred, rng: random.Random, iterations_per_epoch: int = 500,
             lr: float = 0.20, on_step=None) -> torch.Tensor:
    """Two epochs of ``iterations_per_epoch`` Adam steps on ``img`` (its
    device is the run's). Each step sets the cosine learning rate on the
    parameter group, draws one jitter offset (``randint(-lim, lim)``, lim 15
    then 30) and one flip (``random() > 0.5``) from ``rng``, takes the
    gradient of ``generation_loss`` by autograd, steps and clips each
    channel to the normalized [0, 1] range. ``on_step(epoch, it, terms)``,
    if given, sees the three detached loss terms of every step. Returns the
    images."""
    img = img.detach().clone().requires_grad_(True)
    opt = torch.optim.Adam([img], lr=lr, betas=(0.5, 0.9), eps=1e-8)
    lo = torch.tensor(-_CLIP_MEAN / _CLIP_STD, dtype=torch.float32, device=img.device)[None, :, None, None]
    hi = torch.tensor((1 - _CLIP_MEAN) / _CLIP_STD, dtype=torch.float32, device=img.device)[None, :, None, None]
    for epoch in range(2):
        lim = 15 if epoch == 0 else 30
        for it in range(iterations_per_epoch):
            opt.param_groups[0]["lr"] = _cosine_lr(lr, it, iterations_per_epoch)
            off = rng.randint(-lim, lim)
            flip = rng.random() > 0.5
            terms = generation_terms(img, params, cfg, labels, var_pred, off, flip)
            (img.grad,) = torch.autograd.grad(_objective(terms), img)
            opt.step()
            with torch.no_grad():
                img.copy_(torch.clamp(img, lo, hi))
            if on_step is not None:
                on_step(epoch, it, tuple(t.detach() for t in terms))
    return img.detach()


def generate_data(params, cfg, batch_size: int = 32, seed: int = 0, iterations_per_epoch: int = 500,
                  lr: float = 0.20, device=None, on_step=None) -> torch.Tensor:
    """Synthesize a calibration batch from Gaussian noise (the CLI's
    ``--mode 2``). ``cfg`` is a ViT or Swin config; the run is on the
    params' device unless ``device`` says otherwise."""
    dev = target_device(device) if device is not None else params["head"]["w"].device
    rng = random.Random(seed)
    img = start_image(cfg, batch_size, seed, dev)
    labels, var_pred = draw_targets(cfg, batch_size, rng, dev)
    return optimize(params, cfg, img, labels, var_pred, rng, iterations_per_epoch, lr, on_step)


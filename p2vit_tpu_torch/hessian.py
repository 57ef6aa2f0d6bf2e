"""Hessian sensitivity engine (counterpart of ``p2vit_tpu/hessian.py``).

The loss is the float forward plus cross-entropy on ``log_softmax``, the
reference's criterion with SmoothQuant off (its Hessian statistics run the
plain fp graph). The Hessian-vector product is a double backward through
the port's ``fp_forward``: one backward with ``create_graph`` gives the
gradient graph, and each product ``H·v`` is one more backward of ``g·v``
through it, for every tracked weight at once.

* ``hessian_traces``: Hutchinson estimates of tr(H) per tracked weight, the
  mean over Rademacher probes of vᵀHv.
* ``hessian_eigenvalues``: the top eigenvalues of the joint Hessian over the
  flattened tracked weights, by power iteration with deflation.
* ``hessian_density``: its spectral density by stochastic Lanczos quadrature.
* ``normalized_mean_hessian``: |trace| min-max normalized per batch, then
  averaged: the table the mixed-precision search weighs distances by.

Probes and start vectors come from the caller's ``torch.Generator`` on the
tensors' device, so the numbers differ from JAX's ``jax.random`` draws for
the same seed. Each estimator has a private core (``_vthv``,
``_eigen_core``, ``_density_core``) that takes its probes or start vectors,
which the tests feed with JAX's own draws.

Tracked weights are the matmul weights in bit-config slot order 1..n-1: the
qkv, proj, fc1 and fc2 weights of every block, Swin's downsample
reductions, and the head; the patch embedding, norms, biases, tokens and
tables are not tracked.
"""

from __future__ import annotations

import torch

from .models import vit
from .models.common import ViTConfig


def tracked_weights(params) -> list:
    """ViT (path, weight) list in bit-config order: per block qkv, proj,
    fc1, fc2; then the head."""
    out = []
    for i, blk in enumerate(params["blocks"]):
        for name in ("qkv", "proj", "fc1", "fc2"):
            out.append(((i, name), blk[name]["w"]))
    out.append((("head", "head"), params["head"]["w"]))
    return out


def _with_weights(params, ws):
    """The ViT params with the tracked weights replaced by ``ws`` (a new
    dict; the other leaves are shared)."""
    ws = iter(ws)
    blocks = [dict(blk, **{name: dict(blk[name], w=next(ws)) for name in ("qkv", "proj", "fc1", "fc2")})
              for blk in params["blocks"]]
    return dict(params, blocks=blocks, head=dict(params["head"], w=next(ws)))


def tracked_weights_swin(params) -> list:
    """Swin (path, weight) list in bit-config slot order 1..n-1: per stage
    (per block qkv, proj, fc1, fc2), the downsample reduction, then the
    head."""
    out = []
    for si, stage in enumerate(params["stages"]):
        for bi, blk in enumerate(stage["blocks"]):
            for name in ("qkv", "proj", "fc1", "fc2"):
                out.append(((si, bi, name), blk[name]["w"]))
        if "downsample" in stage:
            out.append(((si, "downsample"), stage["downsample"]["reduction"]["w"]))
    out.append((("head",), params["head"]["w"]))
    return out


def _with_weights_swin(params, ws):
    ws = iter(ws)
    stages = []
    for stage in params["stages"]:
        new = dict(stage, blocks=[
            dict(blk, **{name: dict(blk[name], w=next(ws)) for name in ("qkv", "proj", "fc1", "fc2")})
            for blk in stage["blocks"]])
        if "downsample" in stage:
            ds = stage["downsample"]
            new["downsample"] = dict(ds, reduction=dict(ds["reduction"], w=next(ws)))
        stages.append(new)
    return dict(params, stages=stages, head=dict(params["head"], w=next(ws)))


def _family(cfg):
    """(fp_forward, tracked, rebuild) for the model family of ``cfg``."""
    if isinstance(cfg, ViTConfig):
        return vit.fp_forward, tracked_weights, _with_weights
    from .models import swin

    return swin.fp_forward, tracked_weights_swin, _with_weights_swin


def _ce_loss(params, cfg, x, labels, ws):
    forward, _, rebuild = _family(cfg)
    logp = torch.log_softmax(forward(rebuild(params, ws), cfg, x), dim=-1)
    return -logp.gather(1, labels.to(torch.int64)[:, None]).mean()


def _leaf_weights(params, cfg) -> list:
    _, tracked, _ = _family(cfg)
    return [w.detach().requires_grad_(True) for _, w in tracked(params)]


def _rademacher(shape, gen: torch.Generator, like: torch.Tensor) -> torch.Tensor:
    r = torch.randint(0, 2, tuple(shape), generator=gen, device=like.device)
    return (2 * r - 1).to(like.dtype)


def _vthv(params, cfg, x, labels, probes) -> torch.Tensor:
    """vᵀHv per tracked weight for each probe set (a list over probes of
    lists over tracked weights): [n_probes, n_weights]."""
    ws = _leaf_weights(params, cfg)
    with torch.enable_grad():
        grads = torch.autograd.grad(_ce_loss(params, cfg, x, labels, ws), ws, create_graph=True)
        out = []
        for vs in probes:
            gv = sum((g * v).sum() for g, v in zip(grads, vs))
            hvs = torch.autograd.grad(gv, ws, retain_graph=True)
            out.append(torch.stack([(v * hv).sum() for v, hv in zip(vs, hvs)]).detach())
    return torch.stack(out)


def hessian_traces(params, cfg, x, labels, generator: torch.Generator, n_probes: int = 16) -> torch.Tensor:
    """Per-weight Hutchinson Hessian-trace estimates of the CE loss: the
    mean over ``n_probes`` Rademacher probes of vᵀHv, [n_weights]. ``cfg``
    is a ViTConfig or a SwinConfig."""
    _, tracked, _ = _family(cfg)
    ws = [w for _, w in tracked(params)]
    probes = [[_rademacher(w.shape, generator, w) for w in ws] for _ in range(n_probes)]
    return _vthv(params, cfg, x, labels, probes).mean(dim=0)


def _flat_hvp(params, cfg, x, labels):
    """(z0, hvp, dim): the CE-loss Hessian-vector product over the tracked
    weights flattened, in order and row-major, to one vector (the joint
    Hessian). The gradient graph is built once, on the first product."""
    ws = _leaf_weights(params, cfg)
    z0 = torch.cat([w.detach().reshape(-1) for w in ws])
    graph = {}

    def hvp(v):
        with torch.enable_grad():
            if not graph:
                grads = torch.autograd.grad(_ce_loss(params, cfg, x, labels, ws), ws, create_graph=True)
                graph["g"] = torch.cat([g.reshape(-1) for g in grads])
            hvs = torch.autograd.grad((graph["g"] * v).sum(), ws, retain_graph=True)
        return torch.cat([h.reshape(-1) for h in hvs])

    return z0, hvp, z0.numel()


def _eigen_core(hvp, starts, max_iter: int = 100, tol: float = 1e-3):
    """Power iteration with deflation from the given start vectors, one per
    eigenvalue; stops when the Rayleigh quotient moves by less than ``tol``
    relative."""
    eigenvalues, eigenvectors = [], []
    for v in starts:
        v = v / torch.linalg.vector_norm(v)
        lam_prev = None
        for _ in range(max_iter):
            for e in eigenvectors:
                v = v - torch.dot(e, v) * e
            v = v / torch.linalg.vector_norm(v)
            hv = hvp(v)
            lam = float(torch.dot(v, hv))
            v = hv / torch.clamp(torch.linalg.vector_norm(hv), min=1e-12)
            if lam_prev is not None and abs(lam - lam_prev) / (abs(lam_prev) + 1e-6) < tol:
                break
            lam_prev = lam
        eigenvalues.append(lam)
        eigenvectors.append(v)
    return eigenvalues, torch.stack(eigenvectors)


def hessian_eigenvalues(params, cfg, x, labels, generator: torch.Generator, top_n: int = 1,
                        max_iter: int = 100, tol: float = 1e-3):
    """Top-``top_n`` Hessian eigenvalues by power iteration with deflation,
    from standard-normal start vectors. Returns (eigenvalues,
    eigenvectors [top_n, dim] over the flattened tracked weights)."""
    z0, hvp, dim = _flat_hvp(params, cfg, x, labels)
    starts = [torch.randn(dim, generator=generator, device=z0.device) for _ in range(top_n)]
    return _eigen_core(hvp, starts, max_iter, tol)


def _density_core(hvp, starts, n_iter: int, draw):
    """Stochastic Lanczos quadrature from the given start vectors, one per
    run: ``n_iter`` Lanczos steps with full reorthogonalization build a
    tridiagonal T; its eigenvalues are the nodes and the squared first
    components of its eigenvectors the weights. ``draw()`` gives a fresh
    start where the recurrence breaks down (β = 0)."""
    eig_list, weight_list = [], []
    for v in starts:
        v = v / torch.linalg.vector_norm(v)
        vs, alphas, betas = [v], [], []
        w = hvp(v)
        alpha = torch.dot(w, v)
        alphas.append(alpha)
        w = w - alpha * v
        for _ in range(n_iter - 1):
            beta = torch.linalg.vector_norm(w)
            betas.append(beta)
            v_next = draw() if float(beta) == 0.0 else w / beta
            for u in vs:
                v_next = v_next - torch.dot(u, v_next) * u
            v_next = v_next / torch.clamp(torch.linalg.vector_norm(v_next), min=1e-12)
            vs.append(v_next)
            w = hvp(v_next)
            alpha = torch.dot(w, v_next)
            alphas.append(alpha)
            w = w - alpha * v_next - betas[-1] * vs[-2]
        t = torch.diag(torch.stack(alphas))
        if betas:
            b = torch.stack(betas)
            t = t + torch.diag(b, 1) + torch.diag(b, -1)
        evals, evecs = torch.linalg.eigh(t)
        eig_list.append([float(e) for e in evals])
        weight_list.append([float(c) ** 2 for c in evecs[0, :]])
    return eig_list, weight_list


def hessian_density(params, cfg, x, labels, generator: torch.Generator, n_iter: int = 50, n_runs: int = 1):
    """Eigenvalue spectral density by stochastic Lanczos quadrature from
    Rademacher start vectors. Returns (eigen_list [n_runs, n_iter],
    weight_list, the same shape)."""
    z0, hvp, dim = _flat_hvp(params, cfg, x, labels)

    def draw():
        return _rademacher((dim,), generator, z0)

    return _density_core(hvp, [draw() for _ in range(n_runs)], n_iter, draw)


def normalized_mean_hessian(trace_batches) -> list:
    """abs → per-batch min-max normalization → mean across batches, as
    Python floats (the reference CLI's live pipeline)."""
    norm = []
    for tr in trace_batches:
        tr = torch.as_tensor(tr).to(torch.float32).abs()
        lo, hi = tr.min(), tr.max()
        norm.append((tr - lo) / (hi - lo))
    return [float(v) for v in torch.stack(norm).mean(dim=0)]

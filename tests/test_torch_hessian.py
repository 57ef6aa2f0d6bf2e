"""The port's Hessian engine (``p2vit_tpu_torch/hessian.py``: double
backward through the port's ``fp_forward``) against the JAX package's
(``jax.jvp`` over ``jax.grad``) on the same numpy params, images, labels and
probes, at TINY ViT and TINY Swin.

* vᵀHv per tracked weight for fixed Rademacher probes: within 5e-3
  relative, the ranking equal (as ``tests/test_hessian_golden.py`` holds
  JAX against the reference's torch double backward);
* the top eigenvalue by power iteration from JAX's own start vector, and
  the top Lanczos node from JAX's own Rademacher start: within 1e-2
  relative;
* ``normalized_mean_hessian`` within 1e-6; the tracked weights in
  bit-config slot order; the public estimators' draws come from the
  caller's generator.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import hessian as jh
from p2vit_tpu.models import swin, vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import hessian as th
from p2vit_tpu_torch import interop
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin

VTINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 2), window_size=4)
FAMILIES = {"vit": (VTINY, vit, tcommon.ViTConfig), "swin": (STINY, swin, tswin.SwinConfig)}


@pytest.fixture(autouse=True)
def one_thread():
    """Double backwards over TINY models are thousands of small ops: one
    PyTorch thread, since a thread per core beside the other test workers
    multiplies their time."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(FAMILIES))
def model(request):
    cfg, jm, tcfg_cls = FAMILIES[request.param]
    params = jm.init_params(jax.random.PRNGKey(1), cfg)
    rng = np.random.RandomState(7)
    x = rng.randn(4, 3, 32, 32).astype(np.float32)
    labels = np.array([0, 3, 1, 7])
    return dict(fam=request.param, cfg=cfg, tcfg=tcfg_cls(**dataclasses.asdict(cfg)), params=params,
                tp=interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
                x=x, labels=labels)


def _jax_loss(m):
    forward, tracked, rebuild = jh._family(m["cfg"])

    def loss(ws):
        logits = forward(rebuild(m["params"], ws), m["cfg"], jnp.asarray(m["x"]))
        logp = jax.nn.log_softmax(logits)
        return -jnp.take_along_axis(logp, jnp.asarray(m["labels"])[:, None], axis=1).mean()

    return loss, [w for _, w in tracked(m["params"])]


def test_tracked_weights_in_slot_order(model):
    jt = jh.tracked_weights(model["params"]) if model["fam"] == "vit" else jh.tracked_weights_swin(model["params"])
    tt = th.tracked_weights(model["tp"]) if model["fam"] == "vit" else th.tracked_weights_swin(model["tp"])
    assert [p for p, _ in jt] == [p for p, _ in tt]
    assert len(tt) == model["cfg"].num_matmuls - 1
    for (_, a), (_, b) in zip(jt, tt):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    # the rebuild replaces exactly the tracked weights
    _, tracked, rebuild = th._family(model["tcfg"])
    new = rebuild(model["tp"], [torch.zeros_like(w) for _, w in tt])
    assert all(float(w.abs().sum()) == 0 for _, w in tracked(new))
    assert torch.equal(new["patch_embed"]["w"], model["tp"]["patch_embed"]["w"])
    assert all(float(w.abs().sum()) > 0 for _, w in tracked(model["tp"]))


def test_vthv_fixed_probes_match_jax(model):
    loss, ws = _jax_loss(model)
    rng = np.random.RandomState(11)
    probes = [[np.where(rng.rand(*w.shape) < 0.5, -1.0, 1.0).astype(np.float32) for w in ws] for _ in range(2)]
    vthv = jax.jit(lambda ws_, vs_: jnp.stack([jnp.vdot(v, hv) for v, hv in zip(
        vs_, jax.jvp(jax.grad(loss), (ws_,), (vs_,))[1])]))
    j = [np.asarray(vthv(ws, [jnp.asarray(v) for v in vs])) for vs in probes]
    j = np.array(j)
    t = th._vthv(model["tp"], model["tcfg"], torch.from_numpy(model["x"]), torch.from_numpy(model["labels"]),
                 [[torch.from_numpy(v) for v in vs] for vs in probes]).numpy()
    assert t.shape == j.shape == (2, model["cfg"].num_matmuls - 1)
    np.testing.assert_allclose(t, j, rtol=5e-3, atol=1e-5)
    for row_t, row_j in zip(t, j):
        assert (np.argsort(row_t) == np.argsort(row_j)).all()


def test_top_eigenvalue_from_jax_start(model):
    key = jax.random.PRNGKey(3)
    lam_j, _ = jh.hessian_eigenvalues(model["params"], model["cfg"], jnp.asarray(model["x"]),
                                      jnp.asarray(model["labels"]), key, top_n=1, max_iter=20)
    _, _, dim = jh._flat_hvp(model["params"], model["cfg"], jnp.asarray(model["x"]), jnp.asarray(model["labels"]))
    start = np.array(jax.random.normal(jax.random.fold_in(key, 0), (dim,)))
    z0, hvp, tdim = th._flat_hvp(model["tp"], model["tcfg"], torch.from_numpy(model["x"]),
                                 torch.from_numpy(model["labels"]))
    assert tdim == dim
    lam_t, vecs = th._eigen_core(hvp, [torch.from_numpy(start)], max_iter=20)
    assert vecs.shape == (1, dim)
    np.testing.assert_allclose(lam_t[0], lam_j[0], rtol=1e-2)


def test_lanczos_top_node_from_jax_start(model):
    key = jax.random.PRNGKey(4)
    eig_j, w_j = jh.hessian_density(model["params"], model["cfg"], jnp.asarray(model["x"]),
                                    jnp.asarray(model["labels"]), key, n_iter=8)
    _, hvp, dim = th._flat_hvp(model["tp"], model["tcfg"], torch.from_numpy(model["x"]),
                               torch.from_numpy(model["labels"]))
    start = np.array(jax.random.rademacher(jax.random.fold_in(key, 0), (dim,), dtype=jnp.float32))
    eig_t, w_t = th._density_core(hvp, [torch.from_numpy(start)], 8, draw=None)
    assert len(eig_t[0]) == len(eig_j[0]) == 8
    np.testing.assert_allclose(max(eig_t[0]), max(eig_j[0]), rtol=1e-2)
    np.testing.assert_allclose(sum(w_t[0]), 1.0, rtol=1e-4)


def test_public_estimators_draw_from_the_generator(model):
    x, lab = torch.from_numpy(model["x"]), torch.from_numpy(model["labels"])
    a = th.hessian_traces(model["tp"], model["tcfg"], x, lab, torch.Generator().manual_seed(5), n_probes=2)
    b = th.hessian_traces(model["tp"], model["tcfg"], x, lab, torch.Generator().manual_seed(5), n_probes=2)
    assert a.shape == (model["cfg"].num_matmuls - 1,) and torch.isfinite(a).all()
    assert torch.equal(a, b)
    lam, vecs = th.hessian_eigenvalues(model["tp"], model["tcfg"], x, lab, torch.Generator().manual_seed(6),
                                       top_n=2, max_iter=5)
    assert len(lam) == 2 and vecs.shape[0] == 2
    assert abs(float(vecs[0] @ vecs[1])) < 0.1  # the second is deflated against the first


def test_normalized_mean_hessian_matches_jax():
    rng = np.random.RandomState(12)
    batches = [(rng.randn(49) * 10 ** rng.uniform(-3, 2, 49)).astype(np.float32) for _ in range(3)]
    j = jh.normalized_mean_hessian([jnp.asarray(b) for b in batches])
    t = th.normalized_mean_hessian([torch.from_numpy(b) for b in batches])
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=1e-7)
    assert min(t) >= 0 and max(t) <= 1
    assert th.normalized_mean_hessian([b.astype(np.float64) for b in batches]) == t

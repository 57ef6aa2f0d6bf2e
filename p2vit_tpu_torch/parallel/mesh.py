"""A ("data", "model") grid of ranks: data parallelism of the serving
program and of the fake-quant forward, and the sharded calibration
statistics (counterpart of ``p2vit_tpu/parallel/mesh.py``).

The JAX package lays n devices out as an (n/mp, mp) array with axes
("data", "model"); here rank r has data index r // mp and model index
r % mp, so the same batch shard and the same weight shard land on the same
position. ``make_mesh`` builds the process groups of both axes once, on
every rank of the world, in one order (``dist.new_group`` must be entered
by every rank). Without an initialized group it returns the layout alone,
which is what the CLI resolves its flags into before it starts the ranks.

Each rank serves its batch shard with the whole (single-device) program and
the logits come back by a host-staged ``all_gather`` over "data":
integer code arithmetic is per example, so the result equals one process's
bit for bit.

The JAX package's GSPMD surfaces, written out with explicit collectives:

* ``param_shardings``/``shard_params``: the megatron placement of a ViT
  params dict over "model" (JAX's ``_leaf_spec``) and one rank's shard of
  it; ``data_parallel_eval`` with a model axis above 1 runs
  ``vit.quant_forward(mesh=)`` on it: qkv and fc1 column-parallel (qkv
  head-aligned), proj and fc2 row-parallel with a SUM ``all_reduce`` of the
  float partial products over "model", the batch over "data". The
  reduction reassociates float sums, so the logits stay within one LSB of
  the output quantizer's grid, as JAX states for its own.
* ``vit.calibrate(mesh=)``: each rank runs the calibration forward on its
  data shard and ``gather_batch``es every node's tensor before its solve,
  so each loss reduces the whole tensor in one process's order and the
  decisions equal one process's: bit for bit where a shard's forward
  rounds as the whole batch's does (the CPU); on the card, where cuBLAS
  picks a GEMM's kernel by its rows, the float PTF scales can move by a few
  ulps, within JAX's rtol 1e-6, and every power-of-two decision is equal.
* ``dp_generation_loss``: the data-free objective on a data shard of the
  images, gathered inside the graph by ``gather_rows`` (an autograd
  function whose backward reduce-scatters), so each rank's gradient is its
  shard of one process's.
"""

from __future__ import annotations

import torch

from ..quant.observers import MinMaxStats
from . import dist as pdist

class Mesh:
    """A (data × model) grid over ranks ``0 .. data·model − 1``.

    ``shape`` is {"data": d, "model": m}. On a rank of an initialized group
    the mesh holds this rank's process group along each axis
    (``group(axis)``) and its index there (``index(axis)``); ``member`` is
    False for a rank outside the grid."""

    def __init__(self, data: int, model: int):
        self.shape = {"data": int(data), "model": int(model)}
        self.size = int(data) * int(model)
        self._groups = _axis_groups(int(data), int(model)) if pdist.initialized() else None

    def __repr__(self):
        return f"Mesh(data={self.shape['data']}, model={self.shape['model']})"

    @property
    def member(self) -> bool:
        return pdist.initialized() and pdist.rank() < self.size

    def index(self, axis: str) -> int:
        r = pdist.rank()
        return r // self.shape["model"] if axis == "data" else r % self.shape["model"]

    def group(self, axis: str):
        if self._groups is None:
            raise RuntimeError("this mesh is a layout only: build it on the ranks of an initialized "
                               "process group (run_ranks, torchrun)")
        if not self.member:
            raise RuntimeError(f"rank {pdist.rank()} is not in {self}")
        # the group along an axis holds the ranks that share the other index
        return self._groups[axis][self.index("model" if axis == "data" else "data")]


def _axis_groups(nd: int, mp: int) -> dict:
    """Every rank's groups along "data" (ranks with one model index) and
    "model" (ranks with one data index), created in one order on all ranks."""
    import torch.distributed as dist

    data = [dist.new_group([d * mp + m for d in range(nd)]) for m in range(mp)]
    model = [dist.new_group([d * mp + m for m in range(mp)]) for d in range(nd)]
    return {"data": data, "model": model}


def make_mesh(n_ranks: int | None = None, model_parallel: int = 1) -> Mesh:
    """A ("data", "model") mesh over the first ``n_ranks`` ranks (default the
    whole world); raises when they do not split into ``model_parallel``
    columns or the world has fewer ranks."""
    world = pdist.world_size() if pdist.initialized() else None
    n = n_ranks or world
    if n is None:
        raise ValueError("make_mesh needs n_ranks outside an initialized process group")
    if n % model_parallel:
        raise ValueError(f"{n} ranks not divisible by model_parallel={model_parallel}")
    if world is not None and n > world:
        raise ValueError(f"a mesh of {n} ranks needs {n} ranks; only {world} in the process group")
    return Mesh(n // model_parallel, model_parallel)


def pad_batch(x: torch.Tensor, quantum: int) -> torch.Tensor:
    """Pad the batch to a multiple of ``quantum`` by repeating the last
    example (eval loops yield a short final batch)."""
    pad = (-x.shape[0]) % quantum
    if not pad:
        return x
    return torch.cat([x, x[-1:].expand(pad, *x.shape[1:])], dim=0)


def shard_batch(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """This rank's block of the batch along "data" (leading dim divisible
    by the data axis)."""
    nd = mesh.shape["data"]
    if x.shape[0] % nd:
        raise ValueError(f"batch {x.shape[0]} does not split over the data axis {nd}")
    per = x.shape[0] // nd
    i = mesh.index("data")
    return x[i * per:(i + 1) * per]


def replicate(tree, mesh: Mesh):
    """The identity: every rank already holds its own copy."""
    return tree


def gather_batch(mesh: Mesh, out: torch.Tensor) -> torch.Tensor:
    """The data shards' outputs, concatenated in data order on every rank."""
    return pdist.all_gather_rows(out.contiguous(), mesh.group("data"))


def sharded_minmax_stats(mesh: Mesh, x: torch.Tensor) -> MinMaxStats:
    """Per-channel min/max of a batch sharded over "data": each rank reduces
    its shard, then MIN/MAX ``all_reduce`` over "data". Equals
    ``collect_minmax(x, "activation", layer_wise=False)`` of the global batch
    exactly (min and max are associative)."""
    m = shard_batch(mesh, x)
    m = m.reshape(-1, m.shape[-1])
    g = mesh.group("data")
    return MinMaxStats(min_val=pdist.all_reduce(m.amin(dim=0), "min", g),
                       max_val=pdist.all_reduce(m.amax(dim=0), "max", g))


def dp_serving_fn(inner, mesh: Mesh):
    """Wrap a per-batch serving callable for data-parallel eval over the
    mesh's "data" axis: pad the batch to a multiple of the data axis
    (repeating the last example), serve this rank's shard with ``inner``,
    ``all_gather`` the logits over "data", trim the pad rows. Every rank
    returns the whole batch's logits.

    ``inner(x, *args, **kwargs) -> logits`` must be per-example math (the
    int8 serving pipelines are), so the result equals one process's bit for
    bit."""
    nd = mesh.shape["data"]

    def fn(x, *args, **kwargs):
        b = x.shape[0]
        out = inner(shard_batch(mesh, pad_batch(x, nd)), *args, **kwargs)
        return gather_batch(mesh, out)[:b]

    return fn


def data_parallel_eval(forward, mesh: Mesh, params, *args):
    """``run(x, *rest) = forward(params, *args, x_shard, *rest)`` over the
    data axis, logits gathered on every rank: DP of the fake-quant forward
    (``vit.quant_forward``), whose math is per example. With a model axis
    above 1, ``forward`` also gets ``mesh=mesh`` and runs megatron TP over
    "model" (``vit.quant_forward(mesh=)``; the params stay whole on every
    rank, which slices its shard with ``shard_params``)."""
    if mesh.shape["model"] == 1:
        run = dp_serving_fn(lambda x, *rest: forward(params, *args, x, *rest), mesh)
    else:
        run = dp_serving_fn(lambda x, *rest: forward(params, *args, x, *rest, mesh=mesh), mesh)
    return torch.no_grad()(run)


# ---------------------------------------------------------------------------
# Megatron placement of the ViT params over "model"
# ---------------------------------------------------------------------------


def _leaf_spec(path: str) -> tuple:
    """The megatron placement of a ViT param leaf (JAX's ``_leaf_spec``):
    qkv/fc1 (out, in) split by out-features over "model" (column parallel),
    proj/fc2 by in-features (row parallel), the qkv/fc1 biases with their
    out-features; everything else (LN, the proj/fc2 biases, embeddings,
    head) replicated, ``()``."""
    if path.endswith("qkv.w") or path.endswith("fc1.w"):
        return ("model", None)
    if path.endswith("proj.w") or path.endswith("fc2.w"):
        return (None, "model")
    if path.endswith("qkv.b") or path.endswith("fc1.b"):
        return ("model",)
    return ()


def _map_paths(tree, fn, path=""):
    if isinstance(tree, dict):
        return {k: _map_paths(v, fn, f"{path}.{k}" if path else str(k)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_paths(v, fn, f"{path}.{i}") for i, v in enumerate(tree))
    return fn(path, tree)


def param_shardings(params) -> dict:
    """The placement of each leaf of a ViT params dict: a tuple naming, per
    dimension, the mesh axis it is split over (``"model"``) or ``None``;
    ``()`` for a replicated leaf. The tree has the params' structure."""
    return _map_paths(params, lambda path, _: _leaf_spec(path))


def model_slice(t: torch.Tensor, mesh: Mesh, dim: int, num_heads: int | None = None) -> torch.Tensor:
    """This rank's block of ``t`` along ``dim`` split over "model", as a new
    tensor (a view would keep the whole's alignment, not the shard's). With
    ``num_heads``, ``dim`` holds a fused qkv's [q; k; v] rows, taken
    head-aligned: the rank's heads' q, k and v (``tensor._qkv_tp_perm``)."""
    mp, i = mesh.shape["model"], mesh.index("model")
    dim = dim % t.ndim
    if num_heads is not None:
        from .tensor import _qkv_tp_perm

        perm = torch.as_tensor(_qkv_tp_perm(t.shape[dim] // 3, num_heads, mp), device=t.device)
        t = t.index_select(dim, perm)
    per = t.shape[dim] // mp
    return t.narrow(dim, i * per, per).contiguous()


def shard_params(params: dict, mesh: Mesh, num_heads: int) -> dict:
    """This rank's shard of a ViT params dict along "model" per
    ``param_shardings``: each split leaf cut to the rank's block of the
    named dimension (the qkv weight and bias head-aligned, ``num_heads``
    heads in all); replicated leaves as they are."""
    def one(path, leaf):
        spec = _leaf_spec(path)
        if "model" not in spec:
            return leaf
        return model_slice(leaf, mesh, spec.index("model"), num_heads if ".qkv." in f".{path}" else None)

    return _map_paths(params, one)


# ---------------------------------------------------------------------------
# The data-free generation objective, data-parallel
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    """``all_gather_rows`` over a group inside the graph; its backward
    reduce-scatters the gradient rows, each rank keeping the sum of every
    rank's gradient for its own block."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return pdist.all_gather_rows(x, group)

    @staticmethod
    def backward(ctx, grad):
        return pdist.reduce_scatter_rows(grad.contiguous(), ctx.group), None


def gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The data shards of ``x`` concatenated in data order, differentiably."""
    return _GatherRows.apply(x, mesh.group("data"))


def dp_generation_loss(im_shard, params, cfg, labels, var_pred, off, flip, mesh: Mesh):
    """The data-free objective (``datafree.generation_loss``) of the whole
    batch from this rank's data shard of the images: the KDE entropy and the
    TV prior couple the images across the batch, so the shards are gathered
    inside the graph (``gather_rows``) and every rank evaluates the whole
    objective, divided by the data axis; the backward's reduce-scatter then
    sums the ranks' equal shares, and each rank's gradient is its block of
    one process's (within the float reassociation of that sum)."""
    from .. import datafree

    nd = mesh.shape["data"]
    return datafree.generation_loss(gather_rows(im_shard, mesh), params, cfg, labels, var_pred, off, flip) / nd

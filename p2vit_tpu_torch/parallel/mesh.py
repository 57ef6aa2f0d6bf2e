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
bit for bit. The JAX package's GSPMD-annotated DP×TP of the fake-quant
forward (``param_shardings``; ``data_parallel_eval`` with a model axis above
1) and the sharded calibration have no counterpart yet (ROADMAP.md queue 1).
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
    (``vit.quant_forward``), whose math is per example. A model axis above 1
    (the JAX package's GSPMD-annotated DP×TP) is not ported."""
    if mesh.shape["model"] != 1:
        raise NotImplementedError("data_parallel_eval with a model axis above 1 (GSPMD DP×TP of the "
                                  "fake-quant forward) is not ported: ROADMAP.md queue 1")
    run = dp_serving_fn(lambda x, *rest: forward(params, *args, x, *rest), mesh)
    return torch.no_grad()(run)

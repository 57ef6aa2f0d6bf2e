"""Pipeline parallelism for the int8 ViT serving path, GPipe-style
(counterpart of ``p2vit_tpu/parallel/pipeline.py``).

The encoder's L layers split into S contiguous stages on ranks 0 .. S−1.
Microbatches of (h, xc) int8 codes, the fused-layer kernel's boundary
interface and the narrowest wire format (2·B·N·C bytes a hop), go from
stage to stage by host-staged ``send``/``recv``. Each stage holds only its
own layers' constants (``serving.stack_layer_consts`` sliced by stage) and
runs each layer in ``apply_fused_layer`` (``fused_vit_layer`` on the card,
its plain version on the CPU). The schedule is GPipe's fill and drain over
n_micro + S − 1 ticks: stage s works on microbatch t − s at tick t, so the
bubble ticks run nothing. Stage 0 runs the embed prologue (the JAX
schedule runs it replicated; the other stages never read it); the last
stage broadcasts the final codes to the others, as the JAX schedule's
``psum`` over "stage" does, and every stage runs the head. PP changes only
where each layer runs: the logits equal one process's
``serving_forward(fuse_layer=True)`` bit for bit.
"""

from __future__ import annotations

import torch

from .. import serving
from ..models.common import ViTConfig
from . import dist as pdist
from .mesh import pad_batch


class PipelineMesh:
    """A 1-D ("stage",) group over ranks 0 .. S−1."""

    def __init__(self, n_stages: int, group=None):
        self.shape = {"stage": int(n_stages)}
        self.size = int(n_stages)
        self._group = group

    def __repr__(self):
        return f"PipelineMesh(stage={self.shape['stage']})"

    @property
    def member(self) -> bool:
        return pdist.initialized() and pdist.rank() < self.shape["stage"]

    @property
    def stage(self) -> int:
        return pdist.rank()

    @property
    def group(self):
        if self._group is None:
            raise RuntimeError("this pipeline mesh is a layout only: build it on the ranks of an "
                               "initialized process group (run_ranks, torchrun)")
        return self._group


def make_pipeline_mesh(n_stages: int) -> PipelineMesh:
    """The first ``n_stages`` ranks as a pipeline. Called on every rank of an
    initialized group, it creates the stage group there and raises when the
    group has fewer ranks; outside one it returns the layout only."""
    if not pdist.initialized():
        return PipelineMesh(n_stages)
    world = pdist.world_size()
    if world < n_stages:
        # never truncate silently: the caller would believe it ran S stages
        raise ValueError(f"{n_stages}-stage pipeline needs {n_stages} ranks; only {world} available")
    import torch.distributed as dist

    return PipelineMesh(n_stages, dist.new_group(list(range(n_stages))))


def stage_layers(s, cfg: ViTConfig, mesh: PipelineMesh) -> list:
    """This stage's slice of ``stack_layer_consts``, one tuple per layer."""
    n_st = mesh.shape["stage"]
    depth = len(s["blocks"])
    if depth % n_st:
        raise ValueError(f"depth {depth} not divisible by {n_st} stages")
    per = depth // n_st
    consts = serving.stack_layer_consts(s, cfg)
    lo = mesh.stage * per
    # fresh tensors: a view at an offset may break the kernels' 16-byte alignment
    return [tuple(c[li].clone(memory_format=torch.contiguous_format) for c in consts) for li in range(lo, lo + per)]


@torch.no_grad()
def pipeline_serving_forward(s, cfg: ViTConfig, x, mesh: PipelineMesh, n_micro: int = 2, lis: bool = True,
                             layers=None):
    """Int8 serving with the encoder pipelined over the mesh's stages, on
    each stage rank; returns the batch's float32 logits on every one.
    Raises unless the stages divide the depth and ``n_micro`` the batch.

    ``layers``: this stage's ``stage_layers`` (formed here if not given)."""
    n_st = mesh.shape["stage"]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} not divisible by {n_micro} microbatches")
    if layers is None:
        layers = stage_layers(s, cfg, mesh)
    st = mesh.stage
    bm = b // n_micro
    if st == 0:
        h, xc = serving.embed_codes(s, cfg, x)
    shape = (bm, cfg.seq_len, cfg.embed_dim)
    outs = []
    for t in range(n_micro + n_st - 1):
        m = t - st
        if not 0 <= m < n_micro:
            continue  # a bubble tick of this stage
        if st == 0:
            cur = (h[m * bm:(m + 1) * bm], xc[m * bm:(m + 1) * bm])
        else:
            cur = tuple(pdist.recv(shape, torch.int8, st - 1, x.device) for _ in range(2))
        for layer in layers:
            cur = serving.apply_fused_layer(cfg, layer, *cur, lis)
        if st < n_st - 1:
            for v in cur:
                pdist.send(v, st + 1)
        else:
            outs.append(cur[0])
    h_out = torch.cat(outs) if outs else torch.empty((b, *shape[1:]), dtype=torch.int8, device=x.device)
    h_out = pdist.broadcast(h_out, n_st - 1, mesh.group)
    return serving.head_logits(s, h_out)


def pp_serving_fn(s, cfg: ViTConfig, mesh: PipelineMesh, n_micro: int = 2, lis: bool = True):
    """Per-batch callable for pipeline-parallel serving on each stage rank:
    pad the batch to a multiple of ``n_micro`` (repeating the last example),
    run the GPipe schedule, trim the pad rows. The stage's layer constants
    are formed once here (raising unless the stages divide the depth)."""
    layers = stage_layers(s, cfg, mesh)

    def fn(x):
        b = x.shape[0]
        return pipeline_serving_forward(s, cfg, pad_batch(x, n_micro), mesh, n_micro, lis, layers)[:b]

    return fn

"""Serving-mode planner: the card's measured deployment rules as API
(counterpart of ``p2vit_tpu/plan.py``, with the same ``ServingPlan``,
``_family`` and ``recommend`` and the same rule structure; the table is
this card's, not the JAX package's).

A deployment asks one question, "which path serves this model at this
batch size?", and gets a ``ServingPlan``: the int8 serving path through
the CUDA kernels with the flags of the arm measured fastest, or the bf16
path, serving the quantized weights at bf16 speed (``--serve-weight-only``,
``weight_only_params``).

The table comes from the port's ``tools/latency_ab.py`` on one NVIDIA
H100 80GB HBM3 at a 700.00 W power limit (``nvidia-smi``), DeiT-T, DeiT-S
and Swin-T at batches 1, 8, 32, 64, 128 and 256 (``SWEPT_BATCHES``), each
arm's ms per forward from CUDA events around a window of forwards (host
launch gaps included: what a caller waits), the profiler's device ms beside
it (``PERF.md`` §6 has both tables):

- ViT: the int8 arms lose to bf16 up to batch 64 on DeiT-S (at 64: the
  fastest int8 arm 15.04 ms against bf16's 10.72 and weight-only's 9.09)
  and win from 128 (``int8_staged`` 15.78 against 16.10; at 256 23.74
  against 30.81). The int8 wrappers' host glue, not the card, sets the
  small batches' time: the profiler's device ms puts ``int8_staged`` below
  bf16 from batch 32 (3.86 against 4.18).
- ``int8_staged`` (``fuse_qkv=False, fuse_embed=False``) is the fastest
  int8 ViT arm at 128 and 256; the LIS-off arms are slower than LIS on at
  every swept batch, so LIS stays on whether or not ``prefer_exact``.
- DeiT-T (C = 192) never crossed: at 256 weight-only 15.65 ms and bf16
  15.70 against the fastest int8 arm's 17.33.
- Swin-T: bf16 or weight-only is faster up to batch 128 (at 128 bf16 30.16
  ms against int8's 34.39); int8 wins at 256 (LIS off 49.97, LIS on 50.39,
  bf16 56.58). LIS off read 0.8 % faster there, far inside the spread of
  one arm's event ms between windows (up to 40 %, ``PERF.md`` §7), and the
  profiler's device ms has LIS on 11 % faster (31.57 against 35.38): a tie,
  and a tie goes to LIS on, the exact integer softmax.

Where the sweep shows no crossover for a family, ``INT8_MIN_BATCH`` holds
None and the rule says so. The host's share makes the crossovers move
with the host CPU; they are deployment defaults, not physics: re-measure
with ``python -m p2vit_tpu_torch.tools.latency_ab deit_small deit_tiny
swin_tiny --batches 1,8,32,64,128,256``.
"""

from __future__ import annotations

import dataclasses

from .models.common import ViTConfig
from .models.swin import SwinConfig

SWEPT_BATCHES = (1, 8, 32, 64, 128, 256)
# the first swept batch at which the fastest int8 arm beat bf16 and
# weight-only (CUDA-event ms); None: it won at no swept batch
INT8_MIN_BATCH = {"vit": 128, "swin": 256}
# the model each family's crossover was swept on
CROSSOVER_MEASURED_ON = {"vit": "deit_small", "swin": "swin_tiny"}
# ViTs narrower than this never crossed (deit_tiny, C = 192)
VIT_MIN_EMBED_DIM = 384
# the fastest int8 arm's serving flags (Swin's serving takes none of them)
INT8_FLAGS = {"vit": dict(fuse_qkv=False, fuse_layer=False, fuse_embed=False),
              "swin": dict(fuse_qkv=True, fuse_layer=False, fuse_embed=True)}
# whether the fastest int8 arm runs LIS: False only where LIS off beat LIS on
# by more than the windows' spread (a tie goes to LIS on)
FASTEST_LIS = {"vit": True, "swin": True}


@dataclasses.dataclass(frozen=True)
class ServingPlan:
    """One serving configuration, splattable into the pipelines:
    ``serving.serving_forward(s, cfg, x, **plan.vit_kwargs())`` or
    ``serving_swin.serving_forward(..., lis=plan.lis)``."""

    path: str  # "int8" (the CUDA kernels) | "bf16" (the float forward, weight-only)
    lis: bool  # Log-Int-Softmax (the parity path) or the fp softmax
    fuse_qkv: bool
    fuse_layer: bool
    fuse_embed: bool
    reason: str

    def vit_kwargs(self) -> dict:
        """kwargs for serving.serving_forward (int8 path only)."""
        if self.path != "int8":
            raise ValueError(f"no serving kwargs for the {self.path} path")
        return {"lis": self.lis, "fuse_qkv": self.fuse_qkv, "fuse_layer": self.fuse_layer,
                "fuse_embed": self.fuse_embed}


def _family(cfg) -> str:
    if isinstance(cfg, SwinConfig):
        return "swin"
    if isinstance(cfg, ViTConfig):
        return "vit"
    raise TypeError(f"unknown model config type {type(cfg).__name__}")


def recommend(cfg, batch: int, prefer_exact: bool = True) -> ServingPlan:
    """The fastest measured serving mode for (model, batch size).

    ``prefer_exact``: keep the reference-parity integer softmax (LIS) even
    where the fp softmax measured faster; False takes the measured-fastest
    arm's switch (``FASTEST_LIS``).
    """
    if batch < 1:
        raise ValueError(f"batch must be >= 1, got {batch}")
    fam = _family(cfg)
    kw = dict(INT8_FLAGS[fam])
    wo_api = ("serving_swin" if fam == "swin" else "serving") + ".weight_only_params"
    if fam == "vit" and VIT_MIN_EMBED_DIM and cfg.embed_dim < VIT_MIN_EMBED_DIM:
        return ServingPlan(path="bf16", lis=False, reason=(
            f"C={cfg.embed_dim} ViTs never beat bf16 on this card in the swept batches "
            f"{list(SWEPT_BATCHES)} (deit_tiny, the int8 arms' host glue and narrow GEMMs); serve the "
            f"quantized weights at bf16 speed via --serve-weight-only ({wo_api})"), **kw)
    lo = INT8_MIN_BATCH[fam]
    if lo is None or batch < lo:
        where = (f"int8 beat bf16 at no swept batch {list(SWEPT_BATCHES)}" if lo is None
                 else f"batch {batch} is below the measured {fam} int8-over-bf16 crossover ({lo})")
        return ServingPlan(path="bf16", lis=False, reason=(
            f"{where} on this card (swept on {CROSSOVER_MEASURED_ON[fam]}; the int8 wrappers' host glue "
            f"sets the small batches' time) — serve the quantized weights at bf16 speed via "
            f"--serve-weight-only ({wo_api})"), **kw)
    lis = True if prefer_exact else FASTEST_LIS[fam]
    if lis and not FASTEST_LIS[fam]:
        why_lis = "LIS on: reference-parity integer softmax (LIS off measured faster; prefer_exact=False takes it)"
    elif lis:
        why_lis = "LIS on: the parity path, and no slower than LIS off on this card"
    else:
        why_lis = "LIS off: the measured-fastest arm (fp softmax, leaves the reference's integer-softmax math)"
    flags = ", ".join(f"{k}={v}" for k, v in kw.items()) if fam == "vit" else "the defaults"
    return ServingPlan(path="int8", lis=lis, reason=(
        f"batch {batch} >= {fam} crossover {lo}: int8 serving beats bf16 on this card "
        f"(swept on {CROSSOVER_MEASURED_ON[fam]}), fastest with {flags}. {why_lis}"), **kw)

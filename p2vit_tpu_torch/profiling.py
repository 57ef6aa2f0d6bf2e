"""Timing of one call on the device, a profiler trace, the per-matmul cost
model and the running average of the evaluation loop (counterpart of
``device_time``, ``device_time_ms``, ``trace``, ``cost_model`` and
``AverageMeter`` in ``p2vit_tpu/profiling.py``).

On CUDA tensors the time comes from CUDA events around ``iters`` calls on
the current stream (stream order serializes the calls, so no data
dependency is threaded through them); on CPU tensors, and only there, from
the host clock. Best of ``repeats`` windows, after one warm-up call.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch


def device_time(step, x, *consts, iters: int = 10, repeats: int = 3) -> float:
    """Best-of-``repeats`` seconds per call of ``step(x, *consts)``."""
    step(x, *consts)  # warm-up: kernel build, allocator, caches
    cuda = any(isinstance(a, torch.Tensor) and a.is_cuda for a in (x, *consts))
    best = float("inf")
    for _ in range(repeats):
        if cuda:
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                step(x, *consts)
            end.record()
            end.synchronize()
            best = min(best, start.elapsed_time(end) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                step(x, *consts)
            best = min(best, time.perf_counter() - t0)
    return best / iters


def device_time_ms(fn, x, *consts, iters: int = 20, repeats: int = 3) -> float:
    """``device_time`` in milliseconds, the tools' unit."""
    return device_time(fn, x, *consts, iters=iters, repeats=repeats) * 1e3


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block, CPU activities and, where
    the card is available, CUDA ones, written as a Chrome trace
    (``trace.json``) into ``logdir``. Raises where the profiler cannot start."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def cost_model(cfg) -> list:
    """Per-matmul multiply counts, one entry per bit-config slot: the ViT
    list of ``vit_flops``, or Swin's patch stem, per block [qkv, proj, fc1,
    fc2], per-stage reduction and head of ``swin_flops``."""
    from .models.common import ViTConfig, vit_flops
    from .models.swin import SwinConfig, swin_flops

    if isinstance(cfg, ViTConfig):
        return vit_flops(cfg)
    if isinstance(cfg, SwinConfig):
        return swin_flops(cfg)
    raise TypeError(f"unknown model config type {type(cfg).__name__}")


class AverageMeter:
    """Running average of a per-batch value weighted by the batch size."""

    def __init__(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

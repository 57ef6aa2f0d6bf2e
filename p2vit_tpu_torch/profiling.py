"""Timing of one call on the device and the running average of the
evaluation loop (counterpart of ``device_time``, ``device_time_ms`` and
``AverageMeter`` in ``p2vit_tpu/profiling.py``; the cost model and
``trace`` are not ported yet).

On CUDA tensors the time comes from CUDA events around ``iters`` calls on
the current stream (stream order serializes the calls, so no data
dependency is threaded through them); on CPU tensors, and only there, from
the host clock. Best of ``repeats`` windows, after one warm-up call.
"""

from __future__ import annotations

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


class AverageMeter:
    """Running average of a per-batch value weighted by the batch size."""

    def __init__(self):
        self.val = self.sum = self.count = self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)

"""Timing of one call on the device (counterpart of ``device_time`` and
``device_time_ms`` in ``p2vit_tpu/profiling.py``; the cost model and the
meters are not ported yet).

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

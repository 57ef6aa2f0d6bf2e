"""Arithmetic shared by the metric readers in ``metrics/``. Each reader
returns a number, or None where its cell gives it nothing to read."""

from __future__ import annotations

import numpy as np

from . import counts

# The port's own kernels, by symbol: namespace p2v or an anonymous
# namespace of its sources; PyTorch's kernels live under at:: (and cub::).
PORT_MARKS = ("p2v::", "(anonymous namespace)")
TORCH_MARKS = ("at::", "cub::", "c10::")


def is_port_kernel(name: str) -> bool:
    return any(m in name for m in PORT_MARKS) and not any(m in name for m in TORCH_MARKS)


def roofline(ctx, layer: str, symbol: str):
    """Share (%) of the least time of ``layer``'s work (counts.py, at the
    cell's batch) in the device time of the kernels whose symbol holds
    ``symbol``: each launch does one call's share of a forward's work."""
    if ctx.trace is None or "batch" not in ctx.mix:
        return None
    ks = ctx.trace.kernels(symbol)
    if not ks:
        return None
    calls = ctx.work(ctx.mix["batch"])[layer]
    least = counts.least_seconds(calls) / len(calls) * len(ks)
    return 100.0 * least / sum(b - a for _, a, b in ks)


def forwards_on_device(trace) -> int:
    """Forwards whose logits reached the host inside the window: one
    device-to-host copy each."""
    w0, w1 = trace.window
    return sum(1 for n, a, b, c in trace.ops if c == "gpu_memcpy" and "DtoH" in n and w0 <= b <= w1)


def glue_device_ms(ctx):
    if ctx.trace is None:
        return None
    n = forwards_on_device(ctx.trace)
    if not n:
        return None
    glue = sum(b - a for name, a, b in ctx.trace.kernels() if not is_port_kernel(name))
    return 1e3 * glue / n


def idle_share(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def dispatch_ms(ctx):
    return 1e3 * float(np.mean(ctx.dispatch_s)) if ctx.dispatch_s else None


def model_mfu(ctx):
    if ctx.trace is None or not ctx.images_traced or not ctx.traced_s:
        return None
    ops = counts.model_ops_per_image(ctx.family, ctx.sizes) * ctx.images_traced
    return 100.0 * ops / ctx.traced_s / counts.PEAK["int8_ops_s"]


def latency_ms(ctx, q: float):
    lat = ctx.result.get("latencies_s")
    if lat is None:
        return None
    return 1e3 * float(np.percentile(np.nan_to_num(lat, nan=np.inf), q))

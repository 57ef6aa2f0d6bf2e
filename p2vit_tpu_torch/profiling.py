"""Timing of one call on the device, a profiler trace, the program's spans
and counters, the per-matmul cost model and the running average of the
evaluation loop (counterpart of ``device_time``, ``device_time_ms``,
``trace``, ``cost_model`` and ``AverageMeter`` in ``p2vit_tpu/profiling.py``;
the spans are the port's own).

On CUDA tensors the time comes from CUDA events around ``iters`` calls on
the current stream (stream order serializes the calls, so no data
dependency is threaded through them); on CPU tensors, and only there, from
the host clock. Best of ``repeats`` windows, after one warm-up call.

Spans. Recording is off by default: ``span`` then returns one shared null
context and the ``op_span`` wrappers call straight through. Turn it on for a
block with ``recording()`` (or ``enable()`` ... ``disable()``), or trace a
block with ``trace(logdir)``, which records the card's activity and the
spans into one Chrome trace. ``drain()`` hands the records back and empties
the list; records are written only when a caller asks. Each record is a
``Span``: name, id, parent id, forward id (the ``serving.forward`` it lies
under, else None), start and end on ``time.perf_counter_ns``, attributes
and counts. One thread records at a time. The span names:

  * ``serving.forward`` (``batch``): one ``serving_forward`` call, ViT or
    Swin; it opens a new forward id.
  * ``vit.embed``: the prologue (uint8 ingest, ``embed_codes``);
    ``vit.block`` (``index``): one encoder layer and its constants;
    ``vit.head``: the final-norm codes through the head to float logits.
  * ``swin.stem``: ingest and the patch stem; ``swin.block`` (``stage``,
    ``block``): one block, its roll and partition copies included;
    ``swin.merge``: a PatchMerging; ``swin.head``: the final LN where it is
    not fused, the token mean and the head.
  * ``op.<wrapper>``: one call of a kernel wrapper of ``ops.KERNELS``, its
    checks, padding, constant vectors and launch, or of its ``*_prepared``
    entry (checks, padding and launch). ``op.lis_attention_qkv_fused``
    carries its launch's ``cluster`` (CTAs per cluster) and, on the card,
    ``resident_clusters`` (the clusters the card holds at once), read while
    recording, once per shape (``attention_lis.qkv_launch_facts``).

Counts, on the innermost open span: ``syncs``, each synchronizing CUDA call
the host made (PyTorch's own detector, ``torch.cuda.set_sync_debug_mode``
at "warn" while recording; nothing without a card), and, on ``op.*`` spans,
``launches``, the wrapper's kernel launches (its ``launches`` counter, the
entry of ``ops.launch_counts()``), and ``consts_formed``, each call of a
helper that forms a kernel's constant vectors from scales (the wrappers do
per call; ``serving{,_swin}.prepare`` once per state, so a default forward
counts none). ``count(name, n)`` adds others; ``annotate(read)`` sets attributes.
``sync_sites()`` tallies the source lines that synchronized. ``clock()`` is
the (``time.time_ns``, ``perf_counter_ns``) pair read at ``enable``, which
puts a span on a profiler trace's clock (``chrome_events``).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import time
import warnings
from typing import NamedTuple

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


class Span(NamedTuple):
    """One recorded span; times on ``time.perf_counter_ns``."""

    name: str
    span_id: int
    parent_id: int | None
    forward_id: int | None
    t0_ns: int
    t1_ns: int
    attrs: dict
    counts: dict


FORWARD = "serving.forward"  # the span that opens a forward id
SYNC_WARNING = "called a synchronizing CUDA operation"  # PyTorch's sync detector's warning


class _Recorder:
    """The process's recorder: whether it is on, the open spans (innermost
    last), the records, the clock pair and what ``enable`` changed."""

    def __init__(self):
        self.on = False
        self.open: list = []
        self.records: list = []
        self.ids = itertools.count(1)
        self.forwards = itertools.count(1)
        self.clock = None
        self.sites: dict = {}
        self.restore = None


_REC = _Recorder()
_NULL = contextlib.nullcontext()


class _OpenSpan:
    __slots__ = ("name", "attrs", "counts", "span_id", "parent_id", "forward_id", "t0")

    def __init__(self, name, attrs):
        self.name, self.attrs, self.counts = name, attrs, {}

    def __enter__(self):
        stack = _REC.open
        parent = stack[-1] if stack else None
        self.span_id = next(_REC.ids)
        self.parent_id = parent.span_id if parent else None
        if self.name == FORWARD:
            self.forward_id = next(_REC.forwards)
        else:
            self.forward_id = parent.forward_id if parent else None
        stack.append(self)
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        _REC.open.pop()
        _REC.records.append(Span(self.name, self.span_id, self.parent_id, self.forward_id, self.t0, t1,
                                 self.attrs, self.counts))
        return False


def span(name: str, **attrs):
    """A span named ``name`` around the block while recording; otherwise the
    shared null context."""
    if not _REC.on:
        return _NULL
    return _OpenSpan(name, attrs)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the count ``name`` of the innermost open span (none open
    or recording off: nothing)."""
    if _REC.on and _REC.open:
        c = _REC.open[-1].counts
        c[name] = c.get(name, 0) + n


def annotate(read) -> None:
    """Set the attributes of the dict ``read()`` returns on the innermost
    open span; ``read`` is called only then (none open or recording off:
    nothing)."""
    if _REC.on and _REC.open:
        _REC.open[-1].attrs.update(read())


def op_span(fn=None, *, of=None):
    """Wrap a kernel wrapper in an ``op.<name>`` span that counts its
    launches. Off, the call goes straight through. ``launches`` and
    ``__name__`` stay on the returned function, which the wrapped one's own
    ``<name>.launches += 1`` reaches through its module's global. ``of``: the
    wrapper whose second entry ``fn`` is (the one on prepared constants);
    its calls are recorded under ``of``'s span name and launch counter."""
    if fn is None:
        return functools.partial(op_span, of=of)
    name = "op." + (of or fn).__name__

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if not _REC.on:
            return fn(*args, **kwargs)
        counter = of or wrapper
        with _OpenSpan(name, {}) as sp:
            before = counter.launches
            out = fn(*args, **kwargs)
            if counter.launches != before:
                sp.counts["launches"] = sp.counts.get("launches", 0) + counter.launches - before
        return out

    return wrapper


def _on_warning(message, category, filename, lineno, file=None, line=None):
    if SYNC_WARNING in str(message):
        count("syncs")
        site = f"{filename}:{lineno}"
        _REC.sites[site] = _REC.sites.get(site, 0) + 1
    else:
        _REC.restore[2](message, category, filename, lineno, file, line)


def _clock_pair(reads: int = 5) -> tuple:
    """(time_ns, perf_counter_ns) read together: of ``reads`` tries, the one
    whose two perf_counter reads around the wall clock lie closest."""
    best = None
    for _ in range(reads):
        a = time.perf_counter_ns()
        w = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, w, (a + b) // 2)
    return best[1], best[2]


def enable() -> None:
    """Start recording (no-op when on): read the clock pair, turn PyTorch's
    sync detector to "warn" where there is a card, and count its warnings
    instead of printing them."""
    if _REC.on:
        return
    mode = None
    if torch.cuda.is_available():
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
    catcher = warnings.catch_warnings()
    catcher.__enter__()
    warnings.filterwarnings("always", message=SYNC_WARNING)
    _REC.restore = (mode, catcher, warnings.showwarning)
    warnings.showwarning = _on_warning
    _REC.sites = {}
    _REC.clock = _clock_pair()
    _REC.on = True


def disable() -> None:
    """Stop recording (no-op when off) and restore what ``enable`` changed.
    The records stay until ``drain``."""
    if not _REC.on:
        return
    _REC.on = False
    mode, catcher, _ = _REC.restore
    catcher.__exit__(None, None, None)
    if mode is not None:
        torch.cuda.set_sync_debug_mode(mode)
    _REC.restore = None


@contextlib.contextmanager
def recording():
    """Record spans over the block (leaves recording on if it already was)."""
    was = _REC.on
    enable()
    try:
        yield
    finally:
        if not was:
            disable()


def drain() -> list:
    """The records so far (``Span``s in order of their end), and empty the list."""
    out, _REC.records = _REC.records, []
    return out


def clock() -> tuple | None:
    """The (``time.time_ns``, ``perf_counter_ns``) pair of the last ``enable``."""
    return _REC.clock


def sync_sites() -> dict:
    """Synchronizing calls since the last ``enable``, by source line."""
    return dict(_REC.sites)


SPAN_PID = 1 << 30  # the Chrome trace process that holds the spans


def chrome_events(records, base_ns: int, pair: tuple) -> list:
    """``records`` as Chrome trace ``X`` events under their own process
    ``SPAN_PID``, on a profiler trace's clock (µs from its
    ``baseTimeNanoseconds``) through the clock pair ``pair``."""
    wall, perf = pair
    out = [{"ph": "M", "name": "process_name", "pid": SPAN_PID, "tid": 0,
            "args": {"name": "p2vit_tpu_torch spans"}}]
    for r in records:
        out.append({"ph": "X", "cat": "program_span", "name": r.name, "pid": SPAN_PID, "tid": 0,
                    "ts": (r.t0_ns - perf + wall - base_ns) * 1e-3, "dur": (r.t1_ns - r.t0_ns) * 1e-3,
                    "args": {**r.attrs, **r.counts, "span_id": r.span_id, "parent_id": r.parent_id,
                             "forward_id": r.forward_id}})
    return out


@contextlib.contextmanager
def trace(logdir: str):
    """A ``torch.profiler`` trace of the block, written as a Chrome trace
    (``trace.json``) into ``logdir``, with the program's spans recorded over
    the block added as ``X`` events under their own process on the trace's
    clock. With a card it records the card's activity alone (kernels,
    copies, the runtime's launches): host activity slows the host by 15–60 %
    and so hides where the card waits; without one, CPU activity. Raises
    where the profiler cannot start."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    os.makedirs(logdir, exist_ok=True)
    n0 = len(_REC.records)
    was = _REC.on
    with recording():
        with profile(activities=[ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]) as prof:
            yield prof
        pair = _REC.clock
    records = _REC.records[n0:]
    if not was:  # the block's records go to the file alone
        del _REC.records[n0:]
    path = os.path.join(logdir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        data = json.load(f)
    data["traceEvents"].extend(chrome_events(records, int(data.get("baseTimeNanoseconds", 0)), pair))
    with open(path, "w") as f:
        json.dump(data, f)


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

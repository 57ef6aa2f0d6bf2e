"""A traced run of one cell with the program's own spans and counters
(``p2vit_tpu_torch.profiling``) recorded over the analysed window, on the
device trace's clock, and the readings they give:

* ``host_syncs_per_forward``: the ``syncs`` counted on every span of the
  forwards inside the window, per forward;
* ``forward_idle_ms``: device-idle ms inside the window while the host was
  inside a ``serving.forward`` span, per forward;
* ``wrapper_host_us``: the median host µs of the ``op.*`` spans that counted
  no sync;
* ``breakdown``: the harness's ``device_ops`` and ``idle_gaps``, and
  ``idle_by_span`` and ``syncs_by_span`` per forward, and, where the trace
  holds the runtime's launch events, ``device_ms_by_span`` (each kernel put
  down to the layer span that launched it);
* ``program``: those three readings; ``clock``, whether the spans and the
  trace share one clock (each port kernel's launch inside the ``op.*``
  span of its wrapper); ``runtime_ms_by_call``, the host's time in CUDA
  runtime calls by span and call; ``wrapper_host_us_by_op``;
  ``dispatch_ms_window``, the harness's mean ``serving_forward`` call
  inside the window; ``sync_sites``, the lines that synchronized.

    python3 benchmark/program_trace.py --workload deit_b.bulk --seed 7 --seconds 10 [--cost 1]

``--cost 1`` makes no traced run: it reads the recorder's own cost, the
cell's loop with recording on for every other forward (``recording_cost``).

The run is ``run.py --trace 1``'s: the harness's own ``run_cell``, with
``SpanTracer`` in place of its ``Tracer``. A program without the recorder
gives no program spans, and these readings are None. Needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from collections import deque  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark import harness  # noqa: E402
from benchmark import weights as W  # noqa: E402
from benchmark.readers import is_port_kernel  # noqa: E402
from benchmark.trace import Trace  # noqa: E402

LAYER_PREFIXES = ("vit.", "swin.")
FORWARD = "serving.forward"
# a port kernel's symbol → the wrappers that launch it
KERNEL_OPS = (
    ("lis_attention_qkv_kernel", ("lis_attention_qkv_fused",)),
    ("requant_kernel<", ("int8_matmul_requant", "int4_matmul_requant")),
    ("res_ln_kernel", ("int8_matmul_res_ln",)),
    ("embed_kernel", ("fused_patch_embed",)),
    ("int_ln_kernel", ("int_ln_requant", "int_res_ln_requant")),
    ("swin_attention_kernel", ("swin_lis_attention", "swin_lis_attention_folded")),
    ("attention_rows_kernel", ("lis_attention_fused", "lis_attention")),
    ("fused_vit_layer_kernel", ("fused_vit_layer",)),
    ("swin_stem_kernel", ("fused_swin_stem",)),
    ("wstream_matmul_kernel", ("wstream_matmul",)),
)


def wrappers_of(kernel: str) -> tuple:
    """The wrappers that launch the port kernel ``kernel`` (a symbol)."""
    return next((ops for mark, ops in KERNEL_OPS if mark in kernel), ())


def _recorder():
    """The program's span recorder, or None where the program has none."""
    try:
        from p2vit_tpu_torch import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "span") and hasattr(profiling, "drain") else None


def _top(by: dict, forwards: int, n: int) -> list:
    """The ``n`` largest entries of ``by``, per forward, as [key, value]."""
    return [[k, v / forwards] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def innermost_segments(spans: list) -> tuple:
    """Host time cut into pieces with one innermost span each, for nested
    (name, start, end, ...) spans: (the pieces' starts, the pieces (start,
    end, span))."""
    segs, stack, t = [], [], None
    for s in sorted(spans, key=lambda s: (s[1], -s[2])):
        while stack and stack[-1][2] <= s[1]:
            top = stack.pop()
            segs.append((t, top[2], top))
            t = top[2]
        if stack:
            segs.append((t, s[1], stack[-1]))
        stack.append(s)
        t = s[1]
    while stack:
        top = stack.pop()
        segs.append((t, top[2], top))
        t = top[2]
    segs = [g for g in segs if g[1] > g[0]]
    return [g[0] for g in segs], segs


class SpanTrace(Trace):
    """The harness's ``Trace`` with the program's spans ``program``: (name,
    start, end, forward id, counts, attributes) in trace seconds, and the
    runtime's calls ``runtime``: (name, start, end), of which the kernel
    launches ``launches``: (host time, kernel name, device start, device
    end), paired by the profiler's correlation id. ``pair_offset_us``: the
    recorder's clock pair against the harness's offset, where a tracer set
    it."""

    def __init__(self, events: list, window: tuple, spans: list, program: list):
        super().__init__(events, window, spans)
        self.program = sorted(program, key=lambda s: s[1])
        self._segs: dict = {}
        self.pair_offset_us = None
        kernels = {}
        for e in events:
            if e.get("ph") == "X" and e.get("cat") == "kernel" and "correlation" in e.get("args", {}):
                t0 = float(e["ts"]) * 1e-6
                kernels[e["args"]["correlation"]] = (e["name"], t0, t0 + float(e["dur"]) * 1e-6)
        self.launches, self.runtime = [], []
        for e in events:
            if e.get("ph") != "X" or e.get("cat") not in ("cuda_runtime", "cuda_driver"):
                continue
            t0 = float(e["ts"]) * 1e-6
            self.runtime.append((e["name"], t0, t0 + float(e.get("dur", 0)) * 1e-6))
            corr = e.get("args", {}).get("correlation")
            if "Launch" in e["name"] and corr in kernels:
                self.launches.append((t0, *kernels[corr]))
        self.launches.sort()

    # -- the forwards inside the window -----------------------------------
    def forwards(self) -> list:
        """``serving.forward`` spans that lie inside the window."""
        w0, w1 = self.window
        return [s for s in self.program if s[0] == FORWARD and s[1] >= w0 and s[2] <= w1]

    def _in_forwards(self):
        ids = {s[3] for s in self.forwards()}
        return [s for s in self.program if s[3] in ids]

    def _host_range(self):
        """From the first forward's start to the last one's end."""
        fw = self.forwards()
        return min(s[1] for s in fw), max(s[2] for s in fw)

    def innermost(self, t: float, prefixes=None):
        """The innermost program span that holds host time ``t`` (of those
        whose name starts with one of ``prefixes``), or None."""
        if prefixes not in self._segs:
            self._segs[prefixes] = innermost_segments(
                [s for s in self.program if prefixes is None or s[0].startswith(prefixes)])
        starts, segs = self._segs[prefixes]
        i = bisect.bisect_right(starts, t) - 1
        return segs[i][2] if i >= 0 and t <= segs[i][1] else None

    # -- the readings -------------------------------------------------------
    def host_syncs_per_forward(self):
        n = len(self.forwards())
        return sum(s[4].get("syncs", 0) for s in self._in_forwards()) / n if n else None

    def forward_idle_ms(self):
        fw = self.forwards()
        if not fw:
            return None
        idle = 0.0
        for a, b in self.gaps():
            for s in fw:
                idle += max(0.0, min(b, s[2]) - max(a, s[1]))
        return 1e3 * idle / len(fw)

    def wrapper_host_us(self):
        d = [s[2] - s[1] for s in self._in_forwards() if s[0].startswith("op.") and not s[4].get("syncs")]
        return 1e6 * statistics.median(d) if d else None

    def idle_by_span(self, n: int = 10) -> list:
        """Device-idle ms per forward by the innermost program span the host
        was in at each gap's middle (the harness's span where none)."""
        fw = len(self.forwards())
        if not fw:
            return []
        by: dict = {}
        for a, b in self.gaps():
            m = (a + b) / 2
            s = self.innermost(m)
            key = s[0] if s else self.host_label(m)
            by[key] = by.get(key, 0.0) + 1e3 * (b - a)
        return _top(by, fw, n)

    def syncs_by_span(self, n: int = 10) -> list:
        """Syncs per forward by the span they were counted on."""
        fw = len(self.forwards())
        by: dict = {}
        for s in self._in_forwards():
            if s[4].get("syncs"):
                by[s[0]] = by.get(s[0], 0) + s[4]["syncs"]
        return _top(by, fw, n) if fw else []

    def device_ms_by_span(self, n: int = 10) -> list:
        """Device ms per forward of the kernels launched inside each layer
        span (``vit.*``, ``swin.*``) of the forwards inside the window."""
        fw = len(self.forwards())
        if not fw or not self.launches:
            return []
        t0, t1 = self._host_range()
        by: dict = {}
        for t, _, a, b in self.launches:
            if t0 <= t <= t1:
                s = self.innermost(t, LAYER_PREFIXES)
                key = s[0] if s else "other"
                by[key] = by.get(key, 0.0) + 1e3 * (b - a)
        return _top(by, fw, n)

    def clock_check(self) -> dict:
        """Whether the spans and the trace share a clock: of the port's
        kernels launched during the recorded forwards (by the runtime's
        launch events), the share whose launch lies inside an ``op.*`` span
        of their wrapper, and the median µs from that span's start."""
        if not self.forwards() or not self.launches:
            return {}
        t0, t1 = self._host_range()
        port = [(t, k) for t, k, _, _ in self.launches if t0 <= t <= t1 and is_port_kernel(k)]
        inside = []
        for t, k in port:
            o = self.innermost(t, ("op.",))
            if o is not None and o[0][3:] in wrappers_of(k):
                inside.append(1e6 * (t - o[1]))
        return {"port_launches": len(port), "inside_op_span": len(inside),
                "share": len(inside) / len(port) if port else None,
                "median_us_after_span_start": statistics.median(inside) if inside else None}

    def runtime_ms_by_call(self, n: int = 10) -> list:
        """Host ms per forward in CUDA runtime and driver calls made inside
        the recorded forwards, by the innermost span and the call."""
        fw = len(self.forwards())
        if not fw:
            return []
        t0, t1 = self._host_range()
        by: dict = {}
        for name, a, b in self.runtime:
            if t0 <= a <= t1:
                s = self.innermost(a)
                key = f"{s[0] if s else 'other'} {name}"
                by[key] = by.get(key, 0.0) + 1e3 * (b - a)
        return _top(by, fw, n)

    def wrapper_host_us_by_op(self) -> dict:
        """Median host µs of each wrapper's ``op.*`` spans, and how many."""
        by: dict = {}
        for s in self._in_forwards():
            if s[0].startswith("op."):
                by.setdefault(s[0], []).append(1e6 * (s[2] - s[1]))
        return {k: [statistics.median(v), len(v)] for k, v in sorted(by.items())}

    def dispatch_ms_window(self):
        """The harness's ``bench.forward`` calls inside the window, mean ms."""
        w0, w1 = self.window
        d = [b - a for name, a, b in self.spans if name == "bench.forward" and a >= w0 and b <= w1]
        return 1e3 * statistics.fmean(d) if d else None

    def breakdown(self, n: int = 10) -> dict:
        out = super().breakdown(n)
        out["idle_by_span"] = self.idle_by_span(n)
        out["syncs_by_span"] = self.syncs_by_span(n)
        if self.launches:
            out["device_ms_by_span"] = self.device_ms_by_span(n)
        return out


class SpanTracer(harness.Tracer):
    """The harness's tracer that turns the program's recorder on when the
    analysed window opens and off when it closes, and reads its spans back
    onto the trace's clock with the harness's own offset. ``trace`` holds
    its ``SpanTrace`` once finished."""

    def __init__(self, on: bool, seconds: float, spans, dev):
        super().__init__(on, seconds, spans, dev)
        self.rec = _recorder()
        self.pair = None
        self.trace = None

    def tick(self) -> None:
        before = self.state
        super().tick()
        if self.rec is None or self.state == before:
            return
        if self.state == 1:
            self.rec.drain()
            self.rec.enable()
            self.pair = self.rec.clock()
        elif self.state == 2:
            self.rec.disable()

    def finish(self) -> Trace | None:
        if not self.on:
            return None
        while self.state < 3:
            self.due = 0.0
            self.tick()
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            self.prof.export_chrome_trace(str(path))
            data = json.loads(path.read_text())
        self.prof = None
        base = data.get("baseTimeNanoseconds", 0) * 1e-9
        to_trace = self.wall_offset - base  # host clock → trace seconds, as Tracer.finish
        spans = [(name, t + to_trace, t + d + to_trace) for name, rec in self.spans.rec.items() for t, d in rec]
        program = []
        if self.rec is not None:
            program = [(r.name, r.t0_ns * 1e-9 + to_trace, r.t1_ns * 1e-9 + to_trace, r.forward_id, r.counts,
                        r.attrs) for r in self.rec.drain()]
        w0, w1 = self.host_window
        tr = SpanTrace(data["traceEvents"], (w0 + to_trace, w1 + to_trace), spans, program)
        if self.pair is not None:  # the recorder's own pair against the harness's offset
            tr.pair_offset_us = 1e6 * ((self.pair[0] - self.pair[1]) * 1e-9 - self.wall_offset)
        self.trace = tr
        return tr


def run(cell, seed: int, seconds: float, dev, t_start: float) -> tuple:
    """``harness.run_cell`` traced, with ``SpanTracer`` in its ``Tracer``'s
    place: (its result, the ``SpanTrace``)."""
    made = []

    def tracer(*args):
        made.append(SpanTracer(*args))
        return made[-1]

    real = harness.Tracer
    harness.Tracer = tracer
    try:
        out = harness.run_cell(cell, seed, seconds, True, dev, t_start)
    finally:
        harness.Tracer = real
    return out, made[-1].trace


def _off_call_ns(profiling, n: int = 200_000) -> dict:
    """Host ns that recording off adds to one call: an ``op_span`` wrapper
    around a no-op against the no-op, and an empty ``span`` block with an
    attribute against an empty function (the best of 5 rounds of ``n``)."""

    def bare():
        return None

    wrapped = profiling.op_span(bare)
    wrapped.launches = 0

    def per_call(fn):
        best = float("inf")
        for _ in range(5):
            t = time.perf_counter_ns()
            for _ in range(n):
                fn()
            best = min(best, (time.perf_counter_ns() - t) / n)
        return best

    def block():
        with profiling.span("x", index=1):
            pass

    def empty():
        pass

    return {"op_span": per_call(wrapped) - per_call(bare), "span": per_call(block) - per_call(empty)}


def recording_cost(cell, seed: int, seconds: float, dev) -> dict:
    """The recorder's own cost on the host, in the cell's closed loop with
    recording on for every other forward, so that neighbouring forwards meet
    the same host: the median host ms of a ``serving_forward`` call on and
    off, the median of each on call over the mean of its two off
    neighbours, the spans a forward records, and what recording off adds to
    a call (``_off_call_ns``)."""
    rec = _recorder()
    if rec is None:
        return {}
    import torch

    config, mix = cell.config, cell.mix
    gen, params, cal_x = harness.make_inputs(config, seed, dev)
    prog = harness.family(config).Program(config, params, cal_x)
    del params, cal_x
    ring_dev = W.images(gen, mix["ring_images"], config["sizes"]["img_size"], dev)
    ring = torch.empty(ring_dev.shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    ring.copy_(ring_dev)
    del ring_dev
    spans = harness.Spans()
    bsz, depth = mix["batch"], mix["in_flight"]
    server = harness.Server(prog.forward, ring, config["sizes"]["num_classes"], depth, bsz, 0, seed, spans, dev)
    for n in mix["warmup_batches"]:
        server.dispatch(0, n).ev.synchronize()
    spans.rec.clear()
    on, n_spans, inflight = [], [], deque()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds or len(on) < 5:  # an on call between two off ones, at least
        on.append(len(on) % 2 == 0)
        (rec.enable if on[-1] else rec.disable)()
        inflight.append(server.dispatch(bsz * len(on), bsz))
        if on[-1]:
            n_spans.append(len(rec.drain()))
        if len(inflight) >= depth:
            inflight.popleft().ev.synchronize()
    rec.disable()
    while inflight:
        inflight.popleft().ev.synchronize()
    d = [1e3 * dt for _, dt in spans.rec["bench.forward"]]
    ratio = [d[j] / ((d[j - 1] + d[j + 1]) / 2) for j in range(1, len(d) - 1) if on[j]]
    return {"forwards": len(d), "on_ms": statistics.median([x for x, o in zip(d, on) if o]),
            "off_ms": statistics.median([x for x, o in zip(d, on) if not o]),
            "on_over_neighbours": statistics.median(ratio), "spans_per_forward": statistics.median(n_spans),
            "off_call_ns": _off_call_ns(rec)}


def readings(tr: SpanTrace) -> dict:
    return {"host_syncs_per_forward": tr.host_syncs_per_forward(), "forward_idle_ms": tr.forward_idle_ms(),
            "wrapper_host_us": tr.wrapper_host_us()}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--cost", type=int, choices=(0, 1), default=0,
                   help="1: no traced run; the recorder's cost, on for every other forward")
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")
    import torch

    torch.set_num_threads(1)
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("program_trace: no CUDA card", file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    if args.cost:
        out = recording_cost(cell, args.seed, args.seconds, torch.device("cuda", 0))
        out["device"] = {"kind": torch.cuda.get_device_name(0), "power_limit_w": harness.power_limit_w()}
        print(json.dumps(out), flush=True)
        return 0
    out, tr = run(cell, args.seed, args.seconds, torch.device("cuda", 0), T_START)
    prog = {"forwards": len(tr.forwards()), "dispatch_ms_window": tr.dispatch_ms_window(),
            "readings": readings(tr), "clock": tr.clock_check(),
            "pair_offset_us": tr.pair_offset_us,
            "runtime_launches": len(tr.launches), "runtime_ms_by_call": tr.runtime_ms_by_call(),
            "wrapper_host_us_by_op": tr.wrapper_host_us_by_op()}
    rec = _recorder()
    if rec is not None:
        sites = sorted(rec.sync_sites().items(), key=lambda kv: -kv[1])[:10]
        prog["sync_sites"] = [[k, v / max(1, prog["forwards"])] for k, v in sites]
    out["program"] = prog
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell: set-up, the measured window, the traced window, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the names in ``BENCHMARK.json``:
``configs/<config>.json`` (sizes, quantization, ``family``),
``families/<family>.py`` (weights, the program's set-up and call, the
reference), ``traffic/<mix>.json`` (read by ``traffic.py``),
``metrics/<metric>.py`` (a reader ``read(ctx)``) and
``limits/<workload>.json`` (the limit of each number compared).
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib
import importlib.util
import json
import random
import subprocess
import sys
import tempfile
import time
from collections import deque
from pathlib import Path

import numpy as np
import torch

from . import counts, traffic
from . import weights as W
from .reference import vit as ref_vit
from .trace import Trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "p2vit_tpu")  # top-level module names the run may not load


# ---------------------------------------------------------------------------
# the cell's specification
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Cell:
    name: str
    config: dict  # the configuration's file
    mix: dict
    end_to_end: list  # BENCHMARK.json entries that this cell reports
    per_layer: list
    limits: dict
    bench: Path = BENCH  # the folder that holds metrics/


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(workload: str, root: Path = ROOT) -> Cell:
    """The cell ``workload`` of ``root``/BENCHMARK.json with its files."""
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[workload]
    conf = {c["name"]: c for c in spec["configs"]}[w["config"]]
    config = json.loads((root / conf["file"]).read_text())
    e2e = [m for m in spec["end_to_end"] if _applies(m, workload)]
    per_layer = [m for m in spec["per_layer"] if _applies(m, workload)]
    bench = root / BENCH.name
    limits = json.loads((bench / "limits" / f"{workload}.json").read_text())
    return Cell(workload, config, traffic.load(w["traffic"], bench / "traffic"), e2e, per_layer, limits, bench)


def reader(name: str, metric_dir: Path = BENCH / "metrics"):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = metric_dir / f"{name}.py"
    mod_spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def family(config: dict):
    return importlib.import_module(f"benchmark.families.{config['family']}")


# ---------------------------------------------------------------------------
# spans, events, tracing
# ---------------------------------------------------------------------------


class Spans:
    """Host spans of the harness: (start, seconds) by name on the host's
    clock (``time.perf_counter``)."""

    def __init__(self):
        self.rec: dict = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        t = time.perf_counter()
        try:
            yield
        finally:
            self.rec.setdefault(name, []).append((t, time.perf_counter() - t))


class _Done:
    """Stands in for a CUDA event on the CPU: the work is done when enqueued."""

    def synchronize(self):
        pass

    def query(self):
        return True


def _event(dev):
    if dev.type != "cuda":
        return _Done()
    ev = torch.cuda.Event()
    ev.record()
    return ev


class Tracer:
    """With ``on``, starts the profiler when made (after set-up, before the
    window: its start takes seconds), on the card's activity alone (kernels
    and copies: no host op is traced, so the host runs as untraced), and
    marks the analysed window from 1 s into the window (so that every
    operation in it was launched while it traced) for ``TRACED_S``,
    stopping 0.3 s after. Windows shorter than 5 s keep the proportions.
    The harness's spans join the trace by the wall clock, which the
    profiler's timestamps count from ``baseTimeNanoseconds``."""

    TRACED_S = 3.0

    def __init__(self, on: bool, seconds: float, spans: Spans, dev):
        self.on, self.spans = on, spans
        f = 1.0 if seconds >= 5 else seconds / 5
        self.steps = (1.0 * f, self.TRACED_S * f, 0.3 * f)  # waits before each transition
        self.state = 0
        self.due = None  # host time of the next transition
        self.prof = None
        self.host_window = None  # (start, end) on the host's clock
        self.images = 0  # images answered inside it
        self.wall_offset = time.time_ns() * 1e-9 - time.perf_counter()
        if on:
            cuda = dev.type == "cuda"
            acts = [torch.profiler.ProfilerActivity.CUDA if cuda else torch.profiler.ProfilerActivity.CPU]
            self.prof = torch.profiler.profile(activities=acts)
            self.prof.start()

    def note(self, t: float, n: int) -> None:
        """Count ``n`` images answered at host time ``t`` if inside the window."""
        hw = self.host_window
        if hw is not None and t >= hw[0] and (hw[1] is None or t <= hw[1]):
            self.images += n

    def tick(self) -> None:
        if not self.on or self.state >= 3:
            return
        now = time.perf_counter()
        if self.due is None:
            self.due = now + self.steps[0]
        if now < self.due:
            return
        if self.state == 0:
            self.host_window = [now, None]
        elif self.state == 1:
            self.host_window[1] = now
        else:
            self.prof.stop()
        self.state += 1
        if self.state < 3:
            self.due = time.perf_counter() + self.steps[self.state]

    def finish(self) -> Trace | None:
        """Close what is open and read the trace back (None when off)."""
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
        to_trace = self.wall_offset - data.get("baseTimeNanoseconds", 0) * 1e-9  # host clock → trace seconds
        spans = [(name, t + to_trace, t + d + to_trace) for name, rec in self.spans.rec.items() for t, d in rec]
        w0, w1 = self.host_window
        return Trace(data["traceEvents"], (w0 + to_trace, w1 + to_trace), spans)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Batch:
    k0: int  # first request (ring slot k0 % R)
    n: int
    ev: object
    out: torch.Tensor


class Server:
    """Dispatches slices of the pinned ring through the program and keeps,
    for the check, a seeded reservoir of answered batches (and the largest)."""

    def __init__(self, forward, ring, classes: int, in_flight: int, max_batch: int, keep: int, seed: int,
                 spans: Spans, dev):
        self.forward, self.ring, self.spans, self.dev = forward, ring, spans, dev
        pin = dev.type == "cuda"
        self.outs = [torch.empty((max_batch, classes), dtype=torch.float32, pin_memory=pin)
                     for _ in range(in_flight + 1)]
        self.n_out = 0
        self.keep, self.rng = keep, random.Random(int(seed))
        self.kept: list = []  # (k0, n, logits)
        self.largest = None
        self.answered = 0

    def dispatch(self, k0: int, n: int) -> Batch:
        r = self.ring.shape[0]
        a = k0 % r
        with self.spans("bench.h2d"):
            x = self.ring[a:a + n].to(self.dev, non_blocking=True)
        with self.spans("bench.forward"):
            y = self.forward(x)
        with self.spans("bench.d2h"):
            out = self.outs[self.n_out % len(self.outs)][:n]
            self.n_out += 1
            out.copy_(y, non_blocking=True)
            ev = _event(self.dev)
        return Batch(k0, n, ev, out)

    def answered_batch(self, b: Batch) -> None:
        """Keep ``b`` for the check if the reservoir draws it."""
        i = self.answered
        self.answered += 1
        if len(self.kept) < self.keep:
            self.kept.append((b.k0, b.n, b.out.clone()))
        else:
            j = self.rng.randrange(i + 1)
            if j < self.keep:
                self.kept[j] = (b.k0, b.n, b.out.clone())
        if self.largest is None or b.n > self.largest[1]:
            self.largest = (b.k0, b.n, b.out.clone())

    def check_batches(self) -> list:
        kept = list(self.kept)
        if self.largest is not None and all(k[:2] != self.largest[:2] for k in kept):
            kept.append(self.largest)
        return kept


def closed_loop(server: Server, mix: dict, seconds: float, tracer: Tracer, spans: Spans) -> dict:
    """Full batches back to back, at most ``in_flight`` outstanding: the
    host enqueues batch i+1 before it waits for batch i's logits."""
    bsz, depth = mix["batch"], mix["in_flight"]
    inflight: deque = deque()
    t0 = time.perf_counter()
    end = seconds
    k, done, sent = 0, 0, 0
    while True:
        now = time.perf_counter() - t0
        tracer.tick()
        if now < end:
            inflight.append(server.dispatch(k, bsz))
            k += bsz
            sent += bsz
        if inflight and (len(inflight) >= depth or now >= end):
            b = inflight.popleft()
            with spans("bench.wait"):
                b.ev.synchronize()
            t = time.perf_counter()
            tracer.note(t, b.n)
            if t - t0 <= end:
                done += b.n
            server.answered_batch(b)
        elif now >= end and not inflight:
            break
    return {"attempted": sent, "answered": sent, "images_done": done, "window_s": seconds}


def open_loop(server: Server, mix: dict, arr: np.ndarray, tracer: Tracer, spans: Spans) -> dict:
    """Requests due at ``arr`` (s); what is due is batched, up to
    ``max_batch``, whenever fewer than ``in_flight`` batches are out. Each
    request is timed from its due time to its logits on the host."""
    max_b, depth = mix["max_batch"], mix["in_flight"]
    r = server.ring.shape[0]
    n_req = len(arr)
    sent_t = np.full(n_req, np.nan)
    done_t = np.full(n_req, np.nan)
    inflight: deque = deque()
    k = 0
    t0 = time.perf_counter()

    def complete(b: Batch) -> None:
        t = time.perf_counter()
        done_t[b.k0:b.k0 + b.n] = t - t0
        tracer.note(t, b.n)
        server.answered_batch(b)

    while k < n_req or inflight:
        now = time.perf_counter() - t0
        tracer.tick()
        due = int(np.searchsorted(arr, now, side="right"))
        if k < due and len(inflight) < depth:
            n = min(due - k, max_b, r - k % r)
            inflight.append(server.dispatch(k, n))
            sent_t[k:k + n] = now
            k += n
        elif inflight and (len(inflight) >= depth or k >= n_req):
            b = inflight.popleft()
            with spans("bench.wait"):
                b.ev.synchronize()
            complete(b)
        elif inflight and inflight[0].ev.query():
            complete(inflight.popleft())
        elif inflight:
            with spans("bench.poll"):
                time.sleep(5e-5)
        else:
            with spans("bench.idle"):
                rest = arr[k] - (time.perf_counter() - t0)
                if rest > 2e-4:
                    time.sleep(rest - 2e-4)
                while time.perf_counter() - t0 < arr[k]:
                    pass
    lat = done_t - arr
    late = sent_t - arr
    return {"attempted": n_req, "latencies_s": lat, "lateness_s": late, "window_s": float(arr[-1]),
            "answered": int(np.isfinite(lat).sum())}


# ---------------------------------------------------------------------------
# the run
# ---------------------------------------------------------------------------


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=20, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def forbidden_modules(names=None) -> list:
    """Forbidden top-level names among ``names`` (default: the loaded modules)."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def logit_gap(served: torch.Tensor, ref: torch.Tensor) -> float:
    """The widest gap of a served logit from the reference's, as a share of
    that image's largest reference logit, over the rows given."""
    served, ref = served.to(torch.float64), ref.to(torch.float64)
    if not torch.isfinite(served).all():
        return float("inf")
    scale = ref.abs().amax(dim=1).clamp(min=1e-30)
    return float(((served - ref).abs().amax(dim=1) / scale).max())


def make_inputs(config: dict, seed: int, dev):
    """Weights, calibration images (uint8 and normalized) from the seed, in
    the generator's fixed order."""
    fam = family(config)
    gen = W.generator(seed, dev)
    params = W.build(fam.param_spec(config["sizes"]), gen, dev)
    cal_u8 = W.images(gen, config["quant"]["calib_batchsize"], config["sizes"]["img_size"], dev)
    pp = config["preprocess"]
    mean = torch.tensor(pp["mean"], dtype=torch.float32, device=dev)
    std = torch.tensor(pp["std"], dtype=torch.float32, device=dev)
    return gen, params, ref_vit.normalize_u8(cal_u8, mean, std)


def reference_gaps(config: dict, seed: int, dev, ring, batches: list) -> float:
    """The plain reference, from its own draw of the seed's weights and
    images, over each checked batch: the widest logit gap."""
    _, params, cal_x = make_inputs(config, seed, dev)
    fwd = family(config).reference(config, params, cal_x)
    del params, cal_x
    gap = 0.0
    r = ring.shape[0]
    for k0, n, served in batches:
        a = k0 % r
        ref = fwd(ring[a:a + n].to(dev)).cpu()
        gap = max(gap, logit_gap(served, ref))
    return gap


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Ctx:
    """What a metric's reader sees. ``result``: the loop's facts
    (``images_done``, ``window_s``; ``latencies_s``); ``trace``: the traced
    window (None untraced); ``images_traced`` and ``traced_s``: images
    answered inside it and its length on the host's clock; ``dispatch_s``:
    the seconds of each ``serving_forward`` call outside it."""

    family: str
    sizes: dict
    mix: dict
    setup_s: float
    result: dict
    trace: Trace | None
    traced_s: float | None
    images_traced: int
    dispatch_s: list

    def work(self, batch: int) -> dict:
        return counts.work(self.family, self.sizes, batch)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, dev, t_start: float) -> dict:
    """Run ``cell`` once; returns the result object (``None`` values absent)."""
    config, mix = cell.config, cell.mix
    fam = family(config)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    marks = [("start", t_start), ("imports", time.perf_counter())]
    gen, params, cal_x = make_inputs(config, seed, dev)
    marks.append(("weights and calibration images", time.perf_counter()))
    prog = fam.Program(config, params, cal_x)
    del params, cal_x
    marks.append(("calibrate, convert, ingest", time.perf_counter()))
    size = config["sizes"]["img_size"]
    ring_dev = W.images(gen, mix["ring_images"], size, dev)
    ring = torch.empty(ring_dev.shape, dtype=torch.uint8, pin_memory=dev.type == "cuda")
    ring.copy_(ring_dev)
    del ring_dev
    max_b = mix.get("max_batch", mix.get("batch"))
    spans = Spans()
    server = Server(prog.forward, ring, config["sizes"]["num_classes"], mix["in_flight"], max_b,
                    mix["check_batches"], seed, spans, dev)
    for n in mix["warmup_batches"]:
        server.dispatch(0, n).ev.synchronize()
    server.n_out = 0
    marks.append(("ring and warm-up", time.perf_counter()))
    setup_s = marks[-1][1] - t_start
    spans.rec.clear()
    log("setup_s " + "; ".join(f"{n} {b - a:.3f}" for (_, a), (n, b) in zip(marks, marks[1:])) + f"; all {setup_s:.3f}")

    tracer = Tracer(trace, seconds, spans, dev)
    if mix["loop"] == "closed":
        res = closed_loop(server, mix, seconds, tracer, spans)
    else:
        arr = traffic.arrivals(mix, config["name"], seed, seconds)
        res = open_loop(server, mix, arr, tracer, spans)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    tr = tracer.finish()
    bad = forbidden_modules()
    if bad:
        raise SystemExit(f"the run loaded {bad}: the benchmark runs the port alone")
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0

    # the facts the readers take
    hw = tracer.host_window
    calls = spans.rec.get("bench.forward", [])
    ctx = Ctx(config["family"], config["sizes"], mix, setup_s, res, tr, (hw[1] - hw[0]) if hw else None,
              tracer.images, [d for t, d in calls if hw is None or not (hw[0] <= t <= hw[1])])
    if "latencies_s" in res:
        lat = res["latencies_s"][np.isfinite(res["latencies_s"])] * 1e3
        late = res["lateness_s"][np.isfinite(res["lateness_s"])] * 1e3
        if lat.size:
            log(f"requests {lat.size}: latency ms p50 {np.percentile(lat, 50):.3f} p95 {np.percentile(lat, 95):.3f} "
                f"p99 {np.percentile(lat, 99):.3f}; sent late ms p50 {np.percentile(late, 50):.3f} "
                f"p99 {np.percentile(late, 99):.3f} max {late.max():.3f}")
    log(f"window: {len(calls)} forwards, mean dispatch ms {1e3 * np.mean([d for _, d in calls]):.3f}"
        if calls else "window: no forward")

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = reader(m["name"], cell.bench / "metrics")(ctx)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}

    # the check: free the program's state, then the reference
    checked = server.check_batches()
    del prog, server
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    unanswered = res["attempted"] - res["answered"]
    gap = reference_gaps(config, seed, dev, ring, checked)
    checks = {"logit_gap": {"value": gap, "limit": cell.limits["logit_gap"]},
              "unanswered": {"value": unanswered, "limit": 0}}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu",
              "count": 1, "memory_peak_bytes": int(peak), "power_limit_w": power_limit_w() if dev.type == "cuda" else None}
    out = {"correct": bool(correct), "attempted": int(res["attempted"]), "failed": int(unanswered),
           "metrics": metrics, "device": device}
    if tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        out["breakdown"] = tr.breakdown()
    out["checks"] = checks
    for name, c in checks.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return out

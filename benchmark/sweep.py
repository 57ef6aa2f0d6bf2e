"""Find an open-loop cell's knee once, on the card: one set-up, then the
open loop at each offered rate; per rate the latency percentiles, the
answered rate, the mean batch and whether the backlog grew (how late the
last quarter's requests were sent against the first quarter's).

    python3 benchmark/sweep.py --workload deit_b.online --rates 2000,3000,4000 --seconds 8

The rate chosen goes into the mix's file as a number; the
benchmark's runs never search.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True, help="comma-separated requests per second")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from benchmark import harness, traffic
    from benchmark import weights as W

    if not torch.cuda.is_available():
        print("sweep: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)  # as run.py
    cell = harness.load_cell(args.workload)
    cfg, mix = cell.config, dict(cell.mix)
    gen, params, cal_x = harness.make_inputs(cfg, args.seed, dev)
    prog = harness.family(cfg).Program(cfg, params, cal_x)
    ring = W.images(gen, mix["ring_images"], cfg["sizes"]["img_size"], dev).cpu().pin_memory()
    spans = harness.Spans()
    server = harness.Server(prog.forward, ring, cfg["sizes"]["num_classes"], mix["in_flight"], mix["max_batch"], 0,
                            args.seed, spans, dev)
    for n in mix["warmup_batches"]:
        server.dispatch(0, n).ev.synchronize()
    for rate in (float(r) for r in args.rates.split(",")):
        mix["rate_per_s"] = rate
        arr = traffic.arrivals(mix, cfg["name"], args.seed, args.seconds)
        spans.rec.clear()
        tracer = harness.Tracer(False, args.seconds, spans, dev)
        t = time.perf_counter()
        res = harness.open_loop(server, mix, arr, tracer, spans)
        wall = time.perf_counter() - t
        lat, late = res["latencies_s"] * 1e3, res["lateness_s"] * 1e3
        q = len(arr) // 4
        fwd = spans.rec.get("bench.forward", [])
        print(json.dumps({
            "rate": rate, "requests": len(arr), "answered_per_s": len(arr) / wall, "wall_s": wall,
            "p50_ms": float(np.percentile(lat, 50)), "p95_ms": float(np.percentile(lat, 95)),
            "p99_ms": float(np.percentile(lat, 99)), "mean_batch": len(arr) / max(1, len(fwd)),
            "dispatch_ms": 1e3 * float(np.mean([d for _, d in fwd])) if fwd else None,
            "late_first_q_ms": float(np.mean(late[:q])), "late_last_q_ms": float(np.mean(late[-q:]))}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

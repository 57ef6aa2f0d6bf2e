"""Run one cell of the port's benchmark once and print its result.

    python3 benchmark/run.py --workload deit_b.bulk --seed 7 --seconds 10 --trace 0

The cell (configuration × traffic mix) is named in ``BENCHMARK.json`` at the
checkout's root. With ``--trace 0`` the last line of standard output is the
cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics, read
from a profiled sub-window, and a ``breakdown``. The last lines of standard
error give each number compared with the plain reference beside its limit.
Needs a CUDA card: without one it exits with code 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.environ.setdefault("USE_FLAX", "0")  # a library of the port's may not pull in JAX
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    torch.set_num_threads(1)  # one process, few threads: the host path is a single thread of launches

    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("benchmark: no CUDA card; the benchmark measures the port on the card and has no CPU fallback",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T_START)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

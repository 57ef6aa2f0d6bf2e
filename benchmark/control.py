"""Readings that set a cell's ``logit_gap`` limit, on the card at the cell's
own batch: for each seed, the gap of the program's logits from the plain
reference's (the lower reading, also read by every run), and the gap of the
control, the reference computed with 4-bit activations (the upper reading).

    python3 benchmark/control.py --workload deit_b.bulk --seeds 11,12,13

One JSON line a seed. The benchmark's own runs never run the control.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(cell, seed: int, dev, program: bool = True) -> dict:
    import torch

    from benchmark import harness
    from benchmark import weights as W
    from benchmark.reference import intops

    cfg, mix = cell.config, cell.mix
    fam = harness.family(cfg)
    n = mix.get("max_batch", mix.get("batch"))
    gen, params, cal_x = harness.make_inputs(cfg, seed, dev)
    x = W.images(gen, mix["ring_images"], cfg["sizes"]["img_size"], dev)[:n].contiguous()
    out = {"seed": seed, "batch": n}
    if program:
        prog = fam.Program(cfg, params, cal_x)
        served = prog.forward(x).cpu()
        del prog
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    _, params, cal_x = harness.make_inputs(cfg, seed, dev)
    fwd = fam.reference(cfg, params, cal_x)
    del params, cal_x
    ref = fwd(x).cpu()
    if program:
        out["program_gap"] = harness.logit_gap(served, ref)
    out["control_gap"] = harness.logit_gap(fwd(x, intops.codes4).cpu(), ref)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--no-program", action="store_true", help="the control alone")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import harness

    if not torch.cuda.is_available():
        print("control: no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, torch.device("cuda", 0), not args.no_program)
        r["workload"], r["seconds"] = args.workload, time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The two weight stores' requant GEMMs in device time, per checkout.

    python p2vit_tpu_torch/tools/w4pack_bench.py [--root DIR] [--ms 197,1576,12608] [--depth 12]
                                                 [--reps 20] [--device cuda|cpu]

On the seeded operands of ``tools/w4pack_latency.py`` (the DeiT-S GEMMs and
the deit_base fc2 control, int4-valued codes, PoT requants): for each M and
each store, ``int8_matmul_requant`` over the (N, K) int8 store (``i8``) and
``int4_matmul_requant`` over ``pack_int4``'s store (``w4p``), the device
time of the port's kernels (``torch.profiler``: kernels named in the
``p2v::`` or anonymous namespace) per depth-``--depth`` chain (qkv → proj →
fc1 with GELU → fc2) and per GEMM call, beside the bound of each (each GEMM
the larger of its bytes over 3.35 TB/s and its int8 products over
1,979 TOP/s; a chain sums its GEMMs'). Every GEMM's two stores must give
the same codes. ``--root`` names the checkout whose ``p2vit_tpu_torch`` is
imported (default: the one holding this file), so one run on the card can
measure an older commit beside this one, parent, change, change, parent.

Needs the card; ``--device cpu`` runs the plain versions and prints the
bounds only (no device time). Prints one JSON line per M.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_S, INT8_OPS_S = 3.35e12, 1979e12
ARMS = ("i8", "w4p")


def port_device_us(fn, reps: int, tries: int = 3) -> float:
    """Device µs per call of the port's kernels that ``fn`` launches, from
    ``torch.profiler`` after a warm-up."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        for _ in range(tries):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            t = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == DeviceType.CUDA and ("p2v::" in e.key or "anonymous namespace" in e.key))
            if t > 0:
                return t / reps
    raise RuntimeError(f"the profiler saw no device time in {tries} windows of {reps} calls")


def gemm_bound_us(m: int, k: int, n: int, packed: bool) -> float:
    """x, the store (N·K, or N·K/2 packed), r, b and the int8 output once
    over the HBM rate, against the int8 products over their peak."""
    nbytes = m * k + n * k // (2 if packed else 1) + 8 * n + m * n
    return max(nbytes / HBM_BYTES_S, 2 * m * n * k / INT8_OPS_S) * 1e6


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch is imported")
    ap.add_argument("--ms", default="197,1576,12608", help="token rows: 197 per image")
    ap.add_argument("--depth", type=int, default=12)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions and the bounds only, no device time")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("w4pack_bench: needs a CUDA device (or --device cpu for the plain versions)")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch.tools import _gemm_bench as gb
    from p2vit_tpu_torch.tools import w4pack_latency as wl

    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = torch.cuda.get_device_name(0) if on_card else "none (cpu: plain versions)"
    lines = []
    for m in (int(v) for v in args.ms.split(",")):
        line = {"root": args.root, "m": m, "depth": args.depth, "card": card}
        case = wl.chain_case(m, m + 1, args.depth, dev)
        outs = [wl.chain(arm, *case) for arm in ARMS]
        if not torch.equal(*outs):
            raise SystemExit(f"w4pack_bench: the two stores' chains differ at M={m}")
        for arm in ARMS:
            line[f"chain_bound_us {arm}"] = round(sum(gemm_bound_us(m, k, n, arm == "w4p")
                                                      for _, k, n, _ in gb.DEIT_S_GEMMS) * args.depth, 3)
            if on_card:
                line[f"chain_us {arm}"] = round(port_device_us(lambda arm=arm: wl.chain(arm, *case),
                                                               max(2, args.reps // 4)), 2)
        rng = np.random.RandomState(m)
        for name, k, n, gelu in (*gb.DEIT_S_GEMMS, gb.CONTROL):
            x, stores, r, b, kw = wl.gemm_case(m, k, n, gelu, rng, dev)
            if not torch.equal(*(wl._mm(arm)(x, stores[arm], r, b, **kw) for arm in ARMS)):
                raise SystemExit(f"w4pack_bench: the two stores differ on {name} at M={m}")
            for arm in ARMS:
                line[f"{name}_bound_us {arm}"] = round(gemm_bound_us(m, k, n, arm == "w4p"), 3)
                if on_card:
                    line[f"{name}_us {arm}"] = round(port_device_us(
                        lambda arm=arm: wl._mm(arm)(x, stores[arm], r, b, **kw), args.reps), 2)
        lines.append(line)
        print(json.dumps(line), flush=True)
    return lines


if __name__ == "__main__":
    main()

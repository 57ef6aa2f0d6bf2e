"""``int8_matmul_requant`` (or, with ``--junction``, ``int8_matmul_res_ln``)
at every call of the DeiT-S and Swin-T serving paths (batch 64), one shape
at a time, and the two models' forward latency at batches 1 and 8.

    python p2vit_tpu_torch/tools/requant_bench.py [--root DIR] [--junction [--plans]] [--latency] [--reps 10]

``--root`` names the checkout whose ``p2vit_tpu_torch`` is imported (default:
the one holding this file), so one run on the card can measure an older
commit unpacked beside this one, in turns with this one. Per shape: the
kernel against its plain version on seeded codes (mismatches; must be 0),
its device µs per call (``torch.profiler``: every kernel one wrapper call
launches, the constant vectors and any padding included; a reading of 0 is
taken again, and raises the third time), its bound (the larger of its
bytes over 3.35 TB/s and its products over the int8 peak, 1,979 TOP/s) and
``torch._int_mm``'s device µs for the int32 product alone (a reference: not
the same function). Per path: the device ms per forward, Σ calls × µs.
``--junction --plans`` also times the junction on every plan that fits
(cluster size, consumers), the measurement behind its plan's choice.
``--latency``: DeiT-S and Swin-T ``serving_forward`` at batches 1 and 8 on
seeded weights calibrated on 8 images, median and p10 of 60 host-clock
forwards, each ended by a synchronize; and the wrappers' host µs per call
(2,000 calls back to back, then one synchronize: the requant head at M = 1,
the junction at DeiT-S's batch-1 proj shape). Needs the card; prints one
JSON line per shape, per path and for the latency.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_S, INT8_OPS_S = 3.35e12, 1979e12
# path → [((M, K, N), GELU, calls per forward)] at batch 64
SHAPES = {
    "swin": [((200704, 96, 288), 0, 2), ((200704, 96, 96), 0, 2), ((200704, 96, 384), 1, 2),
             ((200704, 384, 96), 0, 1), ((50176, 384, 192), 0, 1), ((50176, 192, 576), 0, 2),
             ((50176, 192, 192), 0, 2), ((50176, 192, 768), 1, 2), ((50176, 768, 192), 0, 1),
             ((12544, 768, 384), 0, 1), ((12544, 384, 1152), 0, 6), ((12544, 384, 384), 0, 6),
             ((12544, 384, 1536), 1, 6), ((12544, 1536, 384), 0, 1), ((3136, 1536, 768), 0, 1),
             ((3136, 768, 2304), 0, 2), ((3136, 768, 768), 0, 2), ((3136, 768, 3072), 1, 2),
             ((64, 768, 1000), 0, 1)],
    "deit": [((12608, 384, 1536), 1, 12), ((64, 384, 1000), 0, 1)],
    "deit_staged adds": [((12608, 384, 1152), 0, 12), ((12544, 768, 384), 0, 1)],
    "swin_int_stem_unfused adds": [((200704, 48, 96), 0, 1)],
}
# int8_matmul_res_ln: path → [((M, K, N), calls per forward)] at batch 64
JUNCTION_SHAPES = {
    "deit": [((12608, 384, 384), 12), ((12608, 1536, 384), 12)],
    "swin": [((200704, 384, 96), 1), ((50176, 768, 192), 1), ((12544, 1536, 384), 5), ((3136, 3072, 768), 2)],
}


def _device_times(fn, reps, tries=3):
    """Device µs per call of each kernel ``fn`` launches, by name, from
    ``torch.profiler`` after one warm-up call; a window in which the
    profiler saw no device time is taken again, and raises after ``tries``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        by_name = {e.key: e.self_device_time_total / reps for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
        if by_name:
            return by_name
    raise RuntimeError(f"the profiler saw no device time in {tries} windows of {reps} calls")


def _device_us(fn, reps):
    """Device µs per call of every kernel ``fn`` launches."""
    return sum(_device_times(fn, reps).values())


def shapes(mi, dev, reps, tag):
    for path, rows in SHAPES.items():
        total = 0.0
        for (m, k, n), gelu, calls in rows:
            rng = np.random.RandomState(m + n + k)
            x = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8)).to(dev)
            w = torch.from_numpy(rng.randint(-8, 8, (n, k)).astype(np.int8)).to(dev)
            lo, hi = (-14, -9) if gelu else (-12, -7)
            r = torch.from_numpy((2.0 ** rng.randint(lo, hi, n)).astype(np.float32)).to(dev)
            b = torch.from_numpy(rng.randn(n).astype(np.float32)).to(dev)
            kw = dict(out_inv=torch.tensor(16.0 if gelu else 1.0, device=dev), gelu=bool(gelu))
            got = mi.int8_matmul_requant(x, w, r, b, **kw)
            bad = int((got != mi.int8_matmul_requant_plain(x, w, r, b, **kw)).sum())
            us = _device_us(lambda: mi.int8_matmul_requant(x, w, r, b, **kw), reps)
            wt = w.t()
            int_mm = round(_device_us(lambda: torch._int_mm(x, wt), reps), 2) if m > 16 else None
            nbytes = m * k + n * k + m * n + 8 * n + 4
            bound = max(nbytes / HBM_BYTES_S, 2 * m * n * k / INT8_OPS_S) * 1e6
            total += us * calls
            print(f"[{tag}] " + json.dumps(dict(path=path, shape=[m, k, n], gelu=gelu, calls=calls, mismatches=bad,
                                                device_us=round(us, 2), bound_us=round(bound, 2),
                                                int_mm_us=int_mm)), flush=True)
        print(f"[{tag}] " + json.dumps({"path": path, "device_ms_per_forward": round(total / 1e3, 4)}), flush=True)


def junction_shapes(ml, dev, reps, tag, plans=False):
    """``int8_matmul_res_ln`` at its serving shapes, on seeded codes with
    PoT and PTF scales (masks 1 to 8): device µs of the whole call and of
    the junction kernel alone (``kernel_us``; the rest is the wrapper's
    constant vectors and padding). ``plans``: also the kernel alone on every
    plan that fits, by cluster size and consumers (``int8_matmul_res_ln_forced``;
    mismatches against the plain version must be 0), at each shape and at
    DeiT-S's proj and fc2 shapes at batches 1 and 8."""
    shapes = dict(JUNCTION_SHAPES)
    if plans:
        shapes["deit batch 1"] = [((197, 384, 384), 12), ((197, 1536, 384), 12)]
        shapes["deit batch 8"] = [((1576, 384, 384), 12), ((1576, 1536, 384), 12)]
    for path, rows in shapes.items():
        total = ktotal = 0.0
        for (m, k, n), calls in rows:
            rng = np.random.RandomState(m + n + k)
            t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
            x, w = t(rng.randint(-128, 128, (m, k)).astype(np.int8)), t(rng.randint(-8, 8, (n, k)).astype(np.int8))
            args = (x, w, t((2.0 ** rng.randint(-10, -6, n)).astype(np.float32)),
                    t(rng.randn(n).astype(np.float32)), t(rng.randint(-128, 128, (m, n)).astype(np.int8)),
                    t((np.abs(rng.randn(n)) * 0.02 + 0.01).astype(np.float32)),
                    t((0.011 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)),
                    t((0.013 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)),
                    t(rng.randn(n).astype(np.float32)), t((rng.randn(n) * 0.1).astype(np.float32)),
                    t((np.abs(rng.randn(n)) * 0.03 + 0.01).astype(np.float32)),
                    t((2.0 ** rng.randint(-1, 2, n)).astype(np.float32)))
            got, want = ml.int8_matmul_res_ln(*args), ml.int8_matmul_res_ln_plain(*args)
            bad = sum(int((g != w_).sum()) for g, w_ in zip(got, want))
            times = _device_times(lambda: ml.int8_matmul_res_ln(*args), reps)
            us = sum(times.values())
            kernel_us = sum(v for name, v in times.items() if "res_ln_kernel" in name)
            wt = w.t()
            int_mm = round(_device_us(lambda: torch._int_mm(x, wt), reps), 2)
            nbytes = m * k + n * k + 3 * m * n + 9 * 4 * n + 4
            bound = max(nbytes / HBM_BYTES_S, 2 * m * n * k / INT8_OPS_S) * 1e6
            total += us * calls
            ktotal += kernel_us * calls
            if plans:
                info = ml.res_ln_kernel_info(m, n)
                chosen = ml.res_ln_plan(m, n, k, info["sms"], info["resident"])
                sweep = {}
                for cs in range(1, ml.MAX_CLUSTER + 1):
                    for nc in range(1, ml.MAX_CONSUMERS + 1):
                        try:
                            ml.res_ln_plan(m, n, k, info["sms"], info["resident"], cs, nc)
                        except ValueError:
                            continue
                        got = ml.int8_matmul_res_ln_forced(*args, cs=cs, nc=nc)
                        miss = sum(int((g != w_).sum()) for g, w_ in zip(got, want))
                        t = _device_times(lambda: ml.int8_matmul_res_ln_forced(*args, cs=cs, nc=nc), reps)
                        sweep[f"cs{cs} nc{nc}"] = [round(sum(v for nm, v in t.items() if "res_ln_kernel" in nm), 2),
                                                   miss]
                print(f"[{tag}] " + json.dumps(dict(kernel="int8_matmul_res_ln plans", shape=[m, k, n],
                                                    chosen=f"cs{chosen.cs} nc{chosen.nc}",
                                                    resident=info["resident"], kernel_us_mismatches=sweep)),
                      flush=True)
            print(f"[{tag}] " + json.dumps(dict(path=path, kernel="int8_matmul_res_ln", shape=[m, k, n], calls=calls,
                                                mismatches=bad, device_us=round(us, 2), kernel_us=round(kernel_us, 2),
                                                bound_us=round(bound, 2), int_mm_us=int_mm)), flush=True)
        print(f"[{tag}] " + json.dumps({"path": path, "kernel": "int8_matmul_res_ln",
                                        "device_ms_per_forward": round(total / 1e3, 4),
                                        "kernel_ms_per_forward": round(ktotal / 1e3, 4)}), flush=True)


def latency(mi, ml, dev, tag):
    from p2vit_tpu_torch import serving, serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO, swin, vit

    g = torch.Generator().manual_seed(1)
    pol = make_policy(lis=True)
    cfg = VIT_ZOO["deit_small_patch16_224"]
    p = vit.init_params(0, cfg, device=dev)
    q = vit.calibrate(p, cfg, pol, torch.randn((8, 3, 224, 224), generator=g).to(dev)).qstate
    s = serving.convert(p, q, cfg, pol, [4] * cfg.num_matmuls)
    scfg = SWIN_ZOO["swin_tiny_patch4_window7_224"]
    sp = swin.init_params(0, scfg, device=dev)
    sq = swin.calibrate(sp, scfg, pol, torch.randn((8, 3, 224, 224), generator=g).to(dev)).qstate
    ss = serving_swin.convert(sp, sq, scfg, pol, 4)
    forwards = {"deit": lambda x: serving.serving_forward(s, cfg, x),
                "swin": lambda x: serving_swin.serving_forward(ss, sq, scfg, pol, x)}
    out = {}
    with torch.no_grad():
        for name, fwd in forwards.items():
            for bsz in (1, 8):
                x = torch.randn((bsz, 3, 224, 224), generator=g).to(dev)
                for _ in range(10):
                    fwd(x)
                torch.cuda.synchronize()
                ts = []
                for _ in range(60):
                    t0 = time.perf_counter()
                    fwd(x)
                    torch.cuda.synchronize()
                    ts.append((time.perf_counter() - t0) * 1e3)
                ts.sort()
                out[f"{name} batch {bsz}"] = {"median_ms": round(ts[30], 4), "p10_ms": round(ts[6], 4)}
        x = torch.randint(-128, 128, (1, 384), dtype=torch.int8).to(dev)
        w = torch.randint(-8, 8, (1000, 384), dtype=torch.int8).to(dev)
        r, b = torch.full((1000,), 2.0 ** -10, device=dev), torch.zeros(1000, device=dev)
        for _ in range(100):
            mi.int8_matmul_requant(x, w, r, b)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            mi.int8_matmul_requant(x, w, r, b)
        torch.cuda.synchronize()
        out["wrapper host us per call"] = round((time.perf_counter() - t0) / 2000 * 1e6, 3)
        # the junction's wrapper at DeiT-S's batch-1 proj shape (M = 197, K = N = 384)
        rng = np.random.RandomState(2)
        t = lambda a: torch.from_numpy(np.asarray(a)).to(dev)  # noqa: E731
        v = lambda: t((2.0 ** rng.randint(-10, -6, 384)).astype(np.float32))  # noqa: E731
        args = (t(rng.randint(-128, 128, (197, 384)).astype(np.int8)), t(rng.randint(-8, 8, (384, 384)).astype(np.int8)),
                v(), v(), t(rng.randint(-128, 128, (197, 384)).astype(np.int8)), v(), v(), v(), v(), v(), v(), v())
        for _ in range(100):
            ml.int8_matmul_res_ln(*args)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(2000):
            ml.int8_matmul_res_ln(*args)
        torch.cuda.synchronize()
        out["junction wrapper host us per call"] = round((time.perf_counter() - t0) / 2000 * 1e6, 3)
    print(f"[{tag}] " + json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch to import")
    ap.add_argument("--junction", action="store_true",
                    help="time int8_matmul_res_ln at its shapes instead of int8_matmul_requant")
    ap.add_argument("--plans", action="store_true",
                    help="with --junction: also every plan that fits, by cluster size and consumers")
    ap.add_argument("--latency", action="store_true", help="also time the forwards at batches 1 and 8")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("requant_bench: needs a CUDA device")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch.ops import _lib, matmul_int8 as mi, matmul_ln as ml

    _lib.library()
    dev = torch.device("cuda", 0)
    tag = args.root
    if args.junction:
        junction_shapes(ml, dev, args.reps, tag, args.plans)
    else:
        shapes(mi, dev, args.reps, tag)
    if args.latency:
        latency(mi, ml, dev, tag)


if __name__ == "__main__":
    main()

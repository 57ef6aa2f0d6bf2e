"""``int8_matmul_requant`` at every call of the DeiT-S and Swin-T serving
paths (batch 64), one shape at a time, and the two models' forward latency
at batches 1 and 8.

    python p2vit_tpu_torch/tools/requant_bench.py [--root DIR] [--latency] [--reps 10]

``--root`` names the checkout whose ``p2vit_tpu_torch`` is imported (default:
the one holding this file), so one run on the card can measure an older
commit unpacked beside this one, in turns with this one. Per shape: the
kernel against its plain version on seeded codes (mismatches; must be 0),
its device µs per call (``torch.profiler``: every kernel one wrapper call
launches, the constant vectors and any row padding included), its
bound (the larger of its bytes over 3.35 TB/s and its products over the
int8 peak, 1,979 TOP/s) and ``torch._int_mm``'s device µs for the int32
product alone (a reference: not the same function). Per path: the device
ms per forward, Σ calls × µs. ``--latency``: DeiT-S and Swin-T
``serving_forward`` at batches 1 and 8 on seeded weights calibrated on 8
images, median and p10 of 60 host-clock forwards, each ended by a
synchronize; and the wrapper's host µs per call (2,000 head calls at M = 1
back to back, then one synchronize). Needs the card; prints one JSON line
per shape, per path and for the latency.
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


def _device_us(fn, reps):
    """Device µs per call of every kernel ``fn`` launches, from
    ``torch.profiler`` after one warm-up call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA) / reps


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


def latency(mi, dev, tag):
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
    print(f"[{tag}] " + json.dumps(out), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch to import")
    ap.add_argument("--latency", action="store_true", help="also time the forwards at batches 1 and 8")
    ap.add_argument("--reps", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("requant_bench: needs a CUDA device")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch.ops import _lib, matmul_int8 as mi

    _lib.library()
    dev = torch.device("cuda", 0)
    tag = args.root
    shapes(mi, dev, args.reps, tag)
    if args.latency:
        latency(mi, dev, tag)


if __name__ == "__main__":
    main()

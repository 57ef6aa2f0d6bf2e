"""The Swin windowed attention kernels at every call of a Swin-T forward.

    python p2vit_tpu_torch/tools/swin_attention_bench.py [--root DIR] [--batch 64] [--reps 10]

``--root`` names the checkout whose ``p2vit_tpu_torch`` is imported (default:
the one holding this file), so one run on the card can measure an older
commit unpacked beside this one, in turns with this one. For each entry
(``swin_lis_attention`` on window panels, ``swin_lis_attention_folded`` on
the raster grid, shifted blocks at shift 3 where the checkout takes the
shift) and LIS on and off, at Swin-T's four stages (res 56/28/14/7, heads
3/6/12/24, 7×7 windows; the folded entry only where a stage has more than
one window) with and without the shift mask: the kernel against its plain
version on seeded codes (mismatches; must be 0), its device µs per call
(``torch.profiler``: every kernel the wrapper launches, and the attention
kernel alone), its bound (the
larger of its bytes over 3.35 TB/s and its two products over the int8
peak, 1,979 TOP/s), the calls a Swin-T forward makes, and, where the
checkout has the hooks, the middle CTA's phase clock (µs over its items) and
the spread of the CTAs' durations (%globaltimer at each CTA's start and end);
``--grids`` also times the kernel alone on forced grids (the grid hook).
Per entry and arm: the device ms per forward, Σ calls × µs (the wrapper's
and the kernel's). Needs the card;
prints one JSON line per shape and per forward.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_S, INT8_OPS_S = 3.35e12, 1979e12
STAGES = ((56, 3, 2), (28, 6, 2), (14, 12, 6), (7, 24, 2))  # Swin-T: (res, heads, blocks)
WS = 7


def _device_us(fn, reps, tries=3):
    """Device µs per call of everything ``fn`` launches and of the attention
    kernel alone (``swin_attention_kernel``), from ``torch.profiler`` after
    one warm-up call; a window with no device time is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        t = sum(e.self_device_time_total for e in ev)
        if t > 0:
            return t / reps, sum(e.self_device_time_total for e in ev if "swin_attention_kernel" in e.key) / reps
    raise RuntimeError(f"the profiler saw no device time in {tries} windows of {reps} calls")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch is imported")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--grids", default="",
                    help="also time the kernel on these forced grids (comma-separated CTA counts, 'items' for one "
                         "item per CTA; the checkout's grid hook)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("swin_attention_bench: needs a CUDA device")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch.models import swin
    from p2vit_tpu_torch.ops import attention_lis as al

    dev = torch.device("cuda", 0)
    b, tag = args.batch, args.root
    rng = np.random.RandomState(0)
    sc = (2.0**-9, 2.0**-4, 2.0**-4, 2.0**-2)
    totals = {}
    for fold in (False, True):
        for lis in (True, False):
            name = "swin_lis_attention_folded" if fold else "swin_lis_attention"
            kern, plain = getattr(al, name), getattr(al, name + "_plain")
            key = f"{name} {'LIS' if lis else 'LIS off'}"
            for res, heads, blocks in STAGES:
                g2 = (res // WS) ** 2
                if fold and g2 == 1:
                    continue
                c = 32 * heads
                qkv = torch.from_numpy(rng.randint(-128, 128, (b, res, res, 3 * c)).astype(np.int8)).to(dev)
                bias = torch.from_numpy((rng.randn(heads, 49, 49) * 0.3).astype(np.float32)).to(dev)
                mask = (torch.from_numpy(swin.shift_attn_mask(res, res, WS, 3) / sc[2]).float().to(dev)
                        if g2 > 1 else None)
                x = qkv if fold else swin.window_partition(qkv, WS).contiguous()
                for masked in ((False, True) if g2 > 1 else (False,)):
                    calls = blocks // 2 if g2 > 1 else blocks
                    a = (x, bias, mask if masked else None, heads, WS if fold else g2) + sc
                    kw = dict(lis=lis)
                    if fold and masked:
                        try:
                            kern(*a, lis=lis, shift=3)
                            kw["shift"] = 3
                        except TypeError:
                            pass  # a checkout whose folded entry takes no shift
                    got, want = kern(*a, **kw), plain(*a, **kw)
                    bad = int((got != want).sum())
                    us, kern_us = _device_us(lambda: kern(*a, **kw), args.reps)
                    nbytes = qkv.numel() + got.numel() + bias.numel() * 4 + (mask.numel() * 4 if masked else 0)
                    ops = 4 * b * res * res * 49 * c
                    bound = max(nbytes / HBM_BYTES_S, ops / INT8_OPS_S) * 1e6
                    grids = {}
                    for g in filter(None, args.grids.split(",")):
                        n_ctas = b * g2 * heads if g == "items" else int(g)
                        grids[g] = round(_device_us(lambda: kern(*a, **kw, grid=n_ctas), args.reps)[1], 3)
                    phases = None
                    try:
                        st = torch.zeros(9, dtype=torch.int64, device=dev)
                        kern(*a, **kw, phase_ns=st)
                        torch.cuda.synchronize()
                        names = al.SWIN_PHASES if lis else al.SWIN_PHASES_LISOFF
                        phases = dict(zip(names, (st[:len(names)].double() / 1e3).tolist()))
                        phases.update(total=float(st[5]) / 1e3, items=int(st[6]), grid=int(st[7]),
                                      bias_stagings=int(st[8]))
                        spans = torch.zeros(2 * int(st[7]), dtype=torch.int64, device=dev)
                        kern(*a, **kw, cta_ns=spans)
                        torch.cuda.synchronize()
                        se = spans.view(-1, 2).double()
                        dur = (se[:, 1] - se[:, 0]) / 1e3
                        q = torch.quantile(dur, torch.tensor([0.0, 0.5, 0.9, 1.0], dtype=torch.float64, device=dev))
                        phases["cta_us_min_med_p90_max"] = [round(x, 2) for x in q.tolist()]
                        phases["launch_spread_us"] = round(float(se[:, 0].max() - se[:, 0].min()) / 1e3, 2)
                        phases["kernel_span_us"] = round(float(se[:, 1].max() - se[:, 0].min()) / 1e3, 2)
                    except (TypeError, AttributeError):
                        pass  # a checkout without the phase hook
                    tot = totals.setdefault(key, [0.0, 0.0])
                    tot[0] += calls * us
                    tot[1] += calls * kern_us
                    print(json.dumps({"root": tag, "entry": name, "lis": lis, "batch": b, "res": res, "heads": heads,
                                      "masked": masked, "shift": kw.get("shift", 0), "calls": calls,
                                      "mismatches": bad, "device_us": round(us, 3), "kernel_us": round(kern_us, 3),
                                      "bound_us": round(bound, 3), "forced_grid_kernel_us": grids,
                                      "phases_us": phases}), flush=True)
                    if bad:
                        raise SystemExit(f"swin_attention_bench: {name} disagrees with its plain version")
    for key, (us, kern_us) in totals.items():
        print(json.dumps({"root": tag, "forward": key, "batch": b, "device_ms": round(us / 1e3, 4),
                          "kernel_ms": round(kern_us / 1e3, 4), "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()

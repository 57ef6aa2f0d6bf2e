"""The two int-LN kernels at every call shape of a Swin-T forward.

    python p2vit_tpu_torch/tools/intln_bench.py [--root DIR] [--batch 64] [--reps 20] [--variants]

``--root`` names the checkout whose ``p2vit_tpu_torch`` is imported (default:
the one holding this file), so one run on the card can measure an older
commit unpacked beside this one, in turns with this one. For
``int_res_ln_requant`` (the attention-side junctions: C = 96, 192, 384, 768
at 56², 28², 14², 7² tokens an image) and ``int_ln_requant`` (the patch norm
and each stage's first norm1 at the same shapes, the PatchMerging norms at
4C = 384, 768, 1536), on seeded codes with PTF masks {1, 2, 4, 8}: the
kernel against its plain version (mismatches; must be 0), its device µs per
call (``torch.profiler``: every kernel the wrapper launches, and the int-LN
kernel alone), its bound (bytes over 3.35 TB/s: each operand read once,
each output written once, the column vectors), the calls a Swin-T forward
makes, and per kernel the device ms per forward, Σ calls × µs.
``--variants`` also times the kernel alone with G halved and doubled (the
forced-launch hooks, where the checkout has them). Needs the card; prints one JSON line per shape and per kernel.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_S = 3.35e12
# Swin-T at one image: (tokens, C) per stage and the blocks of each stage
STAGES = ((3136, 96, 2), (784, 192, 2), (196, 384, 6), (49, 768, 2))
KERNEL_NAMES = re.compile(r"int_ln_kernel|int_(res_)?ln_requant_kernel")


def calls(batch):
    """{kernel: [((M, C), calls per forward)]} of a Swin-T forward."""
    res = [((batch * n, c), blocks) for n, c, blocks in STAGES]
    ln = [((batch * n, c), 2 if s == 0 else 1) for s, (n, c, _) in enumerate(STAGES)]  # stage 0: the patch norm too
    # the PatchMerging norms: 4C of a stage at the next stage's tokens
    ln += [((batch * nxt[0], 4 * cur[1]), 1) for cur, nxt in zip(STAGES, STAGES[1:])]
    return {"int_res_ln_requant": res, "int_ln_requant": ln}


def _device_us(fn, reps, tries=3):
    """Device µs per call of everything ``fn`` launches and of the int-LN
    kernel alone, from ``torch.profiler`` after one warm-up call; a window
    with no device time is taken again."""
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
            return t / reps, sum(e.self_device_time_total for e in ev if KERNEL_NAMES.search(e.key)) / reps
    raise RuntimeError(f"the profiler saw no device time in {tries} windows of {reps} calls")


def _args(name, m, c, rng, dev):
    """Seeded operands of one call, as the Swin path gives them."""
    def ptf(base):
        return torch.from_numpy((base * 2.0 ** rng.randint(0, 4, c)).astype(np.float32))

    def codes():
        return torch.from_numpy(rng.randint(-128, 128, (m, c)).astype(np.int8))

    w = torch.from_numpy(rng.randn(c).astype(np.float32))
    b = torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32))
    if name == "int_res_ln_requant":
        a = [codes(), ptf(0.011), codes(), torch.tensor(2.0**-5), ptf(0.017), w, b, torch.tensor(2.0**-4), 1.0]
    else:
        s_in = ptf(0.013)
        a = [codes(), torch.round(s_in / s_in.min()), s_in.min(), w, b,
             torch.from_numpy((np.abs(rng.randn(c)) * 0.03 + 0.01).astype(np.float32)), 1.0]
    return [t.to(dev) if isinstance(t, torch.Tensor) else t for t in a]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch is imported")
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--variants", action="store_true",
                    help="also time the kernel at G halved and doubled, where the checkout has the hooks")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("intln_bench: needs a CUDA device")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch.ops import intln

    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    for name, shapes in calls(args.batch).items():
        kern, plain = getattr(intln, name), getattr(intln, name + "_plain")
        forced = getattr(intln, name + "_forced", None)
        tot = [0.0, 0.0, 0.0]
        for (m, c), n_calls in shapes:
            a = _args(name, m, c, rng, dev)
            got, want = kern(*a), plain(*a)
            got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
            bad = sum(int((g != w).sum()) for g, w in zip(got, want))
            us, kern_us = _device_us(lambda: kern(*a), args.reps)
            nbytes = sum(t.numel() for t in a if isinstance(t, torch.Tensor) and t.dtype == torch.int8)
            nbytes += sum(t.numel() for t in got) + (7 if name == "int_res_ln_requant" else 4) * c * 4
            bound = nbytes / HBM_BYTES_S * 1e6
            line = {"root": args.root, "kernel": name, "batch": args.batch, "m": m, "c": c, "calls": n_calls,
                    "mismatches": bad, "device_us": round(us, 3), "kernel_us": round(kern_us, 3),
                    "bound_us": round(bound, 3), "x_bound": round(kern_us / bound, 3)}
            if hasattr(intln, "ln_kernel_info"):
                info = intln.ln_kernel_info(m, c, name == "int_res_ln_requant")
                line["plan"] = {k: info[k] for k in ("g", "k", "rows", "blocks", "grid", "ctas_per_sm",
                                                     "registers", "spill_bytes", "smem_bytes")}
                if args.variants and forced is not None:
                    var = {}
                    for g in sorted({max(1, info["g"] // 2), info["g"], min(32, info["g"] * 2)}):
                        try:
                            var[f"g{g}"] = round(_device_us(lambda: forced(*a, g=g), args.reps)[1], 3)
                        except ValueError:
                            pass  # more chunks a lane than the kernel takes
                    line["variants_kernel_us"] = var
            print(json.dumps(line), flush=True)
            if bad:
                raise SystemExit(f"intln_bench: {name} disagrees with its plain version at {(m, c)}")
            tot[0] += n_calls * us
            tot[1] += n_calls * kern_us
            tot[2] += n_calls * bound
        print(json.dumps({"root": args.root, "forward": name, "batch": args.batch,
                          "calls": sum(n for _, n in shapes), "device_ms": round(tot[0] / 1e3, 4),
                          "kernel_ms": round(tot[1] / 1e3, 4), "bound_ms": round(tot[2] / 1e3, 4),
                          "card": torch.cuda.get_device_name(0)}), flush=True)


if __name__ == "__main__":
    main()

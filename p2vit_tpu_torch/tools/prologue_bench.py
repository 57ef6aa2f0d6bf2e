"""The two prologue kernels at the zoo's shapes.

    python p2vit_tpu_torch/tools/prologue_bench.py [--root DIR] [--batches 1,8,64] [--reps 20] [--plans]
                                                   [--paths] [--device cuda|cpu]

``fused_patch_embed`` at DeiT-T/S/B and ViT-L (C = 192, 384, 768, 1024; 196
patches of K = 768 an image) and ``fused_swin_stem`` at Swin-T and Swin-B
(C = 96, 128; 3136 patches of K = 48 an image), on seeded operands of the
serving path's kinds (int8 patch codes, int4-valued weights, PTF scales;
float32 patches and weights for the stem), at each batch: the kernel
against its plain version (mismatches; must be 0), its device µs per call
(``torch.profiler``: every kernel the wrapper launches, and the kernel
alone), its bound (the larger of its bytes, each operand read once and each
output written once, over 3.35 TB/s and its products over the int8 peak,
1,979 TOP/s, or for the stem over the float32 FMA peak, 67 TFLOP/s), the
stem's ceiling with a separate multiply and add (half that rate), and the
launch facts (plan, registers, grid) and, for the embed, one CTA's phase
clock (``fused_patch_embed_forced(phase_ns=)``). One call per forward, so the kernel's
µs is its device time per forward. ``--plans`` also times the embed kernel
alone on every cluster size and consumer count that fits
(``fused_patch_embed_forced``). ``--root`` names the checkout whose
``p2vit_tpu_torch`` is imported (default: the one holding this file), so
one run on the card can measure an older commit beside this one.
``--paths`` then drives the serving paths the two kernels sit on, at full
width and depth with seeded weights calibrated on ``--calib`` seeded
images: DeiT-S (``convert([4]*50)``) at the default flags (``deit``: the
fused embed) and staged (``deit_staged``), Swin-T (``convert(4)``) at the
defaults (``swin``) and with ``fuse_stem`` (``swin_stem``); per path and
batch, the device ms per forward (profiler, 5 forwards), the ms per forward
on CUDA events, the idle share (1 − device/event ms) and the prologue
kernel's device ms per forward.

Needs the card; ``--device cpu`` runs the plain versions only (their
outputs' shapes and the bounds; no device time), for a check without one.
Prints one JSON line per shape.
"""

from __future__ import annotations

import argparse
import json
import re
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_S, INT8_OPS_S, F32_FLOPS_S = 3.35e12, 1979e12, 67e12
EMBED = {"deit_tiny": 192, "deit_small": 384, "deit_base": 768, "vit_large": 1024}  # C; 196 patches, K = 768
STEM = {"swin_tiny": 96, "swin_base": 128}  # C; 3136 patches an image, K = 48
EMBED_PATCHES, EMBED_K, STEM_PATCHES, STEM_K = 196, 768, 3136, 48
KERNEL_NAMES = re.compile(r"embed_kernel|swin_stem_kernel")


def _device_us(fn, reps, tries=3):
    """Device µs per call of everything ``fn`` launches and of the prologue
    kernel alone, from ``torch.profiler`` after one warm-up call."""
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


def _phases_us(embed_fused, a, reps=5):
    """One CTA's phase clock (µs from its start, mean of ``reps`` calls):
    each chunk's products and epilogue of its first row block, the row
    constants, the LN pass, the end of its last block."""
    names = embed_fused.EMBED_PHASES
    st = torch.zeros((reps, len(names)), dtype=torch.int64, device=a[0].device)
    for r in range(reps):
        embed_fused.fused_patch_embed_forced(*a, phase_ns=st[r])
    torch.cuda.synchronize()
    rel = ((st - st[:, :1]).double() / 1e3).mean(0).tolist()
    return {n: round(v, 2) for n, v in zip(names, rel) if v > 0}


def embed_args(rng, b, c, dev):
    """fused_patch_embed's arguments at batch b and width C."""
    def f(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def i8(shape, lo=-128, hi=128):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))

    a = [i8((b, EMBED_PATCHES, EMBED_K)), i8((c, EMBED_K), -8, 8), f(2.0 ** rng.randint(-10, -6, c)),
         f(rng.randn(c)), f(0.5), f(2.0**-4), f(rng.randn(EMBED_PATCHES, c) * 0.2), i8((1, c)),
         f(0.013 * 2.0 ** rng.randint(0, 3, c)), f(2.0 ** rng.randint(0, 3, c)), f(0.013), f(rng.randn(c) * 8),
         f(rng.randn(c) * 4)]
    return [t.to(dev) for t in a]


def stem_args(rng, b, c, dev):
    """fused_swin_stem's arguments at batch b and width C: fake-quantized
    patches (int8 codes times a power of two), dequantized weights."""
    m = b * STEM_PATCHES
    a = [torch.from_numpy((rng.randint(-128, 128, (m, STEM_K)) * 2.0**-5).astype(np.float32)),
         torch.from_numpy((rng.randint(-8, 8, (c, STEM_K)) * 2.0 ** rng.randint(-9, -6, (c, 1))).astype(np.float32)),
         torch.from_numpy((rng.randn(c) * 0.05).astype(np.float32)),
         torch.from_numpy((2.0**-3 * 2.0 ** rng.randint(0, 3, c)).astype(np.float32)),
         torch.from_numpy(rng.randn(c).astype(np.float32)), torch.from_numpy((rng.randn(c) * 0.1).astype(np.float32)),
         torch.tensor(2.0**-4)]
    return [t.to(dev) for t in a]


def bound_us(kernel, a, outs):
    """(µs, "bytes" or "operations", the stem's mul+add ceiling µs or None)."""
    nbytes = sum(t.numel() * t.element_size() for t in list(a) + list(outs) if isinstance(t, torch.Tensor))
    if kernel == "fused_patch_embed":
        (b, n_patch, k), c = a[0].shape, a[1].shape[0]
        ops, peak = 2 * b * n_patch * k * c, INT8_OPS_S
    else:
        (m, k), c = a[0].shape, a[1].shape[0]
        ops, peak = 2 * m * k * c, F32_FLOPS_S
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e6, ops / peak * 1e6
    ceiling = 2 * t_ops if kernel == "fused_swin_stem" else None
    return (t_bytes, "bytes", ceiling) if t_bytes >= t_ops else (t_ops, "operations", ceiling)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch is imported")
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plans", action="store_true",
                    help="also time the embed kernel on every cluster size and consumer count that fits")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions only, no device time")
    ap.add_argument("--models", default=",".join([*EMBED, *STEM]))
    ap.add_argument("--paths", action="store_true", help="also time the serving paths the kernels sit on")
    ap.add_argument("--calib", type=int, default=8, help="calibration images of --paths")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("prologue_bench: needs a CUDA device (or --device cpu for the plain versions)")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch.ops import embed_fused, swin_stem

    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = torch.cuda.get_device_name(0) if on_card else "none (cpu: plain versions)"
    rng = np.random.RandomState(0)
    lines = []
    for model in args.models.split(","):
        kernel = "fused_patch_embed" if model in EMBED else "fused_swin_stem"
        mod = embed_fused if model in EMBED else swin_stem
        c = EMBED.get(model) or STEM[model]
        kern, plain = getattr(mod, kernel), getattr(mod, kernel + "_plain")
        for b in (int(v) for v in args.batches.split(",")):
            a = (embed_args if model in EMBED else stem_args)(rng, b, c, dev)
            t0 = time.perf_counter()
            want = plain(*a)
            plain_s = time.perf_counter() - t0
            want = want if isinstance(want, tuple) else (want,)
            b_us, b_by, ceiling = bound_us(kernel, a, want)
            line = {"root": args.root, "kernel": kernel, "model": model, "batch": b, "c": c,
                    "shapes": [list(t.shape) for t in a if t.dim() >= 2], "bound_us": round(b_us, 3),
                    "bound_by": b_by, "card": card}
            if ceiling is not None:
                line["mul_add_ceiling_us"] = round(ceiling, 3)
            if not on_card:
                line["plain_s_on_cpu"] = round(plain_s, 4)  # a CPU wall time, no device metric
                lines.append(line)
                print(json.dumps(line), flush=True)
                continue
            got = kern(*a)
            got = got if isinstance(got, tuple) else (got,)
            bad = sum(int((g != w).sum()) for g, w in zip(got, want))
            us, kern_us = _device_us(lambda: kern(*a), args.reps)
            line.update(mismatches=bad, device_us=round(us, 3), kernel_us=round(kern_us, 3),
                        x_bound=round(kern_us / b_us, 3))
            if ceiling is not None:
                line["x_ceiling"] = round(kern_us / ceiling, 3)
            if model in EMBED and hasattr(embed_fused, "embed_kernel_info"):
                info = embed_fused.embed_kernel_info(b * EMBED_PATCHES, c)
                line["plan"] = {k: info[k] for k in ("bn", "cpc", "cs", "nc", "stages", "blocks", "grid", "registers",
                                                     "spill_bytes", "smem_bytes")}
                line["phases_us"] = _phases_us(embed_fused, a)
                if args.plans:
                    var = {}
                    for cs in range(1, embed_fused.MAX_CLUSTER + 1):
                        for nc in range(1, embed_fused.MAX_CONSUMERS + 1):
                            try:
                                embed_fused.embed_plan(b * EMBED_PATCHES, c, EMBED_K, info["sms"], info["resident"],
                                                       cs=cs, nc=nc)
                            except ValueError:
                                continue
                            fk = embed_fused.fused_patch_embed_forced
                            bad += sum(int((g != w).sum()) for g, w in zip(fk(*a, cs=cs, nc=nc), want))
                            var[f"cs{cs}_nc{nc}"] = round(_device_us(lambda: fk(*a, cs=cs, nc=nc), args.reps)[1], 3)
                    line["plans_kernel_us"] = var
                    line["mismatches"] = bad
            if model in STEM and hasattr(swin_stem, "stem_kernel_info"):
                info = swin_stem.stem_kernel_info(b * STEM_PATCHES, STEM_K, c)
                line["plan"] = {k: info[k] for k in ("cc", "blocks", "grid", "ctas_per_sm", "registers", "spill_bytes",
                                                     "smem_bytes")}
            lines.append(line)
            print(json.dumps(line), flush=True)
            if bad:
                raise SystemExit(f"prologue_bench: {kernel} disagrees with its plain version at {model}, batch {b}")
    if args.paths and on_card:
        lines += paths(args, card)
    return lines


def _path_ms(fn, reps):
    """(device ms per forward and the prologue kernel's, from the profiler
    over 5 forwards; ms per forward on CUDA events over ``reps``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with torch.no_grad():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        dev_ms = sum(e.self_device_time_total for e in ev) / 5 / 1e3
        kern_ms = sum(e.self_device_time_total for e in ev if KERNEL_NAMES.search(e.key)) / 5 / 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return dev_ms, kern_ms, start.elapsed_time(end) / reps


def paths(args, card) -> list:
    """The serving paths of --paths, through the root's package."""
    import dataclasses

    from p2vit_tpu_torch import serving, serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO, swin, vit

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    policy = make_policy()
    cfg_v = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"])
    pv = vit.init_params(0, cfg_v, device=dev)
    calib = vit.calibrate(pv, cfg_v, policy, torch.randn((args.calib, 3, 224, 224), generator=gen).to(dev))
    sv = serving.convert(pv, calib.qstate, cfg_v, policy, [4] * cfg_v.num_matmuls)
    cfg_s = SWIN_ZOO["swin_tiny_patch4_window7_224"]
    ps = swin.init_params(0, cfg_s, device=dev)
    calib_s = swin.calibrate(ps, cfg_s, policy, torch.randn((args.calib, 3, 224, 224), generator=gen).to(dev))
    ss = serving_swin.convert(ps, calib_s.qstate, cfg_s, policy, 4)
    runs = {"deit": lambda x: serving.serving_forward(sv, cfg_v, x),
            "deit_staged": lambda x: serving.serving_forward(sv, cfg_v, x, fuse_embed=False, fuse_qkv=False),
            "swin": lambda x: serving_swin.serving_forward(ss, calib_s.qstate, cfg_s, policy, x),
            "swin_stem": lambda x: serving_swin.serving_forward(ss, calib_s.qstate, cfg_s, policy, x,
                                                                fuse_stem=True)}
    out = []
    for name, fn in runs.items():
        for b in (int(v) for v in args.batches.split(",")):
            if name != "deit" and b != max(int(v) for v in args.batches.split(",")):
                continue
            x = torch.randn((b, 3, 224, 224), generator=gen).to(dev)
            dev_ms, kern_ms, ev_ms = _path_ms(lambda: fn(x), max(2, args.reps // 4))
            line = {"root": args.root, "path": name, "batch": b, "device_ms": round(dev_ms, 4),
                    "prologue_kernel_ms": round(kern_ms, 4), "event_ms": round(ev_ms, 4),
                    "idle_share": round(1 - dev_ms / ev_ms, 3), "card": card}
            out.append(line)
            print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()

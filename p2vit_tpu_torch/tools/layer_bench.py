"""The fused encoder layer and the two per-item ViT attention kernels at the
zoo's shapes.

    python p2vit_tpu_torch/tools/layer_bench.py [--root DIR] [--batches 1,8,64] [--reps 20] [--plans]
                                                [--paths] [--models deit_tiny,deit_small] [--device cuda|cpu]

``fused_vit_layer`` at DeiT-T and DeiT-S (N = 197; C = 192, 384; 3 and 6
heads; hid 4C), LIS on and off, on seeded operands of the serving path's
kinds (int8 codes, int4-valued weights, PoT requants, PTF residual scales),
at each batch: the kernel against its plain version (mismatches; must be 0),
its device µs per call (``torch.profiler``: every kernel the wrapper
launches, and the layer kernel alone), its bound (the larger of its bytes,
each operand read once and each output written once, over 3.35 TB/s, and
its int8 products over 1,979 TOP/s), block 0's phase clock
(``phase_ns``: the qkv GEMM, the attention, the row blocks) and the launch
facts (``layer_kernel_info``). Then ``lis_attention_fused`` on the layer's
qkv codes and ``lis_attention`` on them split by head: mismatches, kernel
µs, bound and launch facts (``vit_attention_info``). ``--plans`` also times
every forced plan (``fused_vit_layer_forced``: attention query groups a
chunk, phase C's rows a block; ``lis_attention_fused_forced``). ``--root`` names the checkout whose
``p2vit_tpu_torch`` is imported (default: the one holding this file), so one
run on the card can measure an older commit beside this one; what that
commit lacks is left out of its lines. ``--paths`` then drives DeiT-S at
full width and depth (``convert([4]*50)``, seeded weights calibrated on
``--calib`` seeded images): ``deit``, ``deit_staged`` and ``deit_layer``,
LIS on and off, per batch the device ms per forward (profiler, 5 forwards),
the event ms, the idle share and the device ms of the layer and attention
kernels.

Needs the card; ``--device cpu`` runs the plain versions only (their
outputs and the bounds; no device time), for a check without one. Prints
one JSON line per shape.
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

HBM_BYTES_S, INT8_OPS_S = 3.35e12, 1979e12
MODELS = {"deit_tiny": (192, 3), "deit_small": (384, 6)}  # (C, heads); N = 197, hid = 4C
N_TOKENS = 197
LAYER = re.compile(r"fused_vit_layer_kernel")
ATTN = re.compile(r"attention_rows_kernel")


def _device_us(fn, reps, pattern, tries=3):
    """Device µs per call of everything ``fn`` launches and of the kernels
    whose names match ``pattern``, from ``torch.profiler`` after a warm-up."""
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
            return t / reps, sum(e.self_device_time_total for e in ev if pattern.search(e.key)) / reps
    raise RuntimeError(f"the profiler saw no device time in {tries} windows of {reps} calls")


def layer_args(rng, b, c, heads, dev):
    """One layer's operands at width C (hid = 4C), as the card tests'."""
    n, hid = N_TOKENS, 4 * c

    def f(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def i8(shape, lo=-128, hi=128):
        return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))

    def pot(k, lo, hi):
        return torch.from_numpy((2.0 ** rng.randint(lo, hi, k)).astype(np.float32))

    def ptf(k, base):
        return torch.from_numpy((base * 2.0 ** rng.randint(0, 4, k)).astype(np.float32))

    args = [i8((b, n, c)), i8((b, n, c)), i8((3 * c, c), -8, 8), pot(3 * c, -8, -6), f(rng.randn(3 * c)), heads,
            2.0**-9, 2.0**-4, 4.0, i8((c, c), -8, 8), pot(c, -8, -6), f(rng.randn(c)), 2.0**-5, ptf(c, 0.011),
            ptf(c, 0.03), f(rng.randn(c)), f(rng.randn(c) * 0.1), f(np.abs(rng.randn(c)) * 0.03 + 0.01),
            pot(c, -1, 2), i8((hid, c), -8, 8), pot(hid, -10, -8), f(rng.randn(hid) * 0.5), 16.0,
            i8((c, hid), -8, 8), pot(c, -10, -8), f(rng.randn(c)), 2.0**-4, ptf(c, 0.04), f(rng.randn(c)),
            f(rng.randn(c) * 0.1), f(np.abs(rng.randn(c)) * 0.03 + 0.01), 1.0]
    return [a.to(dev) if isinstance(a, torch.Tensor) else a for a in args]


def bound_us(ops, tensors):
    """(µs, "bytes" or "operations"): each tensor read or written once over
    the HBM rate against ``ops`` int8 operations over the int8 peak."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor))
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e6, ops / INT8_OPS_S * 1e6
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _phases(layer_fused, a, lis, reps=5):
    """Block 0's three phases, µs a call (mean of ``reps``)."""
    stamps = torch.zeros((reps, 4), dtype=torch.int64, device=a[0].device)
    for r in range(reps):
        layer_fused.fused_vit_layer(*a, lis=lis, phase_ns=stamps[r])
    torch.cuda.synchronize()
    us = ((stamps[:, 1:] - stamps[:, :-1]).double().mean(0) / 1e3).tolist()
    return dict(zip(("qkv GEMM", "attention", "row blocks"), (round(u, 3) for u in us)))


def _diff(got, want):
    got, want = (got if isinstance(got, tuple) else (got,)), (want if isinstance(want, tuple) else (want,))
    return sum(int((g != w).sum()) for g, w in zip(got, want))


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="checkout whose p2vit_tpu_torch is imported")
    ap.add_argument("--batches", default="1,8,64")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--plans", action="store_true", help="also time every forced plan")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu: the plain versions only, no device time")
    ap.add_argument("--models", default=",".join(MODELS))
    ap.add_argument("--paths", action="store_true", help="also time the DeiT-S serving paths")
    ap.add_argument("--calib", type=int, default=8, help="calibration images of --paths")
    args = ap.parse_args(argv)
    on_card = args.device == "cuda"
    if on_card and not torch.cuda.is_available():
        raise SystemExit("layer_bench: needs a CUDA device (or --device cpu for the plain versions)")
    sys.path.insert(0, args.root)
    from p2vit_tpu_torch.ops import attention_lis, layer_fused

    dev = torch.device("cuda", 0) if on_card else torch.device("cpu")
    card = torch.cuda.get_device_name(0) if on_card else "none (cpu: plain versions)"
    rng = np.random.RandomState(0)
    lines = []
    for model in args.models.split(","):
        c, heads = MODELS[model]
        hid, n = 4 * c, N_TOKENS
        for b in (int(v) for v in args.batches.split(",")):
            a = layer_args(rng, b, c, heads, dev)
            for lis in (True, False):
                t0 = time.perf_counter()
                want = layer_fused.fused_vit_layer_plain(*a, lis=lis)
                plain_s = time.perf_counter() - t0
                ops = 2 * b * n * c * 4 * c + 4 * b * n * c * hid + 4 * b * n * n * c
                b_us, b_by = bound_us(ops, [t for t in a if isinstance(t, torch.Tensor)] + list(want))
                line = {"root": args.root, "kernel": "fused_vit_layer", "model": model, "batch": b, "lis": lis,
                        "bound_us": round(b_us, 3), "bound_by": b_by, "card": card}
                if not on_card:
                    line["plain_s_on_cpu"] = round(plain_s, 4)  # a CPU wall time, no device metric
                    lines.append(line)
                    print(json.dumps(line), flush=True)
                    continue
                bad = _diff(layer_fused.fused_vit_layer(*a, lis=lis), want)
                us, k_us = _device_us(lambda: layer_fused.fused_vit_layer(*a, lis=lis), args.reps, LAYER)
                line.update(mismatches=bad, device_us=round(us, 3), kernel_us=round(k_us, 3),
                            x_bound=round(k_us / b_us, 3), phases_us=_phases(layer_fused, a, lis))
                if hasattr(layer_fused, "layer_kernel_info"):
                    info = layer_fused.layer_kernel_info(b, n, c, heads, hid, lis)
                    line["launch"] = {k: info[k] for k in ("threads", "grid", "smem_bytes", "gc", "registers",
                                                           "spill_bytes", "ctas_per_sm")}
                    line["launch"].update(blocks=info["blocks"], blocks_64=info["blocks_64"])
                    if args.plans:
                        var = {}
                        for gc, br in ((1, 0), (4, 0), (7, 0), (13, 0), (0, 32), (0, 64)):
                            fk = layer_fused.fused_vit_layer_forced
                            bad += _diff(fk(*a, lis=lis, gc=gc, br=br), want)
                            var[f"gc{gc}_br{br}"] = round(
                                _device_us(lambda: fk(*a, lis=lis, gc=gc, br=br), args.reps, LAYER)[1], 3)
                        line["plans_kernel_us"] = var
                        line["mismatches"] = bad
                lines.append(line)
                print(json.dumps(line), flush=True)
                if bad:
                    raise SystemExit(f"layer_bench: fused_vit_layer disagrees with its plain version at {model}, "
                                     f"batch {b}")
                lines += _attention(args, attention_lis, layer_fused, a, b, c, heads, lis, card)
    if args.paths and on_card:
        lines += paths(args, card)
    return lines


def _attention(args, attention_lis, layer_fused, a, b, c, heads, lis, card) -> list:
    """``lis_attention_fused`` on the layer's qkv codes and ``lis_attention``
    on them split by head."""
    from p2vit_tpu_torch.ops import matmul_int8

    n, hd = N_TOKENS, c // heads
    qkv = matmul_int8.int8_matmul_requant(a[0].reshape(-1, c), a[2], a[3], a[4]).reshape(b, n, 3 * c)
    sc = tuple(a[6:9])
    q, k, v = (t.contiguous() for t in qkv.reshape(b, n, 3, heads, hd).permute(2, 0, 3, 1, 4).reshape(3, -1, n, hd))
    out = []
    for kernel, call, plain, forced, ins in (
            ("lis_attention_fused", lambda **kw: attention_lis.lis_attention_fused(qkv, heads, *sc, lis=lis),
             lambda: attention_lis.lis_attention_fused_plain(qkv, heads, *sc, lis=lis),
             getattr(attention_lis, "lis_attention_fused_forced", None), (qkv,)),
            ("lis_attention", lambda **kw: attention_lis.lis_attention(q, k, v, *sc, lis=lis),
             lambda: attention_lis.lis_attention_plain(q, k, v, *sc, lis=lis), None, (q, k, v))):
        want = plain()
        b_us, b_by = bound_us(4 * b * n * n * c, list(ins) + [want])
        bad = _diff(call(), want)
        us, k_us = _device_us(call, args.reps, ATTN)
        line = {"root": args.root, "kernel": kernel, "batch": b, "c": c, "heads": heads, "lis": lis,
                "mismatches": bad, "device_us": round(us, 3), "kernel_us": round(k_us, 3),
                "bound_us": round(b_us, 3), "bound_by": b_by, "card": card}
        if hasattr(attention_lis, "vit_attention_info"):
            line["launch"] = attention_lis.vit_attention_info(n, hd, lis)
            if args.plans and forced is not None:
                var = {}
                for gc in (1, 3, 5, 7, 13):
                    bad += _diff(forced(qkv, heads, *sc, lis=lis, gc=gc), want)
                    var[f"gc{gc}"] = round(_device_us(lambda: forced(qkv, heads, *sc, lis=lis, gc=gc), args.reps,
                                                      ATTN)[1], 3)
                line["plans_kernel_us"] = var
                line["mismatches"] = bad
        out.append(line)
        print(json.dumps(line), flush=True)
        if bad:
            raise SystemExit(f"layer_bench: {kernel} disagrees with its plain version at batch {b}")
    return out


def _path_ms(fn, reps):
    """(device ms per forward, of the layer and attention kernels, from the
    profiler over 5 forwards; ms per forward on CUDA events over ``reps``)."""
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
        layer_ms = sum(e.self_device_time_total for e in ev if LAYER.search(e.key)) / 5 / 1e3
        attn_ms = sum(e.self_device_time_total for e in ev if ATTN.search(e.key)) / 5 / 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
    return dev_ms, layer_ms, attn_ms, start.elapsed_time(end) / reps


def paths(args, card) -> list:
    """The DeiT-S serving paths of --paths, through the root's package."""
    from p2vit_tpu_torch import serving
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import VIT_ZOO, vit

    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(1)
    cfg = VIT_ZOO["deit_small_patch16_224"]
    params = vit.init_params(0, cfg, device=dev)
    x_cal = torch.randn((args.calib, 3, 224, 224), generator=gen).to(dev)
    states = {}
    for lis in (True, False):
        policy = make_policy(lis=lis)
        calib = vit.calibrate(params, cfg, policy, x_cal)
        states[lis] = serving.convert(params, calib.qstate, cfg, policy, [4] * cfg.num_matmuls)
    flags = {"deit": {}, "deit_staged": dict(fuse_embed=False, fuse_qkv=False), "deit_layer": dict(fuse_layer=True)}
    batches = [int(v) for v in args.batches.split(",")]
    out = []
    for lis in (True, False):
        for name, fl in flags.items():
            for b in batches:
                x = torch.randn((b, 3, 224, 224), generator=gen).to(dev)
                dev_ms, layer_ms, attn_ms, ev_ms = _path_ms(
                    lambda: serving.serving_forward(states[lis], cfg, x, lis=lis, **fl), max(2, args.reps // 4))
                line = {"root": args.root, "path": name + ("" if lis else "_lisoff"), "batch": b,
                        "device_ms": round(dev_ms, 4), "fused_vit_layer_ms": round(layer_ms, 4),
                        "lis_attention_fused_ms": round(attn_ms, 4), "event_ms": round(ev_ms, 4),
                        "idle_share": round(1 - dev_ms / ev_ms, 3), "card": card}
                out.append(line)
                print(json.dumps(line), flush=True)
    return out


if __name__ == "__main__":
    main()

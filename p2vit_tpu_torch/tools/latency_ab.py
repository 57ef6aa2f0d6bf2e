"""Small-batch serving latency A/B of the serving arms (counterpart of the
JAX package's ``tools/latency_ab.py``), the measurements behind
``p2vit_tpu_torch/plan.py``.

Arms, ViT/DeiT (``synthetic_qstate``, W8 ``[8]*num_matmuls``), each at every
``--batches`` size:

  bf16          the float forward in bfloat16 (PyTorch's GEMMs)
  int8          serving defaults (``fuse_qkv`` + ``fuse_embed``)
  int8_staged   ``fuse_qkv=False, fuse_embed=False`` (qkv GEMM, then the
                attention over the qkv codes)
  int8_fl       ``fuse_layer=True`` (one kernel an encoder layer)
  int8_loff     ``lis=False``
  int8_fl_loff  ``fuse_layer`` + LIS off
  wonly         weight-only serving: ``weight_only_params`` → the bf16
                forward with the quantized weights

Swin runs the reduced set (bf16 / int8 / int8_loff / wonly: Swin has no
``fuse_layer``), on a state calibrated on 8 seeded images. A ``fuse_layer``
arm the kernel does not fit (``layer_fused.check_fits``) is left out and
its reason printed.

Each arm is timed two ways: ms per forward from CUDA events around a window
of forwards (``profiling.device_time_ms``: best of 3 windows, after a
warm-up), which holds the host's launch gaps, and the device ms per forward
that ``torch.profiler`` sums over the kernels it saw. The "best" arm is the
least CUDA-event ms. ``fl_bitwise``: the ``fuse_layer`` logits equal the
default's bit for bit (the port's claim). Every int8 arm is also held, on
the timed batch, against its plain path (``use_kernels=False`` at the same
flags: ``<arm>_bad``, the logits that differ), and the kernel launches of
one forward are counted (``<arm>_launches`` against
``<arm>_launches_want``, ``launches_per_forward``; none on the CPU, where
the wrappers run their plain versions).

    python -m p2vit_tpu_torch.tools.latency_ab [deit_small deit_tiny swin_tiny ...]
        [--batches 1,8,32] [--iters N] [--device cuda]

Without a CUDA device it stops unless given ``--device cpu`` (the plain
versions, one forward a window, no device time: a smoke run). Prints one
line per model and batch, the card's name, then one JSON line of the
results.
"""

from __future__ import annotations

import argparse
import json

import torch

from .. import ops, profiling, serving, serving_swin
from ..cli import FULL_NAME, _to_bf16
from ..config import make_policy
from ..models import MODEL_ZOO, SWIN_ZOO, swin, vit
from ..ops import layer_fused

# timed forwards a window, by batch; others max(20, 6400 // batch)
ITERS = {1: 200, 8: 100, 32: 50}
VIT_ARMS = {
    "int8": {},
    "int8_staged": {"fuse_qkv": False, "fuse_embed": False},
    "int8_fl": {"fuse_layer": True},
    "int8_loff": {"lis": False},
    "int8_fl_loff": {"fuse_layer": True, "lis": False},
}
SWIN_ARMS = {"int8": {"lis": True}, "int8_loff": {"lis": False}}


def arm_of(plan) -> str:
    """The arm a ``plan.ServingPlan`` names: ``wonly`` for the bf16 path
    (the planner serves the quantized weights at bf16 speed there), else
    the int8 arm of its flags and LIS switch."""
    if plan.path != "int8":
        return "wonly"
    base = "int8_fl" if plan.fuse_layer else "int8" if plan.fuse_qkv else "int8_staged"
    return base if plan.lis else base + "_loff"


def profiler_device_ms(fn, reps: int = 3):
    """Device ms per call of ``fn()`` summed over the CUDA kernels that
    ``torch.profiler`` records in ``reps`` calls, after one warm-up; None
    where it records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
    return total / reps / 1e3 if total > 0 else None


def _time(fn, x, iters, cuda, reps):
    ms = profiling.device_time_ms(lambda xx: fn(xx), x, iters=iters)
    return ms, (profiler_device_ms(lambda: fn(x), reps) if cuda else None)


def _images(b, cfg, device):
    gen = torch.Generator().manual_seed(1)
    return torch.randn((b, 3, cfg.img_size, cfg.img_size), generator=gen).to(device)


def model_arms(name, device):
    """{arm: forward(x)} for one zoo model at full width, seeded weights;
    {int8 arm: (its plain path's forward(x), its launches a forward)}; and
    the arms left out with their reasons."""
    cfg = MODEL_ZOO[name]
    policy = make_policy()
    if name in SWIN_ZOO:
        params = swin.init_params(0, cfg, device=device)
        calib = swin.calibrate(params, cfg, policy, _images(8, cfg, device))
        qstate = calib.qstate
        s = serving_swin.convert(params, qstate, cfg, policy, 8)
        pb, pw = _to_bf16(params), _to_bf16(serving_swin.weight_only_params(params, qstate, cfg, policy, 8))
        arms = {"bf16": lambda x: swin.fp_forward(pb, cfg, x.to(torch.bfloat16))}
        refs = {}
        for arm, kw in SWIN_ARMS.items():
            arms[arm] = lambda x, kw=kw: serving_swin.serving_forward(s, qstate, cfg, policy, x, **kw)
            refs[arm] = (lambda x, kw=kw: serving_swin.serving_forward(s, qstate, cfg, policy, x, use_kernels=False,
                                                                       **kw), serving_swin.launches_per_forward(cfg))
        arms["wonly"] = lambda x: swin.fp_forward(pw, cfg, x.to(torch.bfloat16))
        return cfg, arms, refs, {}
    params = vit.init_params(0, cfg, device=device)
    qstate = vit.synthetic_qstate(cfg, device=device)
    bits = [8] * cfg.num_matmuls
    s = serving.convert(params, qstate, cfg, policy, bits)
    pb, pw = _to_bf16(params), _to_bf16(serving.weight_only_params(params, qstate, cfg, policy, bits))
    arms = {"bf16": lambda x: vit.fp_forward(pb, cfg, x.to(torch.bfloat16))}
    refs, left_out = {}, {}
    for arm, kw in VIT_ARMS.items():
        if kw.get("fuse_layer"):
            try:
                layer_fused.check_fits(cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.hidden_dim)
            except ValueError as e:
                left_out[arm] = str(e)
                continue
        arms[arm] = lambda x, kw=kw: serving.serving_forward(s, cfg, x, **kw)
        flags = {k: v for k, v in kw.items() if k != "lis"}
        refs[arm] = (lambda x, kw=kw: serving.serving_forward(s, cfg, x, use_kernels=False, **kw),
                     serving.launches_per_forward(cfg, **flags))
    arms["wonly"] = lambda x: vit.fp_forward(pw, cfg, x.to(torch.bfloat16))
    return cfg, arms, refs, left_out


def check_arm(fn, ref, x, cuda) -> dict:
    """One forward of an int8 arm against its plain path on ``x`` and its
    kernel launches (none on the CPU)."""
    plain, want = ref
    ops.reset_launch_counts()
    got = fn(x)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    return {"bad": int((got != plain(x)).sum()), "launches": counts, "launches_want": want if cuda else {}}


def run(names, batches, device, iters=None, reps=3) -> dict:
    """The A/B over ``names`` × ``batches``: {"<model>@b<batch>": {"<arm>_ms",
    "<arm>_dev_ms", "best", "fl_bitwise", and each int8 arm's "<arm>_bad",
    "<arm>_launches" and "<arm>_launches_want"}}, printing one line each."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    res = {}
    for name in names:
        cfg, arms, refs, left_out = model_arms(name, dev)
        for arm, why in left_out.items():
            print(f"  {name}: arm {arm} left out: {why}", flush=True)
        for batch in batches:
            x = _images(batch, cfg, dev)
            n = (iters or ITERS.get(batch, max(20, 6400 // batch))) if cuda else 1
            row = {}
            for arm, fn in arms.items():
                row[f"{arm}_ms"], row[f"{arm}_dev_ms"] = _time(fn, x, n, cuda, reps)
            if "int8_fl" in arms:
                row["fl_bitwise"] = bool(torch.equal(arms["int8"](x), arms["int8_fl"](x)))
            row["best"] = min(arms, key=lambda a: row[f"{a}_ms"])
            for arm, ref in refs.items():
                row.update({f"{arm}_{k}": v for k, v in check_arm(arms[arm], ref, x, cuda).items()})
            res[f"{name}@b{batch}"] = row
            dev_part = (" | device " + " ".join(f"{a} {row[a + '_dev_ms']:.4f}" for a in arms)
                        if cuda and all(row[a + "_dev_ms"] is not None for a in arms) else "")
            print(f"  {name} b={batch:3}: " + " | ".join(f"{a} {row[a + '_ms']:8.4f}" for a in arms)
                  + f" ms{dev_part}  best={row['best']}"
                  + (f" fl_bitwise={row['fl_bitwise']}" if "fl_bitwise" in row else "")
                  + " | differing from plain " + " ".join(f"{a} {row[a + '_bad']}" for a in refs)
                  + " | launches as expected " + " ".join(
                      f"{a} {row[a + '_launches'] == row[a + '_launches_want']}" for a in refs), flush=True)
    return res


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description="latency_ab: the serving arms' ms per forward by batch")
    ap.add_argument("models", nargs="*", default=["deit_small"], help="zoo names or their short CLI names")
    ap.add_argument("--batches", default=None, help="batch sizes (default 1,8,32; 1 on the CPU)")
    ap.add_argument("--iters", type=int, default=None, help="timed forwards a window (default by batch)")
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu for the plain versions")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("latency_ab: no CUDA device; pass --device cpu to run the plain versions on the CPU")
    cuda = torch.device(args.device).type == "cuda"
    batches = [int(b) for b in args.batches.split(",")] if args.batches else ([1, 8, 32] if cuda else [1])
    names = [FULL_NAME.get(n, n) for n in args.models]
    card = torch.cuda.get_device_name(torch.device(args.device)) if cuda else "cpu"
    print(f"== latency_ab device={card} batches={batches}", flush=True)
    res = run(names, batches, args.device, args.iters)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

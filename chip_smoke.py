"""Drive the PyTorch/CUDA port's int8 serving paths once on one GPU.

    python3 chip_smoke.py            # DeiT-S then Swin-T, batches 1, 8, 64

Builds the seven CUDA kernels from ``p2vit_tpu_torch/csrc`` (one nvcc per
source, in parallel, sm_90a), then drives two models at full width and
depth with seeded random weights and images:

* DeiT-S (``deit_small_patch16_224``: C=384, 6 heads, 197 tokens): seeded
  init → calibrate (one batch) → convert(W4A8, [4]*50) → serving_forward;
* Swin-T (``swin_tiny_patch4_window7_224``: C=96, depths (2,2,6,2), heads
  (3,6,12,24), 7×7 windows): seeded init → calibrate (one batch) →
  convert(4) → serving_forward.

Phases, one line each, per model:

  1. each kernel of the path against its plain PyTorch version, on the card,
     on the arguments the path gives it (captured from a plain forward at
     batch 8 and 64): mismatch counts; must be 0.
  2. the path: launch counts reset, serving_forward through the kernels on
     every request batch, counts read. Its logits must equal the plain
     path's (``use_kernels=False``) bit for bit.
  3. the launch counts of that run: the model's per-forward counts
     (DeiT-S 1 embed, depth attention, 2·depth res-LN, depth+1 requant;
     Swin-T 8 int-LN, 12 attention, 12 res-LN junctions, 9 matmul res-LN,
     43 requant) and 0 for the other model's kernels.
  4. logits finite, of shape (B, 1000); relative error, share of equal
     logits and argmax agreement against the fake-quant simulation, and the
     number of distinct predicted classes (reported, not checked).
  5. timing with CUDA events after warm-up: img/s at the largest batch for
     serving with kernels, the plain path, and a bf16 ``fp_forward``; each
     kernel against its plain version at that batch's shapes.

Then the card's name and power limit, one JSON line of per-kernel results
(``launches`` summed over both paths' phase-2 runs, ``ms``/``plain_ms`` per
forward at the largest batch summed over the models that run the kernel,
``per_model`` the breakdown), and last ``{"ok": true, "device": {...}}``.
Any failure raises (exit 1, no result line). There is no CPU path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch

# kernel → (plain version's module, its name, CUDA source, the TPU kernel it replaces)
SOURCES = {
    "fused_patch_embed": ("embed_fused", "fused_patch_embed_plain", "embed_fused.cu",
                          "p2vit_tpu/ops/embed_fused.py:92"),
    "lis_attention_qkv_fused": ("attention_lis", "lis_attention_qkv_fused_plain", "attention_lis.cu",
                                "p2vit_tpu/ops/attention_lis.py:387"),
    "int8_matmul_res_ln": ("matmul_ln", "int8_matmul_res_ln_plain", "matmul_ln.cu",
                           "p2vit_tpu/ops/matmul_ln.py:90"),
    "int8_matmul_requant": ("matmul_int8", "int8_matmul_requant_plain", "matmul_int8.cu",
                            "p2vit_tpu/ops/matmul_int8.py:117"),
    "int_ln_requant": ("intln", "int_ln_requant_plain", "intln.cu", "p2vit_tpu/ops/intln.py:98"),
    "int_res_ln_requant": ("intln", "int_res_ln_requant_plain", "intln.cu",
                           "p2vit_tpu/ops/intln.py:187"),
    "swin_lis_attention": ("attention_lis", "swin_lis_attention_plain", "swin_attention.cu",
                           "p2vit_tpu/ops/attention_lis.py:596"),
}


def _fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def _time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _capture(modules, names, run):
    """Run ``run()`` with each ``module.name`` plain function wrapped to record
    its calls' arguments; returns {name: [(args, kwargs), ...]}."""
    calls = {n: [] for n in names}
    saved = []
    for mod, n in zip(modules, names):
        fn = getattr(mod, n)
        saved.append((mod, n, fn))

        def rec(*a, _fn=fn, _n=n, **k):
            calls[_n].append((a, k))
            return _fn(*a, **k)

        setattr(mod, n, rec)
    try:
        run()
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
    return calls


def _cast_tree(tree, dtype):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def _shape_key(a, k):
    return tuple(t.shape if isinstance(t, torch.Tensor) else t is None for t in a) + (bool(k.get("gelu")),)


@dataclasses.dataclass
class Path:
    """One model's serving path as chip_smoke drives it."""

    name: str
    kernels: tuple  # kernel names the path runs
    per_forward: dict  # expected launches per forward
    forward: object  # (x, use_kernels) -> logits
    simulate: object  # x -> fake-quant logits
    bf16: object  # x -> bf16 fp logits
    num_classes: int
    img_size: int


def run_path(path: Path, batches, reps, img, ops, counts_api):
    """Phases 1–5 of one path; returns {kernel: launches, max error, ms and plain ms}."""
    reset_launch_counts, launch_counts = counts_api
    requests = {b: img(b, path.img_size) for b in batches}
    bt = max(batches)
    plain = {n: (getattr(ops, SOURCES[n][0]), SOURCES[n][1], getattr(ops, n)) for n in path.kernels}
    mods = [v[0] for v in plain.values()]
    pnames = [v[1] for v in plain.values()]

    # ---- phase 1: each kernel vs its plain version on the path's arguments --
    worst = {k: 0 for k in plain}
    mismatches = {k: 0 for k in plain}
    timing_calls = {}
    for b in sorted({8, bt}):
        x = requests[b] if b in requests else img(b, path.img_size)
        calls = _capture(mods, pnames, lambda: path.forward(x, False))
        for name, (mod, pname, kern) in plain.items():
            seen = {}
            for a, k in calls[pname]:
                seen.setdefault(_shape_key(a, k), (a, k))
            for key, (a, k) in seen.items():
                got = _as_tuple(kern(*a, **k))
                want = _as_tuple(getattr(mod, pname)(*a, **k))
                for g_, w_ in zip(got, want):
                    diff = (g_.to(torch.int32) - w_.to(torch.int32)).abs()
                    mismatches[name] += int((diff != 0).sum())
                    worst[name] = max(worst[name], int(diff.max()))
                if b == bt:
                    count = sum(1 for a2, k2 in calls[pname] if _shape_key(a2, k2) == key)
                    timing_calls.setdefault(name, []).append((a, k, count))
    torch.cuda.synchronize()
    print(f"{path.name} phase 1 kernels vs plain (batch 8 and {bt}, path arguments): "
          f"mismatches {json.dumps(mismatches)}", flush=True)
    if any(mismatches.values()):
        _fail(f"{path.name}: kernel disagrees with its plain version: {mismatches}")

    # ---- phase 2: the path through the kernels ----------------------------
    reset_launch_counts()
    logits = {b: path.forward(x, True) for b, x in requests.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    ref = {b: path.forward(x, False) for b, x in requests.items()}
    neq = {b: int((logits[b] != ref[b]).sum()) for b in batches}
    print(f"{path.name} phase 2 batches {batches}: logits != plain path: {json.dumps(neq)}", flush=True)
    if any(neq.values()):
        _fail(f"{path.name}: serving logits differ from the plain path: {neq}")

    # ---- phase 3: every kernel of the path ran, as often as it should ------
    nb = len(batches)
    want = {k: nb * path.per_forward.get(k, 0) for k in counts}
    print(f"{path.name} phase 3 launches over {nb} forwards: {json.dumps(counts)} "
          f"(per forward expected {json.dumps(path.per_forward)})", flush=True)
    if counts != want:
        _fail(f"{path.name}: launch counts {counts} != {want}")

    # ---- phase 4: output sanity and the simulation envelope ---------------
    for b, lg in logits.items():
        if tuple(lg.shape) != (b, path.num_classes) or not bool(torch.isfinite(lg).all()):
            _fail(f"{path.name} batch {b}: logits shape {tuple(lg.shape)} or non-finite values")
        sim = path.simulate(requests[b])
        rel = float((lg - sim).norm() / sim.norm().clamp_min(1e-9))
        same = float((lg == sim).float().mean())
        agree = float((lg.argmax(1) == sim.argmax(1)).float().mean())
        print(f"{path.name} phase 4 batch {b}: logits finite {tuple(lg.shape)}, |logits| mean "
              f"{float(lg.abs().mean()):.6g}, {len(set(lg.argmax(1).tolist()))} distinct classes; "
              f"vs quant_forward rel {rel:.6g}, equal {same:.4f}, argmax agreement {agree:.4f}")

    # ---- phase 5: timing ----------------------------------------------------
    x = requests[bt]
    for label, fn in (
        ("int8 kernels", lambda: path.forward(x, True)),
        ("int8 plain", lambda: path.forward(x, False)),
        ("bf16 fp_forward", lambda: path.bf16(x)),
        ("int8 kernels again", lambda: path.forward(x, True)),
    ):
        with torch.no_grad():
            ms = _time_ms(fn, max(2, reps // 4))
        print(f"{path.name} phase 5 batch {bt} {label}: {ms:.4f} ms/forward, {bt / ms * 1e3:.1f} img/s",
              flush=True)
    results = {}
    for name, (mod, pname, kern) in plain.items():
        k_ms = p_ms = 0.0
        for a, k, count in timing_calls[name]:
            t_k = _time_ms(lambda: kern(*a, **k), reps)
            t_p = _time_ms(lambda: getattr(mod, pname)(*a, **k), reps)
            shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor) and t.dim() >= 2]
            print(f"{path.name} phase 5 kernel {name} {shapes}{' gelu' if k.get('gelu') else ''}: "
                  f"{t_k:.4f} ms vs plain {t_p:.4f} ms per call, x{count} per forward")
            k_ms += t_k * count
            p_ms += t_p * count
        results[name] = {"launches": counts[name], "max_abs_err": worst[name],
                         "ms": k_ms, "plain_ms": p_ms}
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default="deit,swin", help="paths to drive: deit, swin or both")
    ap.add_argument("--depth", type=int, default=12, help="DeiT-S encoder depth (12 in the model)")
    ap.add_argument("--batches", default="1,8,64", help="request batch sizes")
    ap.add_argument("--calib", type=int, default=32, help="calibration images")
    ap.add_argument("--reps", type=int, default=20, help="timed repetitions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    batches = [int(b) for b in args.batches.split(",")]
    models = args.models.split(",")

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; this script needs one CUDA GPU")
    from p2vit_tpu_torch import ops, serving, serving_swin
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO, swin, vit
    from p2vit_tpu_torch.ops import KERNELS, _lib, launch_counts, reset_launch_counts

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {smi}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")

    t0 = time.time()
    _, log = _lib.library()
    regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    print(f"build: {time.time() - t0:.1f} s ({len(regs)} ptxas lines)")
    for ln in regs:
        print(f"  ptxas {ln}")

    policy = make_policy()
    gen = torch.Generator().manual_seed(args.seed + 1)
    img = lambda b, size: torch.randn((b, 3, size, size), generator=gen).to(dev)  # noqa: E731
    paths = []
    if "deit" in models:
        cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], depth=args.depth)
        t0 = time.time()
        params = vit.init_params(args.seed, cfg, device=dev)
        calib = vit.calibrate(params, cfg, policy, img(args.calib, cfg.img_size))
        bits = [4] * cfg.num_matmuls
        s = serving.convert(params, calib.qstate, cfg, policy, bits)
        idx = vit.bits_to_idx(bits)
        pbf = _cast_tree(params, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"DeiT-S setup: calibrate({args.calib} images) + convert(W4A8) {time.time() - t0:.1f} s")
        paths.append(Path(
            "DeiT-S", ("fused_patch_embed", "lis_attention_qkv_fused", "int8_matmul_res_ln",
                       "int8_matmul_requant"),
            {"fused_patch_embed": 1, "lis_attention_qkv_fused": cfg.depth,
             "int8_matmul_res_ln": 2 * cfg.depth, "int8_matmul_requant": cfg.depth + 1},
            lambda x, k, s=s, cfg=cfg: serving.serving_forward(s, cfg, x, use_kernels=k),
            lambda x, p=params, q=calib.qstate, cfg=cfg, idx=idx: vit.quant_forward(p, q, cfg, policy, x, idx),
            lambda x, p=pbf, cfg=cfg: vit.fp_forward(p, cfg, x.to(torch.bfloat16)),
            cfg.num_classes, cfg.img_size))
    if "swin" in models:
        cfg = SWIN_ZOO["swin_tiny_patch4_window7_224"]
        t0 = time.time()
        params = swin.init_params(args.seed, cfg, device=dev)
        calib = swin.calibrate(params, cfg, policy, img(args.calib, cfg.img_size))
        s = serving_swin.convert(params, calib.qstate, cfg, policy, 4)
        pbf = _cast_tree(params, torch.bfloat16)
        torch.cuda.synchronize()
        print(f"Swin-T setup: calibrate({args.calib} images) + convert(4) {time.time() - t0:.1f} s")
        paths.append(Path(
            "Swin-T", ("int_ln_requant", "swin_lis_attention", "int_res_ln_requant",
                       "int8_matmul_res_ln", "int8_matmul_requant"),
            serving_swin.launches_per_forward(cfg),
            lambda x, k, s=s, q=calib.qstate, cfg=cfg: serving_swin.serving_forward(
                s, q, cfg, policy, x, use_kernels=k),
            lambda x, p=params, q=calib.qstate, cfg=cfg: swin.quant_forward(p, q, cfg, policy, x, 4),
            lambda x, p=pbf, cfg=cfg: swin.fp_forward(p, cfg, x.to(torch.bfloat16)),
            cfg.num_classes, cfg.img_size))
    if not paths:
        _fail(f"no path selected by --models {args.models}")

    per_model = {}
    for path in paths:
        per_model[path.name] = run_path(path, batches, args.reps, img, ops,
                                        (reset_launch_counts, launch_counts))

    results = []
    for k in KERNELS:
        name = k.__name__
        runs = {m: r[name] for m, r in per_model.items() if name in r}
        if not runs and len(paths) == 2:
            _fail(f"kernel {name} ran on no path")
        if not runs:
            continue
        _, _, src, rep = SOURCES[name]
        results.append({
            "name": name, "route": "cuda", "source": f"p2vit_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": sum(r["launches"] for r in runs.values()),
            "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
            "ms": round(sum(r["ms"] for r in runs.values()), 6),
            "plain_ms": round(sum(r["plain_ms"] for r in runs.values()), 6),
            "per_model": {m: {kk: (round(v, 6) if isinstance(v, float) else v) for kk, v in r.items()}
                          for m, r in runs.items()},
        })
    print(f"(kernel ms / plain_ms: per forward at batch {max(batches)}, summed over the models "
          f"that run the kernel; card {smi})")
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

"""Drive the PyTorch/CUDA port's int8 serving path once on one GPU.

    python3 chip_smoke.py            # DeiT-S, depth 12, batches 1, 8, 64

Builds the four CUDA kernels from ``p2vit_tpu_torch/csrc`` (nvcc, sm_90a),
then on DeiT-S (``deit_small_patch16_224``: C=384, 6 heads, 197 tokens,
1000 classes) with seeded random weights and images:
seeded init → calibrate (one batch) → convert(W4A8, [4]*50) →
serving_forward on the request batches. Phases, one line each:

  1. each kernel against its plain PyTorch version, on the card, on the
     arguments the main path gives it (captured from a plain forward at
     batch 8 and 64): mismatch counts; must be 0.
  2. the main path: launch counts reset, serving_forward through the kernels
     on every request batch, counts read. Its logits must equal the plain
     path's (``use_kernels=False``) bit for bit.
  3. the launch counts of that run: per forward exactly 1 embed, ``depth``
     attention, 2·depth res-LN and depth+1 requant launches.
  4. logits finite, of shape (B, 1000); relative error, share of equal
     logits and argmax agreement against the fake-quant simulation
     ``quant_forward``, and the number of distinct predicted classes
     (reported, not checked).
  5. timing with CUDA events after warm-up: img/s at the largest batch for
     serving with kernels, the plain path, and a bf16 ``fp_forward``; each
     kernel against its plain version at that batch's shapes.

Then the card's name and power limit, one JSON line of per-kernel results,
and last ``{"ok": true, "device": {...}}``. Any failure raises (exit 1,
no result line). There is no CPU path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import torch


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
    if isinstance(tree, dict):
        return {k: _cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast_tree(v, dtype) for v in tree]
    return tree.to(dtype)


def _as_tuple(x):
    return x if isinstance(x, tuple) else (x,)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--depth", type=int, default=12, help="encoder depth (DeiT-S has 12)")
    ap.add_argument("--batches", default="1,8,64", help="request batch sizes")
    ap.add_argument("--calib", type=int, default=32, help="calibration images")
    ap.add_argument("--reps", type=int, default=20, help="timed repetitions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    batches = [int(b) for b in args.batches.split(",")]

    if not torch.cuda.is_available():
        _fail("torch.cuda.is_available() is false; this script needs one CUDA GPU")
    from p2vit_tpu_torch import serving
    from p2vit_tpu_torch.config import make_policy
    from p2vit_tpu_torch.models import VIT_ZOO, vit
    from p2vit_tpu_torch.ops import (
        KERNELS, _lib, attention_lis, embed_fused, launch_counts, matmul_int8, matmul_ln,
        reset_launch_counts,
    )

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

    # ---- main-path state -------------------------------------------------
    cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], depth=args.depth)
    policy = make_policy()
    gen = torch.Generator().manual_seed(args.seed + 1)
    img = lambda b: torch.randn((b, 3, cfg.img_size, cfg.img_size), generator=gen).to(dev)  # noqa: E731
    t0 = time.time()
    params = vit.init_params(args.seed, cfg, device=dev)
    calib = vit.calibrate(params, cfg, policy, img(args.calib))
    bits = [4] * cfg.num_matmuls
    s = serving.convert(params, calib.qstate, cfg, policy, bits)
    torch.cuda.synchronize()
    print(f"setup: calibrate({args.calib} images) + convert(W4A8) {time.time() - t0:.1f} s")
    requests = {b: img(b) for b in batches}

    # ---- phase 1: each kernel vs its plain version on main-path arguments --
    plain = {
        "fused_patch_embed": (embed_fused, "fused_patch_embed_plain", embed_fused.fused_patch_embed),
        "lis_attention_qkv_fused": (attention_lis, "lis_attention_qkv_fused_plain",
                                    attention_lis.lis_attention_qkv_fused),
        "int8_matmul_res_ln": (matmul_ln, "int8_matmul_res_ln_plain", matmul_ln.int8_matmul_res_ln),
        "int8_matmul_requant": (matmul_int8, "int8_matmul_requant_plain",
                                matmul_int8.int8_matmul_requant),
    }
    mods = [v[0] for v in plain.values()]
    pnames = [v[1] for v in plain.values()]
    worst = {k: 0 for k in plain}
    mismatches = {k: 0 for k in plain}
    timing_calls = {}
    for b in sorted({8, max(batches)}):
        calls = _capture(mods, pnames,
                         lambda: serving.serving_forward(s, cfg, requests[b] if b in requests else img(b),
                                                        use_kernels=False))
        for name, (mod, pname, kern) in plain.items():
            # one call per distinct shape (first block's; the head and fc1 are
            # both int8_matmul_requant, the proj and fc2 junctions both res-LN)
            seen = {}
            for a, k in calls[pname]:
                key = tuple(t.shape for t in a if isinstance(t, torch.Tensor)) + (bool(k.get("gelu")),)
                seen.setdefault(key, (a, k))
            for key, (a, k) in seen.items():
                got = _as_tuple(kern(*a, **k))
                want = _as_tuple(getattr(mod, pname)(*a, **k))
                for g_, w_ in zip(got, want):
                    diff = (g_.to(torch.int32) - w_.to(torch.int32)).abs()
                    mismatches[name] += int((diff != 0).sum())
                    worst[name] = max(worst[name], int(diff.max()))
                if b == max(batches):
                    count = sum(1 for a2, k2 in calls[pname]
                                if tuple(t.shape for t in a2 if isinstance(t, torch.Tensor))
                                + (bool(k2.get("gelu")),) == key)
                    timing_calls.setdefault(name, []).append((a, k, count))
    torch.cuda.synchronize()
    print("phase 1 kernels vs plain (batch 8 and %d, main-path arguments): mismatches %s"
          % (max(batches), json.dumps(mismatches)))
    if any(mismatches.values()):
        _fail(f"kernel disagrees with its plain version: {mismatches}")

    # ---- phase 2: the main path through the kernels ----------------------
    reset_launch_counts()
    logits = {b: serving.serving_forward(s, cfg, x) for b, x in requests.items()}
    torch.cuda.synchronize()
    counts = launch_counts()
    ref = {b: serving.serving_forward(s, cfg, x, use_kernels=False) for b, x in requests.items()}
    neq = {b: int((logits[b] != ref[b]).sum()) for b in batches}
    print(f"phase 2 main path batches {batches}: logits != plain path: {json.dumps(neq)}")
    if any(neq.values()):
        _fail(f"serving logits differ from the plain path: {neq}")

    # ---- phase 3: every kernel of the path ran, as often as it should ----
    nb = len(batches)
    per_fwd = {"fused_patch_embed": 1, "lis_attention_qkv_fused": cfg.depth,
               "int8_matmul_res_ln": 2 * cfg.depth, "int8_matmul_requant": cfg.depth + 1}
    want = {k: nb * v for k, v in per_fwd.items()}
    print(f"phase 3 launches over {nb} forwards: {json.dumps(counts)} "
          f"(per forward expected {json.dumps(per_fwd)})")
    if counts != want:
        _fail(f"launch counts {counts} != {want}")

    # ---- phase 4: output sanity and the simulation envelope --------------
    idx = vit.bits_to_idx(bits)
    for b, lg in logits.items():
        if tuple(lg.shape) != (b, cfg.num_classes) or not bool(torch.isfinite(lg).all()):
            _fail(f"batch {b}: logits shape {tuple(lg.shape)} or non-finite values")
        sim = vit.quant_forward(params, calib.qstate, cfg, policy, requests[b], idx)
        rel = float((lg - sim).norm() / sim.norm().clamp_min(1e-9))
        same = float((lg == sim).float().mean())
        agree = float((lg.argmax(1) == sim.argmax(1)).float().mean())
        print(f"phase 4 batch {b}: logits finite {tuple(lg.shape)}, |logits| mean "
              f"{float(lg.abs().mean()):.6g}, {len(set(lg.argmax(1).tolist()))} distinct classes; "
              f"vs quant_forward rel {rel:.6g}, equal {same:.4f}, argmax agreement {agree:.4f}")

    # ---- phase 5: timing ---------------------------------------------------
    bt = max(batches)
    x = requests[bt]
    pbf = _cast_tree(params, torch.bfloat16)
    rates = {}
    for label, fn in (
        ("int8 kernels", lambda: serving.serving_forward(s, cfg, x)),
        ("int8 plain", lambda: serving.serving_forward(s, cfg, x, use_kernels=False)),
        ("bf16 fp_forward", lambda: vit.fp_forward(pbf, cfg, x.to(torch.bfloat16))),
        ("int8 kernels again", lambda: serving.serving_forward(s, cfg, x)),
    ):
        with torch.no_grad():
            ms = _time_ms(fn, max(2, args.reps // 4))
        rates[label] = (ms, bt / ms * 1e3)
        print(f"phase 5 batch {bt} {label}: {ms:.4f} ms/forward, {bt / ms * 1e3:.1f} img/s")
    sources = {
        "fused_patch_embed": ("embed_fused.cu", "p2vit_tpu/ops/embed_fused.py:92"),
        "lis_attention_qkv_fused": ("attention_lis.cu", "p2vit_tpu/ops/attention_lis.py:387"),
        "int8_matmul_res_ln": ("matmul_ln.cu", "p2vit_tpu/ops/matmul_ln.py:90"),
        "int8_matmul_requant": ("matmul_int8.cu", "p2vit_tpu/ops/matmul_int8.py:117"),
    }
    results = []
    for name, (mod, pname, kern) in plain.items():
        k_ms = p_ms = 0.0
        for a, k, count in timing_calls[name]:
            t_k = _time_ms(lambda: kern(*a, **k), args.reps)
            t_p = _time_ms(lambda: getattr(mod, pname)(*a, **k), args.reps)
            shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor) and t.dim() >= 2]
            print(f"phase 5 kernel {name} {shapes}{' gelu' if k.get('gelu') else ''}: "
                  f"{t_k:.4f} ms vs plain {t_p:.4f} ms per call, x{count} per forward")
            k_ms += t_k * count
            p_ms += t_p * count
        src, rep = sources[name]
        results.append({"name": name, "route": "cuda", "source": f"p2vit_tpu_torch/csrc/{src}",
                        "replaces": rep, "launches": counts[name], "max_abs_err": worst[name],
                        "ms": round(k_ms, 6), "plain_ms": round(p_ms, 6)})
    if len(results) != len(KERNELS):
        _fail("a kernel of the path has no result")
    print(f"(kernel ms / plain_ms: summed per forward at batch {bt}; card {smi})")
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

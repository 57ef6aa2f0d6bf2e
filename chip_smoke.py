"""Drive the PyTorch/CUDA port's int8 serving paths once on one GPU.

    python3 chip_smoke.py            # twelve paths, batches 1, 8, 64

Builds the twelve CUDA kernels from ``p2vit_tpu_torch/csrc`` (one nvcc per
source, in parallel, sm_90a), then drives twelve serving paths of two models
at full width and depth, with seeded random weights and images:

* DeiT-S (``deit_small_patch16_224``: C=384, 6 heads, 197 tokens): seeded
  init → calibrate (one batch) → convert(W4A8, [4]*50) → serving_forward,
  at the default flags (``deit``), staged (``deit_staged``:
  ``fuse_embed=False, fuse_qkv=False``) and one kernel per encoder layer
  (``deit_layer``: ``fuse_layer=True``);
* DeiT-S LIS off: make_policy(lis=False) → calibrate → convert(W4A8) →
  attach_u8_ingest → serving_forward(lis=False) on uint8 images, fused
  (``deit_lisoff``), staged (``deit_staged_lisoff``) and per layer
  (``deit_layer_lisoff``);
* Swin-T (``swin_tiny_patch4_window7_224``: C=96, depths (2,2,6,2), heads
  (3,6,12,24), 7×7 windows): seeded init → calibrate (one batch) →
  convert(4) → serving_forward at the defaults (``swin``), and the same
  under make_policy(lis=False) on uint8 images (``swin_lisoff``). On the
  same two states, the serving flags: ``swin_fold`` and
  ``swin_fold_lisoff`` (``fold_windows=True``), ``swin_stem``
  (``fuse_stem=True``) and ``swin_int_stem_unfused`` (``int_stem=True,
  fuse_res=False``).

Phases, one line each, per path:

  1. each kernel of the path against its plain PyTorch version, on the card,
     on the arguments the path gives it (captured from a plain forward at
     batch 8 and 64): mismatch counts; must be 0. The staged path also holds
     ``lis_attention`` against its plain version, on the captured qkv codes
     split to (B·H, N, 64).
  2. the path: launch counts reset, serving_forward through the kernels on
     every request batch, counts read. Its logits must equal the plain
     path's (``use_kernels=False``) bit for bit. uint8 paths: the logits must
     equal those of the same images normalized on the host (numpy float32,
     the literal sequence), and ``u8_ingest_exact`` must hold for the
     literal form (the fused affine form is reported). Flag paths: the
     logits against the default path's on the same state and requests,
     which ``fuse_layer`` (against ``deit`` / ``deit_lisoff``) and
     ``fold_windows`` must equal bit for bit, and ``fuse_stem`` too unless
     s_bn is not a power of two; the int stem with unfused junctions is
     reported (rel error, argmax agreement).
  3. the launch counts of that run: the path's per-forward counts
     (``serving.launches_per_forward``, ``serving_swin.launches_per_forward``
     with the path's flags) and 0 for every other kernel.
  4. logits finite, of shape (B, 1000); relative error, share of equal
     logits and argmax agreement against the fake-quant simulation, and the
     number of distinct predicted classes (reported, not checked).
  5. timing with CUDA events after warm-up: img/s at the largest batch for
     serving with kernels, the plain path, a bf16 ``fp_forward`` (default
     paths) and float32 input (uint8 paths); the device ms per forward from
     ``torch.profiler`` (the port's kernels and the other PyTorch kernels);
     each kernel against its plain version at that batch's shapes, beside
     its bound (the larger of its bytes over 3.35 TB/s and its products over
     the int8 or float32 peak). Then staged against fused, LIS off against
     LIS on, uint8 against float32, and each Swin-T flag path against the
     default, each on one line; ``deit_layer`` against ``deit`` at every
     batch (img/s, device ms, the other PyTorch kernels' and the idle
     share). The fused layer's phase 5 line also splits one call into its
     qkv GEMM, attention and row-tile phases (block 0's clock).

Then the card's name and power limit, one JSON line of per-kernel results
(``launches`` summed over the paths' phase-2 runs, ``ms``/``plain_ms``/
``bound_ms`` per forward at the largest batch summed over the paths that run
the kernel, ``per_model`` the breakdown by path), and last ``{"ok": true,
"device": {...}}``. Any failure raises (exit 1, no result line). There is no
CPU path.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
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
    "lis_attention_fused": ("attention_lis", "lis_attention_fused_plain", "attention_lis.cu",
                            "p2vit_tpu/ops/attention_lis.py:228"),
    "lis_attention": ("attention_lis", "lis_attention_plain", "attention_lis.cu",
                      "p2vit_tpu/ops/attention_lis.py:143"),
    "fused_swin_stem": ("swin_stem", "fused_swin_stem_plain", "swin_stem.cu",
                        "p2vit_tpu/ops/swin_stem.py:60"),
    "swin_lis_attention_folded": ("attention_lis", "swin_lis_attention_folded_plain",
                                  "swin_attention.cu", "p2vit_tpu/ops/attention_lis.py:693"),
    "fused_vit_layer": ("layer_fused", "fused_vit_layer_plain", "layer_fused.cu",
                        "p2vit_tpu/ops/layer_fused.py:125"),
}
PATHS = ("deit", "deit_staged", "deit_layer", "deit_lisoff", "deit_staged_lisoff", "deit_layer_lisoff",
         "swin", "swin_lisoff", "swin_fold", "swin_fold_lisoff", "swin_stem", "swin_int_stem_unfused")
# DeiT-S paths by key suffix: (display name suffix, serving flags)
DEIT_FLAGS = {"": ("", dict(fuse_embed=True, fuse_qkv=True)),
              "_staged": (" staged", dict(fuse_embed=False, fuse_qkv=False)),
              "_layer": (" fused layer", dict(fuse_layer=True))}
# Swin-T paths beyond the defaults: (LIS on, serving flags, check against the
# default path on the same state and requests: "bitwise", "stem" (bitwise
# unless s_bn is not a power of two) or "report")
SWIN_FLAGS = {"swin": (True, {}, None), "swin_lisoff": (False, {}, None),
              "swin_fold": (True, dict(fold_windows=True), "bitwise"),
              "swin_fold_lisoff": (False, dict(fold_windows=True), "bitwise"),
              "swin_stem": (True, dict(fuse_stem=True), "stem"),
              "swin_int_stem_unfused": (True, dict(int_stem=True, fuse_res=False), "report")}
# Published peaks of one H100 SXM at 700 W (NVIDIA's data sheet, dense)
HBM_BYTES_S, INT8_OPS_S, F32_FLOPS_S = 3.35e12, 1979e12, 67e12

MEAN, STD = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)


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


def _device_ms(fn, reps: int):
    """Device time per call from ``torch.profiler`` after one warm-up: (all
    device kernels, the port's kernels, {kernel name: ms}), in ms; (None,
    None, {}) if the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    by_name = {e.key: e.self_device_time_total / reps / 1e3 for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0}
    if not by_name:
        return None, None, {}
    port = sum(v for k, v in by_name.items() if "anonymous namespace" in k)  # the csrc kernels
    return sum(by_name.values()), port, by_name


def _ops(name, a):
    """(operations, peak op/s) of one call: the kernel's products, counted
    as the int8 (or, for the stem, float32) operations they are; the
    epilogues' and the softmax's elementwise work is left out."""
    if name in ("int8_matmul_requant", "int8_matmul_res_ln"):
        (m, k), n = a[0].shape, a[1].shape[0]
        return 2 * m * n * k, INT8_OPS_S
    if name == "fused_patch_embed":
        (b, np_, k), c = a[0].shape, a[1].shape[0]
        return 2 * b * np_ * k * c, INT8_OPS_S
    if name == "fused_swin_stem":
        (m, k), c = a[0].shape, a[1].shape[0]
        return 2 * m * k * c, F32_FLOPS_S
    if name == "lis_attention_qkv_fused":
        (b, n, c_in), c3 = a[0].shape, a[1].shape[0]
        return 2 * b * n * c_in * c3 + 4 * b * n * n * (c3 // 3), INT8_OPS_S
    if name == "lis_attention_fused":
        b, n, c3 = a[0].shape
        return 4 * b * n * n * (c3 // 3), INT8_OPS_S
    if name == "lis_attention":
        bh, n, d = a[0].shape
        return 4 * bh * n * n * d, INT8_OPS_S
    if name == "swin_lis_attention":
        w, n, c3 = a[0].shape
        return 4 * w * n * n * (c3 // 3), INT8_OPS_S
    if name == "swin_lis_attention_folded":
        b, res, _, c3 = a[0].shape
        n = a[4] * a[4]
        return 4 * b * res * res * n * (c3 // 3), INT8_OPS_S
    if name == "fused_vit_layer":
        (b, n, c), hid = a[0].shape, a[19].shape[0]
        return 2 * b * n * c * (3 * c + c) + 2 * b * n * c * hid * 2 + 4 * b * n * n * c, INT8_OPS_S
    return 0, INT8_OPS_S  # the int-LN kernels: elementwise only


def _bound(name, a, outs):
    """(ms, "bytes" or "operations"): the least time the card could take
    for one call, the larger of its bytes (each tensor input read once, each
    output written once) over the HBM rate and its operations over their
    peak."""
    nbytes = sum(t.numel() * t.element_size() for t in list(a) + list(outs)
                 if isinstance(t, torch.Tensor))
    ops, peak = _ops(name, a)
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _is_pot(t) -> bool:
    mant, _ = torch.frexp(torch.as_tensor(t, dtype=torch.float32))
    return bool((mant.abs() == 0.5).all())


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


def host_normalize(u8: torch.Tensor) -> torch.Tensor:
    """uint8 images → (u/255 − mean)/std in float32 on the host (numpy), the
    op sequence of the data pipeline, then back to the images' device."""
    mean = np.asarray(MEAN, np.float32).reshape(3, 1, 1)
    std = np.asarray(STD, np.float32).reshape(3, 1, 1)
    x = (u8.cpu().numpy().astype(np.float32) / np.float32(255.0) - mean) / std
    return torch.from_numpy(x).to(u8.device)


@dataclasses.dataclass
class Path:
    """One serving path as chip_smoke drives it."""

    name: str
    key: str  # the path's name in --models
    kernels: tuple  # kernel names the path runs
    per_forward: dict  # expected launches per forward
    forward: object  # (x, use_kernels) -> logits
    simulate: object  # float32 x -> fake-quant logits
    bf16: object  # float32 x -> bf16 fp logits, or None
    num_classes: int
    img_size: int
    u8_state: dict | None = None  # the serving state of a uint8 path
    split_check: bool = False  # hold lis_attention on lis_attention_fused's arguments
    base: object = None  # (x, use_kernels) -> the default flags' logits on the same state
    base_name: str | None = None  # that default path's name
    base_key: str | None = None  # and its key
    vs_base: str | None = None  # "bitwise", "stem" or "report" (SWIN_FLAGS; fuse_layer bitwise)
    s_bn: object = None  # the state's patch_qact_bn scale ("stem")


def _split_calls(calls):
    """lis_attention_fused_plain's captured calls → lis_attention arguments:
    the (B, N, 3C) qkv codes split to contiguous (B·H, N, 64) q, k, v."""
    out = []
    for a, k in calls:
        qkv, heads = a[0], a[1]
        b, n, c3 = qkv.shape
        parts = qkv.reshape(b, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
        q, kk, v = (parts[i].reshape(b * heads, n, -1).contiguous() for i in range(3))
        out.append(((q, kk, v) + tuple(a[2:]), k))
    return out


def run_path(path: Path, batches, reps, img, ops, counts_api):
    """Phases 1–5 of one path; returns ({kernel: launches, max error, ms and
    plain ms}, {"ms": ms/forward at the largest batch, "f32_ms": the same on
    float32 input})."""
    reset_launch_counts, launch_counts = counts_api
    u8 = path.u8_state is not None
    requests = {b: img(b, path.img_size, u8) for b in batches}
    bt = max(batches)
    plain = {n: (getattr(ops, SOURCES[n][0]), SOURCES[n][1], getattr(ops, n)) for n in path.kernels}
    mods = [v[0] for v in plain.values()]
    pnames = [v[1] for v in plain.values()]
    if path.split_check:
        plain["lis_attention"] = (ops.attention_lis, "lis_attention_plain", ops.lis_attention)

    # ---- phase 1: each kernel vs its plain version on the path's arguments --
    worst = {k: 0 for k in plain}
    mismatches = {k: 0 for k in plain}
    timing_calls = {}
    for b in sorted({8, bt}):
        x = requests[b] if b in requests else img(b, path.img_size, u8)
        calls = _capture(mods, pnames, lambda: path.forward(x, False))
        if path.split_check:
            calls["lis_attention_plain"] = _split_calls(calls["lis_attention_fused_plain"])
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
                    timing_calls.setdefault(name, []).append((a, k, count, _bound(name, a, want)))
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
    if path.base is not None:
        base = {b: path.base(x, True) for b, x in requests.items()}
        neq = {b: int((logits[b] != base[b]).sum()) for b in batches}
        rel = {b: float((logits[b] - base[b]).norm() / base[b].norm().clamp_min(1e-9)) for b in batches}
        agree = {b: float((logits[b].argmax(1) == base[b].argmax(1)).float().mean()) for b in batches}
        print(f"{path.name} phase 2 against {path.base_name} on the same requests: logits != "
              f"{json.dumps(neq)}, rel {json.dumps(rel)}, argmax agreement {json.dumps(agree)}",
              flush=True)
        if path.vs_base == "stem" and any(neq.values()):
            pot = _is_pot(path.s_bn)
            print(f"{path.name} phase 2: the fused stem moved {sum(neq.values())} logits; s_bn is "
                  f"{'' if pot else 'not '}a power of two", flush=True)
            if pot:
                _fail(f"{path.name}: fused stem differs from the fp stem at a power-of-two s_bn")
        if path.vs_base == "bitwise" and any(neq.values()):
            _fail(f"{path.name}: logits differ from {path.base_name}'s: {neq}")
    if u8:
        from p2vit_tpu_torch import serving

        exact = serving.u8_ingest_exact(path.u8_state)
        affine = (serving.u8_ingest_exact(path.u8_state, affine=True) if "lut" in path.u8_state["u8"]
                  else "n/a (no input codes)")
        neq = {b: int((logits[b] != path.forward(host_normalize(x), True)).sum())
               for b, x in requests.items()}
        print(f"{path.name} phase 2 u8_ingest_exact: exact {exact}, affine {affine}; uint8 logits "
              f"!= host-normalized float32 logits: {json.dumps(neq)}", flush=True)
        if not exact or any(neq.values()):
            _fail(f"{path.name}: uint8 ingest is not exact on this card ({exact}) or its logits "
                  f"differ from float32 ingest: {neq}")

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
        sim = path.simulate(host_normalize(requests[b]) if u8 else requests[b])
        rel = float((lg - sim).norm() / sim.norm().clamp_min(1e-9))
        same = float((lg == sim).float().mean())
        agree = float((lg.argmax(1) == sim.argmax(1)).float().mean())
        print(f"{path.name} phase 4 batch {b}: logits finite {tuple(lg.shape)}, |logits| mean "
              f"{float(lg.abs().mean()):.6g}, {len(set(lg.argmax(1).tolist()))} distinct classes; "
              f"vs quant_forward rel {rel:.6g}, equal {same:.4f}, argmax agreement {agree:.4f}")

    # ---- phase 5: timing ----------------------------------------------------
    x = requests[bt]
    xf = host_normalize(x) if u8 else x
    runs = [("int8 kernels", lambda: path.forward(x, True)),
            ("int8 plain", lambda: path.forward(x, False))]
    if path.bf16 is not None:
        runs.append(("bf16 fp_forward", lambda: path.bf16(xf)))
    if u8:
        runs.append(("int8 kernels, float32 input", lambda: path.forward(xf, True)))
    runs.append(("int8 kernels again", lambda: path.forward(x, True)))
    times = {}
    for label, fn in runs:
        with torch.no_grad():
            ms = _time_ms(fn, max(2, reps // 4))
        times[label] = ms
        print(f"{path.name} phase 5 batch {bt} {label}: {ms:.4f} ms/forward, {bt / ms * 1e3:.1f} img/s",
              flush=True)
    ms = min(times["int8 kernels"], times["int8 kernels again"])
    with torch.no_grad():
        dev_ms, port_ms, by_name = _device_ms(lambda: path.forward(x, True), 5)
    if dev_ms is None:
        print(f"{path.name} phase 5 batch {bt} device ms: not measured (the profiler saw no device time)")
    else:
        print(f"{path.name} phase 5 batch {bt} device ms/forward (profiler): {dev_ms:.4f}, of which "
              f"the port's kernels {port_ms:.4f} and other PyTorch kernels {dev_ms - port_ms:.4f}",
              flush=True)
        for name, t in sorted(by_name.items(), key=lambda kv: -kv[1])[:8]:
            print(f"{path.name} phase 5 batch {bt} device ms/forward {t:.4f} {name[:110]}")
    summary = {"ms": ms, "f32_ms": times.get("int8 kernels, float32 input", ms), "device_ms": dev_ms,
               "other_ms": None if dev_ms is None else dev_ms - port_ms}
    results = {}
    for name, (mod, pname, kern) in plain.items():
        k_ms = p_ms = 0.0
        by = {"bytes": 0.0, "operations": 0.0}
        for a, k, count, (b_ms, b_by) in timing_calls[name]:
            t_k = _time_ms(lambda: kern(*a, **k), reps)
            t_p = _time_ms(lambda: getattr(mod, pname)(*a, **k), reps)
            shapes = [tuple(t.shape) for t in a if isinstance(t, torch.Tensor) and t.dim() >= 2]
            print(f"{path.name} phase 5 kernel {name} {shapes}{' gelu' if k.get('gelu') else ''}: "
                  f"{t_k:.4f} ms vs plain {t_p:.4f} ms per call, bound {b_ms:.6f} ms ({b_by}), "
                  f"x{count} per forward")
            if name == "fused_vit_layer":
                print(f"{path.name} phase 5 kernel fused_vit_layer phases: {_layer_phases(kern, a, k)}")
            k_ms += t_k * count
            p_ms += t_p * count
            by[b_by] += b_ms * count
        results[name] = {"launches": counts[name], "max_abs_err": worst[name], "ms": k_ms,
                         "plain_ms": p_ms, "bound_ms": by["bytes"] + by["operations"],
                         "bound_by": max(by, key=by.get)}
    return results, summary


def _layer_phases(kern, a, k, reps=5):
    """The fused layer's three phases (qkv GEMM, attention, row tiles), ms
    per call by block 0's %globaltimer, mean of ``reps`` calls."""
    stamps = torch.zeros((reps, 4), dtype=torch.int64, device=a[0].device)
    for r in range(reps):
        kern(*a, **k, phase_ns=stamps[r])
    torch.cuda.synchronize()
    ms = (stamps[:, 1:] - stamps[:, :-1]).double().mean(0).tolist()
    return (f"qkv GEMM {ms[0] / 1e6:.4f} ms, attention {ms[1] / 1e6:.4f} ms, "
            f"row tiles {ms[2] / 1e6:.4f} ms per call (block 0's clock, mean of {reps})")


def _img_s(bt, ms):
    return f"{bt / ms * 1e3:.1f} img/s ({ms:.4f} ms)"


def print_comparisons(summary, bt):
    """Staged against fused and LIS off against LIS on, both on float32
    input, then uint8 against float32: img/s at batch ``bt`` through the
    kernels, one pair per line."""
    pairs = (("staged vs fused", "DeiT-S staged", "DeiT-S"),
             ("staged vs fused, LIS off", "DeiT-S staged LIS-off", "DeiT-S LIS-off"),
             ("LIS off vs LIS on", "DeiT-S LIS-off", "DeiT-S"),
             ("LIS off vs LIS on, staged", "DeiT-S staged LIS-off", "DeiT-S staged"),
             ("LIS off vs LIS on", "Swin-T LIS-off", "Swin-T"))
    for label, a, b in pairs:
        if a in summary and b in summary:
            print(f"phase 5 compare {label}, batch {bt}, float32 input: {a} "
                  f"{_img_s(bt, summary[a]['f32_ms'])} vs {b} {_img_s(bt, summary[b]['f32_ms'])}")
    for name, t in summary.items():
        if t["f32_ms"] != t["ms"]:
            print(f"phase 5 compare uint8 vs float32 input, batch {bt}: {name} uint8 "
                  f"{_img_s(bt, t['ms'])} vs float32 {_img_s(bt, t['f32_ms'])}")


def print_flag_comparisons(paths, summary, bt):
    """Each Swin-T flag path against the default path on the same state and
    requests: img/s at batch ``bt`` (CUDA events), and device ms per forward
    with the other PyTorch kernels' share (profiler)."""
    def dev(t):
        if t["device_ms"] is None:
            return "device ms not measured"
        return f"device {t['device_ms']:.4f} ms (other PyTorch {t['other_ms']:.4f})"

    for p in paths:
        if p.base_name in summary and not p.key.startswith("deit"):
            a, b = summary[p.name], summary[p.base_name]
            print(f"phase 5 compare {p.name} vs {p.base_name}, batch {bt}: {_img_s(bt, a['ms'])}, "
                  f"{dev(a)} vs {_img_s(bt, b['ms'])}, {dev(b)}")


def print_layer_comparisons(paths, summary, batches, img, reps):
    """``deit_layer`` against ``deit`` on the same requests, at every batch:
    img/s (CUDA events around whole forwards, host gaps included), device ms
    per forward (profiler), the other PyTorch kernels' ms and the idle share
    (1 − device ms / event ms). The largest batch reuses phase 5's readings
    of both paths."""
    bt = max(batches)
    for p in paths:
        if p.key != "deit_layer":
            continue
        for b in batches:
            x = img(b, p.img_size, p.u8_state is not None)
            parts = []
            for name, key, fwd in ((p.name, p.key, p.forward), (p.base_name, p.base_key, p.base)):
                if b == bt and name in summary:
                    t = summary[name]
                    ms, dev_ms, other = t["ms"], t["device_ms"], t["other_ms"]
                else:
                    with torch.no_grad():
                        ms = _time_ms(lambda: fwd(x, True), max(2, reps // 4))
                        dev_ms, port_ms, _ = _device_ms(lambda: fwd(x, True), 5)
                    other = None if dev_ms is None else dev_ms - port_ms
                dev = ("device ms not measured" if dev_ms is None else
                       f"device {dev_ms:.4f} ms, other PyTorch {other:.4f} ms, "
                       f"idle share {1 - dev_ms / ms:.3f}")
                parts.append(f"{key} {_img_s(b, ms)}, {dev}")
            print(f"phase 5 compare {p.key} vs {p.base_key}, batch {b}: {parts[0]} vs {parts[1]}",
                  flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--models", default=",".join(PATHS),
                    help=f"paths to drive, any of {', '.join(PATHS)} (default all)")
    ap.add_argument("--depth", type=int, default=12, help="DeiT-S encoder depth (12 in the model)")
    ap.add_argument("--batches", default="1,8,64", help="request batch sizes")
    ap.add_argument("--calib", type=int, default=32, help="calibration images")
    ap.add_argument("--reps", type=int, default=20, help="timed repetitions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    batches = [int(b) for b in args.batches.split(",")]
    models = args.models.split(",")
    if set(models) - set(PATHS):
        _fail(f"unknown paths {sorted(set(models) - set(PATHS))}; choose from {PATHS}")

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

    gen = torch.Generator().manual_seed(args.seed + 1)

    def img(b, size, u8=False):
        """Seeded request images: float32 normal, or uint8 uniform."""
        if u8:
            return torch.randint(0, 256, (b, 3, size, size), generator=gen, dtype=torch.uint8).to(dev)
        return torch.randn((b, 3, size, size), generator=gen).to(dev)

    def setup(name, model, cfg, lis, convert):
        """Seeded init → calibrate on one batch (uint8 images normalized on
        the host when LIS is off, float32 otherwise) → convert; returns
        (params, qstate, policy, serving state)."""
        t0 = time.time()
        policy = make_policy(lis=lis)
        params = model.init_params(args.seed, cfg, device=dev)
        x = img(args.calib, cfg.img_size, not lis)
        calib = model.calibrate(params, cfg, policy, host_normalize(x) if not lis else x)
        s = convert(params, calib.qstate, cfg, policy)
        torch.cuda.synchronize()
        print(f"{name} setup: calibrate({args.calib} images) + convert {time.time() - t0:.1f} s")
        return params, calib.qstate, policy, s

    paths = []
    deit = [m for m in models if m.startswith("deit")]
    if deit:
        cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], depth=args.depth)
        bits = [4] * cfg.num_matmuls
        idx = vit.bits_to_idx(bits)
        vit_convert = lambda p, q, c, pol: serving.convert(p, q, c, pol, bits)  # noqa: E731
        for lis in (True, False):
            if not any(m.endswith("lisoff") != lis for m in deit):
                continue
            suffix = "" if lis else " LIS-off"
            params, qstate, policy, s = setup("DeiT-S" + suffix, vit, cfg, lis, vit_convert)
            if not lis:
                serving.attach_u8_ingest(s, MEAN, STD)
            base_fwd = lambda x, k, s=s, cfg=cfg, lis=lis: serving.serving_forward(  # noqa: E731
                s, cfg, x, use_kernels=k, lis=lis)
            for var, (label, flags) in DEIT_FLAGS.items():
                key = "deit" + var + ("" if lis else "_lisoff")
                if key not in models:
                    continue
                per_forward = serving.launches_per_forward(cfg, **flags)
                pbf = _cast_tree(params, torch.bfloat16) if key == "deit" else None
                layer = var == "_layer"
                paths.append(Path(
                    "DeiT-S" + label + suffix, key, tuple(per_forward), per_forward,
                    lambda x, k, s=s, cfg=cfg, lis=lis, flags=flags: serving.serving_forward(
                        s, cfg, x, use_kernels=k, lis=lis, **flags),
                    lambda x, p=params, q=qstate, cfg=cfg, pol=policy: vit.quant_forward(
                        p, q, cfg, pol, x, idx),
                    None if pbf is None else lambda x, p=pbf, cfg=cfg: vit.fp_forward(
                        p, cfg, x.to(torch.bfloat16)),
                    cfg.num_classes, cfg.img_size, u8_state=None if lis else s,
                    split_check=var == "_staged", base=base_fwd if layer else None,
                    base_name="DeiT-S" + suffix if layer else None,
                    base_key="deit" + ("" if lis else "_lisoff") if layer else None,
                    vs_base="bitwise" if layer else None))
    swin_names = {"swin": "Swin-T", "swin_lisoff": "Swin-T LIS-off", "swin_fold": "Swin-T fold",
                  "swin_fold_lisoff": "Swin-T fold LIS-off", "swin_stem": "Swin-T fused stem",
                  "swin_int_stem_unfused": "Swin-T int stem unfused"}
    for lis in (True, False):
        keys = [m for m in SWIN_FLAGS if m in models and SWIN_FLAGS[m][0] == lis]
        if not keys:
            continue
        cfg = SWIN_ZOO["swin_tiny_patch4_window7_224"]
        base_key = "swin" if lis else "swin_lisoff"
        params, qstate, policy, s = setup(swin_names[base_key], swin, cfg, lis,
                                          lambda p, q, c, pol: serving_swin.convert(p, q, c, pol, 4))
        if not lis:
            serving_swin.attach_u8_ingest(s, MEAN, STD)

        def fwd(x, k, s=s, q=qstate, cfg=cfg, pol=policy, **flags):
            return serving_swin.serving_forward(s, q, cfg, pol, x, use_kernels=k, **flags)

        for key in keys:
            _, flags, vs_base = SWIN_FLAGS[key]
            pbf = _cast_tree(params, torch.bfloat16) if key == "swin" else None
            per_forward = serving_swin.launches_per_forward(cfg, **flags)
            paths.append(Path(
                swin_names[key], key, tuple(per_forward), per_forward,
                lambda x, k, flags=flags, fwd=fwd: fwd(x, k, **flags),
                lambda x, p=params, q=qstate, cfg=cfg, pol=policy: swin.quant_forward(p, q, cfg, pol, x, 4),
                None if pbf is None else lambda x, p=pbf, cfg=cfg: swin.fp_forward(
                    p, cfg, x.to(torch.bfloat16)),
                cfg.num_classes, cfg.img_size, u8_state=None if lis else s,
                base=None if vs_base is None else fwd,
                base_name=None if vs_base is None else swin_names[base_key],
                base_key=None if vs_base is None else base_key, vs_base=vs_base,
                s_bn=qstate["patch_qact_bn"]["scale"]))

    per_model, summary = {}, {}
    for path in paths:
        t0 = time.time()
        per_model[path.name], summary[path.name] = run_path(
            path, batches, args.reps, img, ops, (reset_launch_counts, launch_counts))
        print(f"{path.name}: phases 1-5 in {time.time() - t0:.1f} s", flush=True)
    print_comparisons(summary, max(batches))
    print_flag_comparisons(paths, summary, max(batches))
    t0 = time.time()
    print_layer_comparisons(paths, summary, batches, img, args.reps)
    print(f"fused-layer comparisons in {time.time() - t0:.1f} s", flush=True)

    results = []
    for k in KERNELS:
        name = k.__name__
        runs = {m: r[name] for m, r in per_model.items() if name in r}
        if not runs and len(paths) == len(PATHS):
            _fail(f"kernel {name} was held on no path")
        if not runs:
            continue
        _, _, src, rep = SOURCES[name]
        results.append({
            "name": name, "route": "cuda", "source": f"p2vit_tpu_torch/csrc/{src}", "replaces": rep,
            "launches": sum(r["launches"] for r in runs.values()),
            "max_abs_err": max(r["max_abs_err"] for r in runs.values()),
            "ms": round(sum(r["ms"] for r in runs.values()), 6),
            "plain_ms": round(sum(r["plain_ms"] for r in runs.values()), 6),
            "bound_ms": round(sum(r["bound_ms"] for r in runs.values()), 6),
            "bound_by": max(("bytes", "operations"),
                            key=lambda b: sum(r["bound_ms"] for r in runs.values() if r["bound_by"] == b)),
            "library_ms": None,
            "per_model": {m: {kk: (round(v, 6) if isinstance(v, float) else v) for kk, v in r.items()}
                          for m, r in runs.items()},
        })
    print(f"(kernel ms / plain_ms / bound_ms: per forward at batch {max(batches)}, summed over the "
          f"paths that run the kernel; lis_attention timed at lis_attention_fused's calls; "
          f"library_ms null: no single PyTorch call computes these quantized functions; card {smi})")
    print(smi)
    print(json.dumps({"kernels": results}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()

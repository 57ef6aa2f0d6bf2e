"""P²-ViT post-training quantization and ImageNet-style evaluation on the
card (counterpart of the JAX package's ``test_quant.py`` CLI).

    python -m p2vit_tpu_torch.cli deit_small <dir> --quant [--serve]
    python -m p2vit_tpu_torch.cli deit_tiny <dir> --quant --serve --device cpu --random-init --limit-val 1
    python -m p2vit_tpu_torch.cli deit_small <dir> --quant --calib-iter 4 --quant-method omse
    python -m p2vit_tpu_torch.cli deit_small <dir> --quant --serve --mixed --live-hessian
    python -m p2vit_tpu_torch.cli deit_small <dir> --quant --serve --mode 2 --plot
    python -m p2vit_tpu_torch.cli deit_small <dir> --quant --serve --tp 2 [--sp] [--dp 2]
    python -m p2vit_tpu_torch.cli deit_small <dir> --quant --serve --pp 2 --pp-micro 4

``<dir>`` holds ``train/`` (calibration) and ``val/`` (evaluation) in the
ImageFolder layout. The flags are the JAX CLI's, with the same names and
defaults; ``--device`` chooses the device (the card unless ``--device cpu``)
and raises when it asks for a card and there is none.

``--dp``, ``--tp`` (``--sp``) and ``--pp`` (``--pp-micro``) serve over a
group of ranks (``build_parallel_meshes``: the JAX CLI's precedence and
lines). Under ``torchrun`` each process is one rank; otherwise ``main``
starts as many ranks as the mesh has (``parallel.dist.run_ranks``), each
on ``--device`` (so on a one-card machine they share the card), and
returns rank 0's result. Rank 0 calibrates (or loads) and hands its state
to the others; rank 0 alone prints.

Under ``--serve`` or ``--serve-weight-only``, a ``[plan]`` line gives
``plan.recommend``'s reason where the chosen path disagrees with the
card's measured table at ``--val-batchsize``.

``--mode 1`` calibrates on Gaussian noise from the port's own
``torch.Generator`` seeded by ``--seed``; ``--mode 2`` on images that
``datafree.generate_data`` synthesizes from the float model (2 × 500 Adam
steps from noise of a CPU ``torch.Generator`` seeded by ``--seed``). The
JAX CLI draws with ``jax.random``, so the two calibrate on different
noise.

``--plot`` (ViT/DeiT) writes the per-channel ranges of the last block's
activations on the first val images (up to 8) as SVGs into ``figs/``;
``plot_distribution`` needs matplotlib.

``main`` runs these steps, which tests call one by one at small sizes:
``make_dataset`` (PIL or the native loader, float32 or uint8 batches),
``calibrate_or_load`` (statistics over ``--calib-iter`` − 1 batches and the
solve on the last, calibration on noise or on synthesized images, or a
saved quant state), ``build_model_fn`` (the forward the flags ask for),
``plan_hint``, ``plot_activations``, ``validate`` (top-1 and
top-5 over the val split) and, under ``--mixed``, ``sensitivities`` (the
mean Hessian table, or live Hutchinson traces) and ``mixed_search`` (the
Pareto front by Hessian-weighted distance, then the evolutionary search,
each candidate validated).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import io
import json
import os
import random
import sys
import time

import numpy as np
import torch

MODEL_CHOICES = [
    "deit_tiny",
    "deit_small",
    "deit_base",
    "vit_base",
    "vit_large",
    "vit_large_384",
    "swin_tiny",
    "swin_small",
    "swin_base",
]

# CLI name -> zoo key
FULL_NAME = {
    "deit_tiny": "deit_tiny_patch16_224",
    "deit_small": "deit_small_patch16_224",
    "deit_base": "deit_base_patch16_224",
    "vit_base": "vit_base_patch16_224",
    "vit_large": "vit_large_patch16_224",
    "vit_large_384": "vit_large_patch16_384",
    "swin_tiny": "swin_tiny_patch4_window7_224",
    "swin_small": "swin_small_patch4_window7_224",
    "swin_base": "swin_base_patch4_window7_224",
}


def str2bool(v):
    """Boolean parsing for --ptf/--lis: true/false/1/0/yes/no/y/n/on/off
    (case-insensitive); ``type=bool`` would take ``False`` as true."""
    if isinstance(v, bool):
        return v
    s = str(v).strip().lower()
    if s in ("true", "1", "yes", "y", "on"):
        return True
    if s in ("false", "0", "no", "n", "off", ""):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def build_parser():
    p = argparse.ArgumentParser(description="P2-ViT on PyTorch/CUDA")
    p.add_argument("model", choices=MODEL_CHOICES)
    p.add_argument("data", metavar="DIR", help="dataset root (train/ + val/)")
    p.add_argument("--quant", action="store_true")
    p.add_argument("--ptf", default=True, type=str2bool,
                   help="Power-of-Two-Factor int LayerNorm (true/false)")
    p.add_argument("--lis", default=True, type=str2bool,
                   help="Log-Int-Softmax (true/false)")
    p.add_argument(
        "--quant-method",
        default="minmax",
        choices=["minmax", "ema", "omse", "percentile"],
    )
    p.add_argument("--mixed", action="store_true", help="mixed-precision search")
    p.add_argument("--calib-batchsize", default=100, type=int)
    p.add_argument(
        "--mode", default=0, type=int,
        help="calibration data: 0 real, 1 gaussian noise (drawn from a torch.Generator seeded by "
             "--seed, not the JAX CLI's jax.random stream), 2 data-free generated",
    )
    p.add_argument(
        "--calib-iter", default=1, type=int,
        help="calibration batches: stats accumulate over N-1 batches, params "
             "solve on the last (default 1: one batch)",
    )
    p.add_argument("--val-batchsize", default=200, type=int)
    p.add_argument("--num-workers", default=16, type=int,
                   help="decode threads of --native-loader")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: cuda (the default; raises without a card) or cpu")
    p.add_argument("--print-freq", default=100, type=int)
    p.add_argument("--seed", default=0, type=int)
    p.add_argument("--checkpoint", default=None, help="local pretrained weights path")
    p.add_argument("--random-init", action="store_true", help="skip pretrained load")
    p.add_argument("--save-quant-state", default=None, metavar="PATH.npz")
    p.add_argument("--load-quant-state", default=None, metavar="PATH.npz")
    p.add_argument("--limit-val", default=None, type=int, help="cap val batches")
    p.add_argument("--serve", action="store_true",
                   help="evaluate on the int8 serving path (the CUDA kernels) instead "
                        "of the fake-quant simulation (fixed bit config)")
    p.add_argument("--serve-weight-only", action="store_true",
                   help="(with --quant) serve the quantized WEIGHTS through the bf16 "
                        "float forward; float activations")
    p.add_argument("--plot", action="store_true",
                   help="dump per-channel activation range plots to figs/ (ViT/DeiT)")
    p.add_argument("--live-hessian", action="store_true",
                   help="compute Hessian traces instead of hardcoded tables")
    p.add_argument("--hessian-batches", default=2, type=int)
    p.add_argument("--native-loader", action="store_true",
                   help="decode/preprocess batches in the C++ thread pool "
                        "(bit-exact with the PIL path; uses --num-workers threads)")
    p.add_argument("--u8-ingest", action="store_true",
                   help="(with --serve) feed RAW uint8 batches and replay "
                        "normalize+quantize on the device: bit-identical logits, "
                        "4x smaller host->device transfer")
    p.add_argument("--dp", default=0, type=int, metavar="N",
                   help="(with --serve) data-parallel serving over N devices")
    p.add_argument("--pp", default=0, type=int, metavar="S",
                   help="(with --serve, ViT/DeiT) pipeline the encoder over S stages")
    p.add_argument("--pp-micro", default=2, type=int, metavar="M",
                   help="(with --pp) microbatches per eval batch")
    p.add_argument("--tp", default=0, type=int, metavar="T",
                   help="(with --serve) tensor-parallel serving over T model shards")
    p.add_argument("--sp", action="store_true",
                   help="(with --tp) sequence-parallel epilogues")
    return p


def build_parallel_meshes(args, cfg, is_swin):
    """Resolve the --dp/--pp/--tp/--sp flags into at most ONE active mesh
    (``test_quant.py``'s function: the same precedence, pp > tp > dp, the
    same lines and the same "ignoring" cases).

    Returns (dp_mesh, pp_mesh, tp_mesh). On the ranks of a process group the
    meshes hold their process groups (every rank must call this in the same
    order); outside one they are the layouts ``main`` sizes its ranks by."""
    from .parallel import mesh as pmesh
    from .parallel import pipeline as ppipe
    from .parallel import tensor_swin

    dp_mesh = None
    pp_mesh = None
    if args.pp and args.pp > 1:
        if not (args.quant and args.serve):
            print("--pp needs --quant --serve; ignoring")
        elif is_swin:
            print("--pp is ViT/DeiT-only (DESIGN.md: Swin's token pyramid "
                  "breaks the PP wire format); ignoring")
        elif args.dp and args.dp > 1:
            print("--pp and --dp are mutually exclusive (1-D meshes); "
                  "using --pp")
            args.dp = 0
        if args.quant and args.serve and not is_swin and args.pp > 1:
            pp_mesh = ppipe.make_pipeline_mesh(args.pp)
            print(f"serving pipeline-parallel over {args.pp} stages, "
                  f"{args.pp_micro} microbatches")
    tp_mesh = None
    if args.tp and args.tp > 1:
        if not (args.quant and args.serve):
            print("--tp needs --quant --serve; ignoring")
        elif pp_mesh is not None:
            print("--tp and --pp are mutually exclusive; using --pp")
        elif is_swin:
            # tp must divide every stage's head count: tiny/small admit
            # tp=3, base tp in {2,4}
            try:
                tensor_swin.check_tp(cfg, args.tp)
            except ValueError as e:
                print(f"--tp {args.tp}: {e}; ignoring")
            else:
                if args.sp:
                    print("--sp is ViT/DeiT-only (Swin's token count "
                          "shrinks 4x per stage — tensor_swin.py docstring);"
                          " ignoring")
                dp = args.dp if args.dp and args.dp > 1 else 1
                tp_mesh = pmesh.make_mesh(dp * args.tp, model_parallel=args.tp)
                print(f"serving tensor-parallel over {args.tp} model shards"
                      + (f" x {dp} data shards" if dp > 1 else ""))
        elif cfg.num_heads % args.tp:
            print(f"--tp {args.tp} does not divide {args.model}'s "
                  f"{cfg.num_heads} heads (try "
                  f"{[t for t in range(2, cfg.num_heads + 1) if cfg.num_heads % t == 0]}); "
                  "ignoring")
        elif cfg.hidden_dim % args.tp:
            print(f"--tp {args.tp} does not divide the MLP hidden width "
                  f"{cfg.hidden_dim}; ignoring")
        else:
            dp = args.dp if args.dp and args.dp > 1 else 1
            tp_mesh = pmesh.make_mesh(dp * args.tp, model_parallel=args.tp)
            print(f"serving tensor-parallel over {args.tp} model shards"
                  + (f" x {dp} data shards" if dp > 1 else "")
                  + (" with sequence-parallel epilogues" if args.sp else ""))
    if args.sp and tp_mesh is None:
        print("--sp needs an active --tp; ignoring")
    if args.dp and args.dp > 1 and tp_mesh is None:
        if args.quant and args.serve:
            dp_mesh = pmesh.make_mesh(args.dp, model_parallel=1)
            print(f"serving data-parallel over {args.dp} devices")
        else:
            print("--dp needs --quant --serve; ignoring")
    return dp_mesh, pp_mesh, tp_mesh


def parallel_world(args, cfg, is_swin) -> int:
    """The ranks the parallel flags ask for (1: none), resolved as
    ``build_parallel_meshes`` resolves them, without its lines."""
    with contextlib.redirect_stdout(io.StringIO()):
        meshes = build_parallel_meshes(copy.copy(args), cfg, is_swin)
    return max([1] + [m.size for m in meshes if m is not None])


def accuracy(logits, target, topk=(1,)):
    """top-k accuracy in percent."""
    logits = np.asarray(logits)
    target = np.asarray(target)
    maxk = max(topk)
    pred = np.argsort(-logits, axis=1)[:, :maxk]
    correct = pred == target[:, None]
    return [100.0 * correct[:, :k].any(axis=1).mean() for k in topk]


def make_dataset(args, cfg, split: str, raw: bool = False):
    """The ``split`` folder of ``args.data`` with the model family's
    preprocessing: the native loader under ``--native-loader``, else PIL;
    uint8 CHW batches when ``raw`` (the uint8 ingest)."""
    from . import data
    from .models import preprocess

    pp = preprocess(FULL_NAME[args.model])
    root = f"{args.data}/{split}"
    if args.native_loader:
        return data.NativeImageFolder(root, cfg.img_size, pp["mean"], pp["std"], pp["crop_pct"],
                                      n_threads=args.num_workers, raw=raw)
    return data.ImageFolder(root, data.build_transform(cfg.img_size, pp["mean"], pp["std"],
                                                       pp["crop_pct"], raw=raw))


def calibrate_or_load(args, cfg, family, params, policy, device):
    """The quant state: loaded from ``--load-quant-state``; or calibrated on
    Gaussian noise (``--mode 1``); or on ``--calib-batchsize`` images that
    ``datafree.generate_data`` synthesizes on ``device`` (``--mode 2``,
    seeded by ``--seed``); or on the shuffled, full batches of the
    train split, statistics over the first ``--calib-iter`` − 1 and the
    solve on the last. Then written to ``--save-quant-state`` if given."""
    from . import checkpoints, data

    if args.load_quant_state:
        calib = checkpoints.load_quant_state(args.load_quant_state, device=device)
        print(f"Loaded quantization state from {args.load_quant_state}")
        return calib
    stats = None
    if args.mode == 1:
        print("Calibrating with Gaussian noise...")
        gen = torch.Generator(device=device).manual_seed(args.seed)
        cal = torch.randn((args.calib_batchsize, 3, cfg.img_size, cfg.img_size), generator=gen, device=device)
    elif args.mode == 2:
        from . import datafree

        print("Generating data...")
        cal = datafree.generate_data(params, cfg, batch_size=args.calib_batchsize, seed=args.seed, device=device)
        print("Calibrating with generated data...")
    else:
        print("Calibrating with real data...")
        train = make_dataset(args, cfg, "train")
        it = data.iterate_batches(train, args.calib_batchsize, shuffle=True, seed=args.seed, drop_last=True)
        batches = []
        try:
            for imgs, _ in it:
                batches.append(imgs)
                if len(batches) >= args.calib_iter:
                    break
        finally:
            it.close()
        if not batches:
            raise SystemExit(f"{args.data}/train holds fewer than --calib-batchsize "
                             f"{args.calib_batchsize} images")
        for bi, imgs in enumerate(batches[:-1]):
            stats = family.collect_stats(params, cfg, policy, torch.from_numpy(imgs).to(device), stats)
            print(f"  stats batch {bi + 1}/{len(batches)}")
        cal = torch.from_numpy(batches[-1]).to(device)
    calib = family.calibrate(params, cfg, policy, cal, stats=stats)
    if args.save_quant_state:
        checkpoints.save_quant_state(args.save_quant_state, calib)
        print(f"Saved quantization state to {args.save_quant_state}")
    return calib


def build_model_fn(args, cfg, family, params, calib, policy, u8: bool, meshes=(None, None, None)):
    """``model_fn(x, bit_config) -> float32 logits`` for the flags:
    ``--serve-weight-only`` (the weight codes dequantized, a bf16 float
    forward), ``--serve`` (convert + the int8 serving forward through the
    kernels, uint8 ingest when ``u8``; on the ranks of a process group
    over the (dp, pp, tp) ``meshes`` of ``build_parallel_meshes``: GPipe,
    megatron TP (with ``--sp`` its sequence-parallel epilogues), or DP),
    ``--quant`` alone (the fake-quant simulation), else the float forward.
    Serving states and their parallel forms are built once per bit
    config."""
    from . import serving, serving_swin
    from .models import preprocess, swin, vit

    is_swin = family is swin
    srv = serving_swin if is_swin else serving
    dp_mesh, pp_mesh, tp_mesh = meshes
    cache = {}
    if args.quant and args.serve_weight_only:
        if args.serve:
            raise SystemExit("--serve and --serve-weight-only are mutually exclusive")
        if args.dp or args.pp > 1 or args.tp > 1:
            print("--dp/--pp/--tp apply to --serve; ignoring for weight-only")

        def model_fn(x, bit_config):
            key = tuple(int(b) for b in bit_config)
            if key not in cache:
                cache[key] = _to_bf16(srv.weight_only_params(params, calib.qstate, cfg, policy, list(key)))
            return family.fp_forward(cache[key], cfg, x.to(torch.bfloat16)).to(torch.float32)
    elif args.quant and args.serve:
        pp = preprocess(FULL_NAME[args.model])

        def forward(key):
            s = srv.convert(params, calib.qstate, cfg, policy, list(key))
            if u8:
                srv.attach_u8_ingest(s, pp["mean"], pp["std"])
            if is_swin and tp_mesh is not None:
                from .parallel import tensor_swin

                return tensor_swin.tp_serving_fn(s, calib.qstate, cfg, tp_mesh, lis=policy.int_softmax)
            if pp_mesh is not None:
                from .parallel import pipeline

                return pipeline.pp_serving_fn(s, cfg, pp_mesh, n_micro=args.pp_micro, lis=policy.int_softmax)
            if tp_mesh is not None:
                from .parallel import tensor

                return tensor.tp_serving_fn(s, cfg, tp_mesh, lis=policy.int_softmax, seq_parallel=args.sp)
            if is_swin:
                fwd = lambda x: serving_swin.serving_forward(s, calib.qstate, cfg, policy, x)  # noqa: E731
            else:
                fwd = lambda x: serving.serving_forward(s, cfg, x, lis=policy.int_softmax)  # noqa: E731
            if dp_mesh is not None:
                from .parallel import mesh as pmesh

                fwd = pmesh.dp_serving_fn(fwd, dp_mesh)
            return fwd

        def model_fn(x, bit_config):
            key = tuple(int(b) for b in bit_config)
            if key not in cache:
                cache[key] = forward(key)
            return cache[key](x)
    elif args.quant and is_swin:
        def model_fn(x, bit_config):
            return swin.quant_forward_mixed(params, calib.qstate, cfg, policy, x,
                                            vit.bits_to_idx(bit_config))
    elif args.quant:
        def model_fn(x, bit_config):
            return vit.quant_forward(params, calib.qstate, cfg, policy, x, vit.bits_to_idx(bit_config))
    else:
        def model_fn(x, bit_config):
            return family.fp_forward(params, cfg, x)
    return torch.no_grad()(model_fn)


def plan_hint(args, cfg) -> str | None:
    """Under ``--quant`` with ``--serve`` or ``--serve-weight-only``, the
    ``[plan]`` line where the chosen path disagrees with
    ``plan.recommend(cfg, --val-batchsize)`` (printed), else None."""
    if not (args.quant and (args.serve or args.serve_weight_only)):
        return None
    from . import plan

    rec = plan.recommend(cfg, args.val_batchsize)
    line = None
    if args.serve and rec.path != "int8":
        line = f"[plan] {rec.reason}"
    elif args.serve_weight_only and rec.path == "int8":
        line = f"[plan] int8 serving (--serve) beats bf16 here: {rec.reason}"
    if line:
        print(line)
    return line


def plot_activations(args, cfg, is_swin, params, val, u8, device):
    """``--plot``: the last block's activations of the float forward on the
    first val images (up to 8; uint8 batches under ``--u8-ingest``
    normalized here as the float path's transform does), drawn by
    ``analysis.plot_distribution`` into ``figs/``. Returns the SVG paths,
    or None for Swin, which the reference does not plot."""
    if is_swin:
        print("--plot is ViT/DeiT-only (reference plots vit_base); skipping")
        return None
    from . import analysis, data
    from .models import preprocess

    it = data.iterate_batches(val, min(args.val_batchsize, 8))
    try:
        imgs, _ = next(it)
    finally:
        it.close()
    x = torch.from_numpy(imgs).to(device)
    if u8:
        pp = preprocess(FULL_NAME[args.model])
        mean = torch.tensor(pp["mean"], dtype=torch.float32, device=device)[:, None, None]
        std = torch.tensor(pp["std"], dtype=torch.float32, device=device)[:, None, None]
        x = (x.to(torch.float32) / torch.tensor(255.0, device=device) - mean) / std
    acts = analysis.collect_activations(params, cfg, x)
    paths = analysis.plot_distribution(acts, args.model, args.quant)
    print(f"wrote {len(paths)} activation plots to figs/")
    return paths


def _to_bf16(tree):
    if isinstance(tree, dict):
        return {k: _to_bf16(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_bf16(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.dtype == torch.float32:
        return tree.to(torch.bfloat16)
    return tree


def validate(args, val, model_fn, bit_config, device, on_batch=None):
    """Top-1 and top-5 (percent) over ``val`` in batches of
    ``--val-batchsize`` (at most ``--limit-val`` of them), decoded by a
    prefetch thread; prints every ``--print-freq``-th batch and the
    ` * Prec@1 ... Prec@5 ...` line. ``on_batch(i, imgs, targets, logits,
    wait_s, forward_s)``, if given, sees each batch: the host seconds spent
    waiting on the prefetch queue and in the forward (to logits on the
    host)."""
    from . import data
    from .profiling import AverageMeter

    batch_time, top1, top5 = AverageMeter(), AverageMeter(), AverageMeter()
    end = time.time()
    it = data.iterate_batches(val, args.val_batchsize, prefetch=2)
    try:
        t_wait = time.perf_counter()
        for i, (imgs, targets) in enumerate(it):
            if args.limit_val is not None and i >= args.limit_val:
                break
            t_fwd = time.perf_counter()
            logits = model_fn(torch.from_numpy(imgs).to(device), bit_config).cpu().numpy()
            t_done = time.perf_counter()
            if on_batch is not None:
                on_batch(i, imgs, targets, logits, t_fwd - t_wait, t_done - t_fwd)
            p1, p5 = accuracy(logits, targets, topk=(1, 5))
            top1.update(p1, len(targets))
            top5.update(p5, len(targets))
            batch_time.update(time.time() - end)
            end = time.time()
            if i % args.print_freq == 0:
                print(
                    f"Test: [{i}]\tTime {batch_time.val:.3f} ({batch_time.avg:.3f})"
                    f"\tPrec@1 {top1.val:.3f} ({top1.avg:.3f})"
                    f"\tPrec@5 {top5.val:.3f} ({top5.avg:.3f})"
                )
            t_wait = time.perf_counter()
    finally:
        it.close()
    print(f" * Prec@1 {top1.avg:.3f} Prec@5 {top5.avg:.3f}")
    return top1.avg, top5.avg


def sensitivities(args, cfg, params, device) -> list:
    """The mixed-precision search's per-layer weights (n − 1 values): the
    normalized mean of Hutchinson Hessian traces over ``--hessian-batches``
    shuffled train batches under ``--live-hessian`` (batch i's probes from a
    generator seeded by ``--seed`` + i), else the model's table in
    ``hessian_tables.MEAN_HESSIAN``."""
    if not args.live_hessian:
        from .hessian_tables import MEAN_HESSIAN

        if args.model not in MEAN_HESSIAN:
            raise SystemExit(f"no hardcoded Hessian table for {args.model}; use --live-hessian")
        return MEAN_HESSIAN[args.model]
    from . import data
    from .hessian import hessian_traces, normalized_mean_hessian

    print("Calculating sensitivities via the averaged Hessian trace...")
    train = make_dataset(args, cfg, "train")
    it = data.iterate_batches(train, args.calib_batchsize, shuffle=True, seed=args.seed + 1, drop_last=True)
    traces = []
    try:
        for i, (imgs, targets) in enumerate(it):
            if i >= args.hessian_batches:
                break
            gen = torch.Generator(device=device).manual_seed(args.seed + i)
            traces.append(hessian_traces(params, cfg, torch.from_numpy(imgs).to(device),
                                         torch.from_numpy(targets).to(device), gen))
    finally:
        it.close()
    return normalized_mean_hessian(traces)


def mixed_search(args, cfg, is_swin, calib, mean_hessian, validate_fn):
    """The Hessian-guided mixed-precision search: the Pareto front of
    sampled bit configs by Ω (Hessian-weighted quantization distance), its
    five best validated, then the evolutionary search from the front.
    ``validate_fn(bit_config) -> (prec1, prec5)``. Prints the JAX CLI's
    lines and returns (front, population)."""
    from . import search
    from .models import swin

    n = cfg.num_matmuls
    layout = swin.mixed_layout(cfg)[0] if is_swin else None
    # ViT distances omit the patch row; Swin's calibration records one per weight layer
    assert len(calib.flops) == n
    assert len(calib.global_distance) == (n if is_swin else n - 1)
    assert len(mean_hessian) == n - 1
    distance = calib.global_distance.detach().cpu().numpy()

    print("Pareto Frontier.......")
    rng = random.Random(args.seed)
    front = search.pareto_front(calib.flops, distance, mean_hessian, rng, layout=layout,
                                distances_include_patch=is_swin)
    print("Hessian-Based Validating...")
    for bits, _ in front[:5]:
        print(bits)
        validate_fn(bits)
    print("Start Evolutionary.......")
    result = search.evolutionary_search(lambda bc: validate_fn(bc)[0], [c for c, _ in front], calib.flops, rng)
    print("Best mixed-precision configs:")
    for bits, prec1 in result[:5]:
        print(json.dumps({"bit_config": bits, "prec1": prec1}))
    return front, result


def load_model(args, cfg, family, device):
    """Params on ``device``: seeded random init under ``--random-init``,
    else the pretrained checkpoint (``--checkpoint`` or the hub cache)."""
    from . import checkpoints, interop

    if args.random_init:
        print("WARNING: random init (no pretrained weights)")
        return family.init_params(args.seed, cfg, device=device)
    return interop.params_from_numpy(
        checkpoints.load_pretrained(FULL_NAME[args.model], cfg, args.checkpoint), device=device)


RANK_GROUP_TIMEOUT_S = 3600  # a rank waits this long in a collective (rank 0 calibrating) before failing


def _rank_main(device, argv):
    """``main`` on one rank of the group ``main`` started; only rank 0
    prints."""
    from .parallel import dist as pdist

    if pdist.rank() != 0:
        sys.stdout = open(os.devnull, "w")
    return main(argv)


def main(argv=None, timeout_s: float | None = None):
    """Run the CLI on ``argv``. A parallel flag outside ``torchrun`` starts
    one rank per mesh position, killed and raising past ``timeout_s``
    seconds (None: no deadline; a rank waiting longer than
    ``RANK_GROUP_TIMEOUT_S`` in one collective fails all the same)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)

    from .config import make_policy
    from .models import MODEL_ZOO, swin, vit
    from .models.common import target_device
    from .parallel import dist as pdist

    device = target_device(args.device)
    cfg = MODEL_ZOO[FULL_NAME[args.model]]
    family = swin if args.model.startswith("swin") else vit
    is_swin = family is swin
    if not pdist.initialized():
        if pdist.under_torchrun():
            device = pdist.init_from_env(device, RANK_GROUP_TIMEOUT_S)
        else:
            world = parallel_world(args, cfg, is_swin)
            if world > 1:
                # one rank per mesh position, every one on ``device`` (a
                # one-card machine time-slices them); rank 0's result
                threads = max(1, torch.get_num_threads() // world)
                return pdist.run_ranks(_rank_main, world, argv, device=device, timeout_s=timeout_s,
                                       threads=threads, group_timeout_s=RANK_GROUP_TIMEOUT_S)[0]
    policy = make_policy(args.ptf, args.lis, args.quant_method)
    params = load_model(args, cfg, family, device)

    calib = None
    if args.quant:
        if pdist.world_size() > 1:  # rank 0 calibrates (or loads), the others take its state
            calib = calibrate_or_load(args, cfg, family, params, policy, device) if pdist.rank() == 0 else None
            calib = pdist.broadcast_object(calib, 0, device)
        else:
            calib = calibrate_or_load(args, cfg, family, params, policy, device)
    u8 = args.u8_ingest and args.quant and args.serve
    if args.u8_ingest and not u8:
        print("--u8-ingest needs --quant --serve; ignoring")
    val = make_dataset(args, cfg, "val", raw=u8)
    meshes = build_parallel_meshes(args, cfg, is_swin)
    model_fn = build_model_fn(args, cfg, family, params, calib, policy, u8, meshes)
    plan_hint(args, cfg)
    if args.plot and pdist.rank() == 0:
        plot_activations(args, cfg, is_swin, params, val, u8, device)
    if args.mixed:
        if not args.quant:
            raise SystemExit("--mixed requires --quant")
        mean_hessian = sensitivities(args, cfg, params, device)
        return mixed_search(args, cfg, is_swin, calib, mean_hessian,
                            lambda bits: validate(args, val, model_fn, bits, device))
    bit_config = [4] * cfg.num_matmuls
    print(bit_config)
    return validate(args, val, model_fn, bit_config, device)


if __name__ == "__main__":
    main()

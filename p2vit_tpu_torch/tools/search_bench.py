"""Wall time of the mixed-precision search at full size on a synthetic val
set (counterpart of the JAX package's ``tools/search_bench.py`` and,
through ``search_bench_swin``, ``tools/search_bench_swin.py``).

The reference's ``--mixed`` model (deit_base) at full size: seeded random
weights, calibration on 100 seeded images (timed twice: the first call
includes the allocator's and the libraries' warm-up), the sensitivities
(ViT: the reference's mean-Hessian table; Swin: live Hutchinson traces on
``--hessian-batches`` batches, timed), the Pareto front (sampling and the Ω
ranking, host only), its five best validated, then the bounded evolution
(25 a population, 8 generations). A candidate is validated by the
fake-quant simulation (``quant_forward`` / ``quant_forward_mixed``) over
``--val-batches`` × ``--batch`` seeded images whose labels are the float
model's argmax. Reports each phase's seconds, candidates per second and
simulated images per second.

The JAX tool also counts its jit cache after the last candidate, to show
that one compiled executable served every config. PyTorch runs eagerly and
compiles nothing per config, so there is no counterpart and that check is
left out.

    python -m p2vit_tpu_torch.tools.search_bench [model] [--val-batches N] [--batch B] [--device cuda]
    python -m p2vit_tpu_torch.tools.search_bench_swin [model] [--hessian-batches H] ...

Defaults: deit_base, 2 batches of 128 (Swin: swin_tiny, 2 of 64, 2 Hessian
batches of 32). Without a CUDA device it stops unless given ``--device
cpu``. Prints the phase lines, then one JSON line.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import numpy as np
import torch

from .. import search
from ..cli import FULL_NAME
from ..config import make_policy
from ..hessian import hessian_traces, normalized_mean_hessian
from ..hessian_tables import MEAN_HESSIAN
from ..models import MODEL_ZOO, SWIN_ZOO, swin, vit


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _randn(shape, seed, dev):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dev)


def run(name, n_batches, batch, dev, n_hess=2, hess_batch=32, n_calib=100, pop_size=25, evo_iter=8) -> dict:
    """The search at ``name``'s full size; returns the JSON line's dict."""
    cfg = MODEL_ZOO[name]
    is_swin = name in SWIN_ZOO
    fam = swin if is_swin else vit
    policy = make_policy()
    s = cfg.img_size
    print(f"== search_bench {name} device={torch.cuda.get_device_name(dev) if dev.type == 'cuda' else 'cpu'} "
          f"val={n_batches}x{batch}" + (f" hessian={n_hess}x{hess_batch}" if is_swin else ""), flush=True)
    params = fam.init_params(0, cfg, device=dev)
    xc = _randn((n_calib, 3, s, s), 7, dev)
    t_calib = []
    for _ in range(2):
        t0 = time.perf_counter()
        calib = fam.calibrate(params, cfg, policy, xc)
        _sync(dev)
        t_calib.append(time.perf_counter() - t0)
    print(f"  calibration ({n_calib} img): {t_calib[0]:.2f} s first call; again {t_calib[1]:.3f} s", flush=True)

    with torch.no_grad():
        xs = [_randn((batch, 3, s, s), 100 + i, dev) for i in range(n_batches)]
        ys = [fam.fp_forward(params, cfg, x).argmax(dim=-1) for x in xs]
    t_hess = 0.0
    if is_swin:
        t0 = time.perf_counter()
        traces = []
        for i in range(n_hess):
            xh = _randn((hess_batch, 3, s, s), 50 + i, dev)
            with torch.no_grad():
                yh = fam.fp_forward(params, cfg, xh).argmax(dim=-1)
            traces.append(hessian_traces(params, cfg, xh, yh, torch.Generator(device=dev).manual_seed(i)))
        mean_hessian = normalized_mean_hessian(traces)
        _sync(dev)
        t_hess = time.perf_counter() - t0
        print(f"  live Hessian traces ({n_hess} batches x 16 probes): {t_hess:.1f} s "
              f"({len(mean_hessian)} weight layers)", flush=True)
    else:
        short = name.split("_patch")[0]
        if short not in MEAN_HESSIAN:
            raise SystemExit(f"no mean-Hessian table for {short}; the tables cover {sorted(MEAN_HESSIAN)}")
        mean_hessian = MEAN_HESSIAN[short]

    times = []

    @torch.no_grad()
    def validate_fn(bit_config):
        t0 = time.perf_counter()
        bi = vit.bits_to_idx(bit_config)
        correct = total = 0
        for x, y in zip(xs, ys):
            logits = (swin.quant_forward_mixed if is_swin else vit.quant_forward)(
                params, calib.qstate, cfg, policy, x, bi)
            correct += int((logits.argmax(dim=-1) == y).sum())
            total += len(y)
        times.append(time.perf_counter() - t0)
        return 100.0 * correct / total

    rng = random.Random(0)
    layout = swin.mixed_layout(cfg)[0] if is_swin else None
    t0 = time.perf_counter()
    front = search.pareto_front(calib.flops, calib.global_distance.detach().cpu().numpy(), mean_hessian, rng,
                                layout=layout, distances_include_patch=is_swin)
    t_pareto = time.perf_counter() - t0
    if not front:
        raise SystemExit("Pareto front is empty: the pinned 8-bit patch embedding exceeds the 1.1x-all-4-bit "
                         "size budget at this geometry (search.sample_bit_configs)")
    print(f"  Pareto sampling + Omega ranking ({len(front)} configs): {t_pareto:.3f} s (host only)", flush=True)
    top = [(c, validate_fn(c)) for c, _ in front[:5]]
    n_top = len(top)
    print(f"  top-{n_top} Pareto validated: best {max(a for _, a in top):.2f}% "
          f"(first candidate {times[0]:.2f} s)", flush=True)
    t0 = time.perf_counter()
    result = search.evolutionary_search(validate_fn, [c for c, _ in front], calib.flops, rng,
                                        pop_size=pop_size, evo_iter=evo_iter)
    t_evo = time.perf_counter() - t0
    steady = times[1:] or times
    med = float(np.median(steady))
    imgs = n_batches * batch
    print(f"  evolutionary search ({evo_iter} generations): {t_evo:.1f} s, {len(times)} validations in all",
          flush=True)
    print(f"  per candidate: first {times[0]:.3f} s, then median {med:.3f} s / max {max(steady):.3f} s "
          f"-> {1 / med:.2f} candidates/s at {imgs} images each", flush=True)
    print(f"  simulation throughput inside the search: {imgs / med:.0f} img/s", flush=True)
    wall = t_calib[0] + t_hess + t_pareto + sum(times[:n_top]) + t_evo
    print(f"  END-TO-END --mixed wall (calibration + {'Hessian + ' if is_swin else ''}Pareto + top-5 + "
          f"evolution): {wall:.1f} s", flush=True)
    best = result[0]
    print(f"  best config acc {best[1]:.2f}%  bits[:12]={best[0][:12]}", flush=True)
    return {"model": name, "val_images": imgs, "calib_s": t_calib[0], "calib_again_s": t_calib[1],
            "hessian_s": t_hess, "front": len(front), "pareto_s": t_pareto, "validations": len(times),
            "candidate_first_s": times[0], "candidate_median_s": med, "candidates_per_s": 1 / med,
            "sim_img_per_s": imgs / med, "evolution_s": t_evo, "wall_s": wall, "best_prec1": best[1]}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="search_bench: the mixed-precision search's wall time")
    ap.add_argument("model", nargs="?", default="deit_base")
    ap.add_argument("--val-batches", type=int, default=2)
    ap.add_argument("--batch", type=int, default=None, help="val batch size (default 128; Swin 64)")
    ap.add_argument("--hessian-batches", type=int, default=2, help="(Swin) live Hessian batches")
    ap.add_argument("--device", default="cuda", help="cuda (default), or cpu")
    return ap


def bench(args) -> dict:
    """``run`` on parsed ``parser()`` arguments, printing its JSON line."""
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("search_bench: no CUDA device; pass --device cpu to run on the CPU")
    name = FULL_NAME.get(args.model, args.model)
    batch = args.batch or (64 if name in SWIN_ZOO else 128)
    res = run(name, args.val_batches, batch, torch.device(args.device), args.hessian_batches)
    print(json.dumps(res))
    return res


def main(argv=None) -> dict:
    return bench(parser().parse_args(argv))

if __name__ == "__main__":
    main()

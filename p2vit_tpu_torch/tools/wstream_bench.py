"""The weight-streaming bf16 matmul in four weight stores against the bf16
library GEMM, on the DeiT-S serving GEMMs (counterpart of the JAX package's
``tools/wstream_bench.py``).

Arms, per GEMM at each M (197 token rows per image) and on a ``--depth``
chain qkv → proj (on the first C columns) → fc1 (GELU) → fc2:

  library : ``torch.matmul`` in bf16 over bf16 weight constants, the GEMM
            weight-only serving runs, then the float32 epilogue (×r, +b,
            PyTorch's erf GELU on fc1) and the bf16 rounding: the JAX
            tool's ``xla`` arm (``wstream_ref``), but for PyTorch's bf16
            matmul rounding its float32 sums to bf16
  bf16, i8, w8p, w4p : ``wstream_matmul`` over that store

All arms serve the same int4-valued codes. Each line gives ms per call, a
``!`` after an arm whose per-row argmax agrees with the library arm's on
fewer than 99 % of rows, and the best arm's speed-up over the library;
the JSON line adds each store's bytes ratio to bf16.

    python -m p2vit_tpu_torch.tools.wstream_bench [--device cuda] [--iters 20] [--depth 12]

Without a CUDA device it stops unless given ``--device cpu`` (the plain
versions, for a smoke run).
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import profiling
from ..models import common
from ..ops.matmul_wstream import FORMATS as ARMS
from ..ops.matmul_wstream import pack_w4, pack_w8, wstream_matmul
from . import _gemm_bench as gb

PACK = {"bf16": lambda w: w.to(torch.bfloat16), "i8": lambda w: w, "w8p": pack_w8, "w4p": pack_w4}
# a narrower row-scale pool than w4pack's keeps |out| in bf16's dense range,
# so the per-row argmax agreement means something
REXP = (-9, -5)


def library_mm(x, wb, r, b, gelu=False):
    """The library arm over the bf16 store ``wb``."""
    y = torch.matmul(x, wb.T).to(torch.float32) * r + b
    return (common.gelu(y) if gelu else y).to(torch.bfloat16)


def _mm(arm):
    if arm == "library":
        return library_mm
    return lambda x, w, r, b, gelu=False: wstream_matmul(x, w, r, b, w_format=arm, gelu=gelu)


def _store(arm, w):
    return PACK["bf16" if arm == "library" else arm](w)


def gemm_case(m, k, n, rng, device):
    """One GEMM's seeded inputs: (x bf16 (m, k), codes, r, b)."""
    w, r, b = gb.make_consts(rng, k, n, REXP, device)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(device).to(torch.bfloat16)
    return x, w, r, b


def _agree(out, ref) -> float:
    return float((out.argmax(1) == ref.argmax(1)).float().mean())


def run_gemm(name, m, k, n, gelu, rng, iters, device) -> dict:
    x, w, r, b = gemm_case(m, k, n, rng, device)
    bf16_bytes = 2 * w.numel()
    res = {}
    line = f"   {name:5s} M={m:5d} K={k:4d} N={n:4d}:"
    ref = None
    for arm in ("library", *ARMS):
        ws = _store(arm, w)
        out = _mm(arm)(x, ws, r, b, gelu)
        ref = out if ref is None else ref
        res[f"{arm}_ms"] = profiling.device_time_ms(lambda xx: _mm(arm)(xx, ws, r, b, gelu), x, iters=iters)
        line += f" {arm} {res[f'{arm}_ms']:8.4f}"
        if arm != "library":
            res[f"{arm}_agree"] = _agree(out, ref)
            res[f"{arm}_bytes_ratio"] = round(bf16_bytes / (ws.numel() * ws.element_size()), 3)
            line += "!" if res[f"{arm}_agree"] < 0.99 else ""
        line += " |"
    best = min(ARMS, key=lambda a: res[a + "_ms"])
    print(line[:-2] + f"  ({res['library_ms'] / res[best + '_ms']:.3f}x best={best})", flush=True)
    return res


def chain_case(m, seed, depth, device):
    """The chain's seeded inputs: (x bf16 (m, C), layers)."""
    rng = np.random.RandomState(seed)
    layers = gb.layer_consts(rng, depth, REXP, device)
    c = gb.DEIT_S_GEMMS[0][1]
    x = torch.from_numpy(rng.randn(m, c).astype(np.float32)).to(device).to(torch.bfloat16)
    return x, layers


def chain_stores(arm, layers):
    return [[_store(arm, w) for w, _, _ in lay] for lay in layers]


def chain(arm, x, layers, stores):
    """``depth`` layers of qkv → proj → fc1 (GELU) → fc2 through one arm."""
    mm = _mm(arm)
    c = x.shape[1]
    for lay, ws in zip(layers, stores):
        (_, rq, bq), (_, rp, bp), (_, r1, b1), (_, r2, b2) = lay
        a = mm(x, ws[0], rq, bq)
        p = mm(a[:, :c].contiguous(), ws[1], rp, bp)
        f = mm(p, ws[2], r1, b1, True)
        x = mm(f, ws[3], r2, b2)
    return x


def run_depth_chain(m, seed, iters, depth, device) -> dict:
    x, layers = chain_case(m, seed, depth, device)
    res = {}
    line = f"   depth-{depth} chain M={m}:"
    ref = None
    for arm in ("library", *ARMS):
        stores = chain_stores(arm, layers)
        out = chain(arm, x, layers, stores)
        ref = out if ref is None else ref
        res[f"{arm}_ms"] = profiling.device_time_ms(lambda xx: chain(arm, xx, layers, stores), x, iters=iters)
        line += f" {arm} {res[f'{arm}_ms']:8.4f}"
        if arm != "library":
            res[f"{arm}_agree"] = _agree(out, ref)
            line += "!" if res[f"{arm}_agree"] < 0.99 else ""
        line += " |"
    best = min(ARMS, key=lambda a: res[a + "_ms"])
    res["best"] = best
    res["best_vs_library"] = round(res["library_ms"] / res[best + "_ms"], 4)
    print(line[:-2] + f"  ({res['best_vs_library']}x best={best})", flush=True)
    return res


def main(argv=None) -> dict:
    args = gb.parse_args(argv, "wstream_bench: the weight-streaming matmul against the bf16 library GEMM")
    print(f"== wstream_bench device={gb.device_name(args.device)}")
    res = {}
    for m in gb.MS:
        print(f"-- DeiT-S GEMMs at M={m} (library = the weight-only forward's GEMM)")
        rng = np.random.RandomState(m)
        for name, k, n, gelu in (*gb.DEIT_S_GEMMS, gb.CONTROL):
            res[f"{name}@m{m}"] = run_gemm(name, m, k, n, gelu, rng, args.iters, args.device)
        res[f"chain@m{m}"] = run_depth_chain(m, m + 1, max(1, args.iters // 4), args.depth, args.device)
    print("\n" + json.dumps({k: {kk: (round(v, 4) if isinstance(v, float) else v) for kk, v in d.items()}
                             for k, d in res.items()}))
    return res


if __name__ == "__main__":
    main()

"""The int4-packed weight store against the int8 store on the DeiT-S serving
GEMMs (counterpart of the JAX package's ``tools/w4pack_latency.py``).

Arms, per GEMM at each M (197 token rows per image) and on a ``--depth``
chain qkv → proj (on the first C columns) → fc1 (GELU, out_inv 8) → fc2:

  i8  : ``int8_matmul_requant`` over the (N, K) int8 store (serving today)
  w4p : ``int4_matmul_requant`` over ``pack_int4``'s (N, K/2) store

Both serve the same int4-valued codes, so the two arms are bit for bit the
same; every GEMM and every chain checks it (``bitwise=ok``). The deit_base
fc2 GEMM (K = 3072) is the control at the full 2× byte ratio.

    python -m p2vit_tpu_torch.tools.w4pack_latency [--device cuda] [--iters 20] [--depth 12]

Without a CUDA device it stops unless given ``--device cpu`` (the plain
versions, for a smoke run). Prints one line per GEMM and per chain, then one
JSON line of the results.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from .. import profiling
from ..ops.matmul_int8 import int4_matmul_requant, int8_matmul_requant, pack_int4
from . import _gemm_bench as gb

STORE_ARMS = ("i8", "w4p")


def _mm(arm):
    return int8_matmul_requant if arm == "i8" else int4_matmul_requant


def _kw(gelu):
    return {"gelu": True, "out_inv": 8.0} if gelu else {}


def gemm_case(m, k, n, gelu, rng, device):
    """One GEMM's seeded inputs: (x, {arm: store}, r, b, epilogue kwargs)."""
    w, r, b = gb.make_consts(rng, k, n, device=device)
    x = torch.from_numpy(rng.randint(-128, 128, (m, k)).astype(np.int8)).to(device)
    return x, {"i8": w, "w4p": pack_int4(w)}, r, b, _kw(gelu)


def run_gemm(name, m, k, n, gelu, rng, iters, device) -> dict:
    x, stores, r, b, kw = gemm_case(m, k, n, gelu, rng, device)
    outs = {a: _mm(a)(x, stores[a], r, b, **kw) for a in STORE_ARMS}
    ok = torch.equal(outs["i8"], outs["w4p"])
    res = {"bitwise": ok}
    for a in STORE_ARMS:
        res[f"{a}_ms"] = profiling.device_time_ms(lambda xx, a=a: _mm(a)(xx, stores[a], r, b, **kw), x,
                                                  iters=iters)
    print(f"   {name:5s} M={m:5d} K={k:4d} N={n:4d}: i8 {res['i8_ms']:8.4f} ms | w4p {res['w4p_ms']:8.4f} ms "
          f"({res['i8_ms'] / res['w4p_ms']:.3f}x)  [bitwise={'ok' if ok else 'MISMATCH'}]", flush=True)
    return res


def chain_case(m, seed, depth, device):
    """The chain's seeded inputs: (x (m, C) int8, layers, {arm: stores})."""
    rng = np.random.RandomState(seed)
    layers = gb.layer_consts(rng, depth, device=device)
    c = gb.DEIT_S_GEMMS[0][1]
    x = torch.from_numpy(rng.randint(-128, 128, (m, c)).astype(np.int8)).to(device)
    stores = {"i8": [[w for w, _, _ in lay] for lay in layers],
              "w4p": [[pack_int4(w) for w, _, _ in lay] for lay in layers]}
    return x, layers, stores


def chain(arm, x, layers, stores):
    """``depth`` layers of qkv → proj → fc1 (GELU) → fc2 through one arm."""
    mm = _mm(arm)
    c = x.shape[1]
    for lay, ws in zip(layers, stores[arm]):
        (_, rq, bq), (_, rp, bp), (_, r1, b1), (_, r2, b2) = lay
        a = mm(x, ws[0], rq, bq)
        p = mm(a[:, :c].contiguous(), ws[1], rp, bp)
        f = mm(p, ws[2], r1, b1, **_kw(True))
        x = mm(f, ws[3], r2, b2)
    return x


def run_depth_chain(m, seed, iters, depth, device) -> dict:
    x, layers, stores = chain_case(m, seed, depth, device)
    ok = torch.equal(chain("i8", x, layers, stores), chain("w4p", x, layers, stores))
    res = {"bitwise": ok}
    for a in STORE_ARMS:
        res[f"{a}_ms"] = profiling.device_time_ms(lambda xx, a=a: chain(a, xx, layers, stores), x, iters=iters)
    print(f"   depth-{depth} chain M={m}: i8 {res['i8_ms']:8.4f} ms | w4p {res['w4p_ms']:8.4f} ms "
          f"({res['i8_ms'] / res['w4p_ms']:.3f}x)  [bitwise={'ok' if ok else 'MISMATCH'}]", flush=True)
    return res


def main(argv=None) -> dict:
    args = gb.parse_args(argv, "w4pack_latency: the int4-packed store against the int8 store")
    print(f"== w4pack_latency device={gb.device_name(args.device)}")
    res = {}
    for m in gb.MS:
        print(f"-- DeiT-S GEMMs at M={m}")
        rng = np.random.RandomState(m)
        for name, k, n, gelu in (*gb.DEIT_S_GEMMS, gb.CONTROL):
            res[f"{name}@m{m}"] = run_gemm(name, m, k, n, gelu, rng, args.iters, args.device)
        res[f"chain@m{m}"] = run_depth_chain(m, m + 1, max(1, args.iters // 4), args.depth, args.device)
    print("\n" + json.dumps({k: {kk: (round(v, 4) if isinstance(v, float) else v) for kk, v in d.items()}
                             for k, d in res.items()}))
    return res


if __name__ == "__main__":
    main()

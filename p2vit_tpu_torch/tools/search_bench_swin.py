"""Wall time of the Swin mixed-precision search at full size (counterpart
of the JAX package's ``tools/search_bench_swin.py``): live Hutchinson
Hessian traces, the ``mixed_layout``-coupled Pareto front, its five best
and the bounded evolution over ``quant_forward_mixed``: ``search_bench``
with swin_tiny as the default model (its Swin defaults follow from the
model's name); see its docstring.

    python -m p2vit_tpu_torch.tools.search_bench_swin [model] [--val-batches N] [--batch B]
        [--hessian-batches H] [--device cuda]
"""

from __future__ import annotations

from . import search_bench


def main(argv=None) -> dict:
    ap = search_bench.parser()
    ap.set_defaults(model="swin_tiny")
    return search_bench.bench(ap.parse_args(argv))


if __name__ == "__main__":
    main()

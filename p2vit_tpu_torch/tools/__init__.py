"""A/B tools over the weight-store GEMM kernels (counterparts of the JAX
package's ``tools/w4pack_latency.py`` and ``tools/wstream_bench.py``). Run
them on the card as ``python -m p2vit_tpu_torch.tools.<name>``."""

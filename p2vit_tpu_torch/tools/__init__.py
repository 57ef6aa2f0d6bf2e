"""A/B tools over the port's GEMM kernels. Two are counterparts of the JAX
package's ``tools/w4pack_latency.py`` and ``tools/wstream_bench.py``; run
them on the card as ``python -m p2vit_tpu_torch.tools.<name>``.
``requant_bench`` times ``int8_matmul_requant`` (``--junction``:
``int8_matmul_res_ln``) at every serving shape; run it as a script,
``python p2vit_tpu_torch/tools/requant_bench.py --root DIR``, to measure the
checkout at DIR."""

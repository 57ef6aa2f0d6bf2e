"""Roofline share (%) of the int8 GEMMs with a requant epilogue outside the
junctions (ViT: fc1 + GELU, the head; Swin: qkv, proj, fc1 + GELU, the fc2
before patch merging, the reductions, the head) against the device time of
``int8_matmul_requant`` (csrc/gemm_wgmma.cuh), one launch a call."""

from benchmark.readers import roofline

SYMBOL = "requant_kernel<"


def read(ctx):
    return roofline(ctx, "requant_gemm", SYMBOL)

"""Roofline share (%) of ViT attention with its qkv GEMM: the work of every
block's qkv products and both attention products at the cell's batch
(counts.py) against the device time of the kernel that does it, one launch
a block: ``lis_attention_qkv_fused`` (csrc/attention_lis.cu)."""

from benchmark.readers import roofline

SYMBOL = "lis_attention_qkv_kernel"


def read(ctx):
    return roofline(ctx, "qkv_attention", SYMBOL)

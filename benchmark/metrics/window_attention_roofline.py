"""Roofline share (%) of Swin's windowed attention products (q·kᵀ with the
bias and mask, the LIS weights·v) against the device time of
``swin_lis_attention`` (csrc/swin_attention.cu), one launch a block."""

from benchmark.readers import roofline

SYMBOL = "swin_attention_kernel"


def read(ctx):
    return roofline(ctx, "window_attention", SYMBOL)

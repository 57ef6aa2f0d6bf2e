"""Serving kernels: each module holds one hand-written CUDA kernel's wrapper
(``launches`` counts its kernel launches), the kernel's plain PyTorch version
and the constants both share. CPU tensors run the plain version; CUDA
tensors launch the kernel or raise."""

from .attention_lis import lis_attention_qkv_fused
from .embed_fused import fused_patch_embed
from .matmul_int8 import int8_matmul_requant
from .matmul_ln import int8_matmul_res_ln

KERNELS = (fused_patch_embed, lis_attention_qkv_fused, int8_matmul_res_ln, int8_matmul_requant)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}

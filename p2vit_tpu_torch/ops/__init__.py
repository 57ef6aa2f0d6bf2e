"""Serving kernels: each module holds hand-written CUDA kernels' wrappers
(``launches`` counts each kernel's launches; ``profiling.op_span`` records
each call as an ``op.<wrapper>`` span while recording), the kernels' plain PyTorch
versions and the constants both share. CPU tensors run the plain version;
CUDA tensors launch the kernel or raise. The kernels the default serving
paths run also have a ``*_prepared`` entry (and its plain version) that
takes the constants formed once (``serving{,_swin}.prepare``) in place of
the scales: one launch body, recorded and counted as the wrapper's."""

from .attention_lis import (
    lis_attention,
    lis_attention_fused,
    lis_attention_qkv_fused,
    swin_lis_attention,
    swin_lis_attention_folded,
)
from .embed_fused import fused_patch_embed
from .intln import int_ln_requant, int_res_ln_requant
from .layer_fused import fused_vit_layer
from .matmul_int8 import int4_matmul_requant, int8_matmul_requant
from .matmul_ln import int8_matmul_res_ln
from .matmul_wstream import wstream_matmul
from .swin_stem import fused_swin_stem

KERNELS = (fused_patch_embed, lis_attention_qkv_fused, int8_matmul_res_ln, int8_matmul_requant,
           int_ln_requant, int_res_ln_requant, swin_lis_attention, lis_attention_fused,
           lis_attention, fused_swin_stem, swin_lis_attention_folded, fused_vit_layer,
           int4_matmul_requant, wstream_matmul)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}

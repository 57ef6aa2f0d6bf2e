"""One quantized ViT encoder layer in one kernel (counterpart of
``p2vit_tpu/ops/layer_fused.py``).

From the layer's input codes ``h`` (its LN1 output) and the residual
carrier ``xc``: qkv matmul → requant → per-head attention (LIS or the
LIS-off fp32 softmax) → proj + residual junction + LN2 → fc1 + GELU → fc2 +
residual junction + the next LN (the next block's LN1, or the final norm).
Returns the next layer's (h', xc').

The plain version is the four-kernel pipeline's plain versions composed in
the order of the JAX kernel body: ``int8_matmul_requant_plain`` (qkv),
``lis_attention_fused_plain``, ``int8_matmul_res_ln_plain`` (proj + LN2),
``int8_matmul_requant_plain`` (fc1 + GELU), ``int8_matmul_res_ln_plain``
(fc2 + next LN). The JAX package has no jnp twin of this kernel: its
contract is equality with that pipeline.

CUDA kernel (``csrc/layer_fused.cu``) replaces the Pallas kernel
``p2vit_tpu/ops/layer_fused.py:fused_vit_layer`` (``_kernel``): ONE
cooperative launch per layer, three phases over a persistent grid (the qkv
GEMM; attention per (image, head); proj, LN2, fc1, fc2 and the next LN per
32-row tile with the MLP input and the GELU output in shared memory), each
phase running the standalone kernels' own per-tile bodies, so kernel and
plain version agree bit for bit. Bound on the card: the int8 products.
The JAX kernel's ``images_per_step`` (a Mosaic tiling knob that changes no
value) and its VMEM guard belong to the TPU; in their place ``check_fits``
raises where this kernel cannot run: head_dim ≠ 64, N > 256, C or the
hidden width not a multiple of 64, C > 1024, or more than an H100 block's
227 KB of shared memory (of the zoo, DeiT-T and DeiT-S fit; DeiT-B, ViT-B
and ViT-L need 266 KB and more).
"""

from __future__ import annotations

import torch

from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch
from .attention_lis import HEAD_DIM, MAX_N, _check_lis_bits, _vit_scalars, lis_attention_fused_plain
from .matmul_int8 import int8_matmul_requant_plain
from .matmul_ln import MAX_ROW, int8_matmul_res_ln_plain, res_ln_consts

TILE_ROWS = 32  # rows of one phase-C tile
MAX_SMEM = 232_448  # shared memory one H100 block can opt in to


def smem_bytes(n: int, c: int, hid: int) -> int:
    """The kernel's dynamic shared memory, its largest phase: the qkv GEMM's
    stages, the attention's q/k/v rows, or the row tile's GEMM stages, int32
    row buffer, res1, MLP-input and GELU tiles (as ``csrc/layer_fused.cu``)."""
    phase_c = 25_600 + TILE_ROWS * (4 * c + c + (c + 16) + (hid + 16))
    return max(40_960, 3 * n * 68, phase_c)


def check_fits(n: int, c: int, num_heads: int, hid: int) -> None:
    """Raise ValueError, naming ``fuse_layer=False``, unless the CUDA kernel
    runs this geometry (N tokens, width C, hidden width ``hid``)."""
    why = None
    if c != HEAD_DIM * num_heads:
        why = f"head_dim {c / num_heads:g} (the kernel takes {HEAD_DIM})"
    elif n > MAX_N:
        why = f"N = {n} tokens (the kernel takes N <= {MAX_N})"
    elif c % 64 or hid % 64 or c > MAX_ROW:
        why = f"C = {c}, hidden {hid} (the kernel takes multiples of 64, C <= {MAX_ROW})"
    elif smem_bytes(n, c, hid) > MAX_SMEM:
        why = f"{smem_bytes(n, c, hid)} bytes of shared memory (an H100 block has {MAX_SMEM})"
    if why is not None:
        raise ValueError(f"fused_vit_layer kernel cannot run N={n}, C={c}, heads={num_heads}, "
                         f"hidden={hid}: {why}; serve with fuse_layer=False")


def fused_vit_layer_plain(h_q, xc_q, w_qkv, qkv_requant, qkv_bias, num_heads, score_requant,
                          attn_scale, out_requant, w_proj, proj_requant, proj_bias, s_mid,
                          s_res_prev, s_res1, ln2_w, ln2_b, ln2_out, ln2_ratio, w_fc1, fc1_requant,
                          fc1_bias, fc1_out_inv, w_fc2, fc2_requant, fc2_bias, s_mid2, s_res2,
                          lnn_w, lnn_b, lnn_out, lnn_ratio, lis_bits=4, lis=True):
    """Plain PyTorch version of the kernel: the four-kernel pipeline."""
    b, n, c = h_q.shape
    qkv = int8_matmul_requant_plain(h_q.reshape(-1, c), w_qkv, qkv_requant, qkv_bias)
    attn = lis_attention_fused_plain(qkv.reshape(b, n, 3 * c), num_heads, score_requant, attn_scale,
                                     out_requant, lis_bits, lis)
    res1, mlp_in = int8_matmul_res_ln_plain(attn.reshape(-1, c), w_proj, proj_requant, proj_bias,
                                            xc_q.reshape(-1, c), s_mid, s_res_prev, s_res1, ln2_w,
                                            ln2_b, ln2_out, ln2_ratio)
    h1 = int8_matmul_requant_plain(mlp_in, w_fc1, fc1_requant, fc1_bias, out_inv=fc1_out_inv, gelu=True)
    res2, hn = int8_matmul_res_ln_plain(h1, w_fc2, fc2_requant, fc2_bias, res1, s_mid2, s_res1, s_res2,
                                        lnn_w, lnn_b, lnn_out, lnn_ratio)
    return hn.reshape(b, n, c), res2.reshape(b, n, c)


def fused_vit_layer(h_q, xc_q, w_qkv, qkv_requant, qkv_bias, num_heads, score_requant, attn_scale,
                    out_requant, w_proj, proj_requant, proj_bias, s_mid, s_res_prev, s_res1, ln2_w,
                    ln2_b, ln2_out, ln2_ratio, w_fc1, fc1_requant, fc1_bias, fc1_out_inv, w_fc2,
                    fc2_requant, fc2_bias, s_mid2, s_res2, lnn_w, lnn_b, lnn_out, lnn_ratio,
                    lis_bits=4, lis=True, phase_ns=None):
    """One full quantized encoder layer on (B, N, C) int8 codes.

    Args as the JAX ``fused_vit_layer`` (the four-kernel pipeline's, see
    ``serving.stack_layer_consts``):
      h_q: this block's LN1 output codes; xc_q: residual codes at s_res_prev.
      w_qkv (3C, C), qkv_requant/qkv_bias: the qkv epilogue → qact1 codes.
      score_requant/attn_scale/out_requant: as ``lis_attention_fused``.
      w_proj (C, C), proj_requant/proj_bias, s_mid, s_res_prev, s_res1 and
        ln2_*: the proj junction and LN2 (as ``int8_matmul_res_ln``).
      w_fc1 (hid, C), fc1_requant/fc1_bias, fc1_out_inv: fc1 + GELU.
      w_fc2 (C, hid), fc2_requant/fc2_bias, s_mid2, s_res2 and lnn_*: the
        fc2 junction against the res1 codes and the next LN.
    Returns (h'_q, xc'_q), both (B, N, C) int8. CPU tensors take the plain
    version; CUDA tensors launch the kernel (``check_fits``) or raise.
    ``phase_ns``: a (4,) int64 CUDA tensor that receives the %globaltimer
    (ns) at the kernel's start and after its qkv GEMM, attention and row
    phases (a measurement hook; it adds one grid-wide barrier).
    """
    dev = device_of(h_q, xc_q, w_qkv, w_proj, w_fc1, w_fc2)
    if dev.type == "cpu":
        return fused_vit_layer_plain(
            h_q, xc_q, w_qkv, qkv_requant, qkv_bias, num_heads, score_requant, attn_scale,
            out_requant, w_proj, proj_requant, proj_bias, s_mid, s_res_prev, s_res1, ln2_w, ln2_b,
            ln2_out, ln2_ratio, w_fc1, fc1_requant, fc1_bias, fc1_out_inv, w_fc2, fc2_requant,
            fc2_bias, s_mid2, s_res2, lnn_w, lnn_b, lnn_out, lnn_ratio, lis_bits, lis)
    b, n, c = h_q.shape
    hid = w_fc1.shape[0]
    check_cuda_operand(h_q, "h_q", torch.int8)
    check_cuda_operand(xc_q, "xc_q", torch.int8, (b, n, c))
    check_cuda_operand(w_qkv, "w_qkv", torch.int8, (3 * c, c))
    check_cuda_operand(w_proj, "w_proj", torch.int8, (c, c))
    check_cuda_operand(w_fc1, "w_fc1", torch.int8, (hid, c))
    check_cuda_operand(w_fc2, "w_fc2", torch.int8, (c, hid))
    _check_lis_bits(lis, lis_bits)
    check_fits(n, c, num_heads, hid)
    # the JAX kernel's constant packing: the pipeline's own vectors, with the
    # 1e-30 floors on 1/s_res and on both LN out-scales (res_ln_consts)
    pv, s1_ln2 = res_ln_consts(c, dev, proj_requant, proj_bias, s_mid, s_res_prev, s_res1, ln2_w,
                               ln2_b, ln2_out, ln2_ratio)
    f2v, s1_lnn = res_ln_consts(c, dev, fc2_requant, fc2_bias, s_mid2, s_res1, s_res2, lnn_w, lnn_b,
                                lnn_out, lnn_ratio)
    scal = torch.cat([_vit_scalars(score_requant, attn_scale, out_requant, dev),
                      f32_scalars(fc1_out_inv, device=dev), s1_ln2, s1_lnn])
    qv = torch.stack([f32_vec(qkv_requant, 3 * c, dev), f32_vec(qkv_bias, 3 * c, dev)])
    f1v = torch.stack([f32_vec(fc1_requant, hid, dev), f32_vec(fc1_bias, hid, dev)])
    ws = torch.empty(b * n * 4 * c, dtype=torch.int8, device=dev)
    ho = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    xo = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    if phase_ns is not None:
        check_cuda_operand(phase_ns, "phase_ns", torch.int64, (4,))
    launch("p2v_fused_vit_layer", h_q, xc_q, w_qkv, qv, w_proj, pv, w_fc1, f1v, w_fc2, f2v, scal, ws,
           ho, xo, phase_ns, b, n, c, num_heads, hid, int(bool(lis)))
    fused_vit_layer.launches += 1
    return ho, xo


fused_vit_layer.launches = 0

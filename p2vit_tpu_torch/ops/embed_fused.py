"""The whole serving prologue in one kernel (counterpart of
``p2vit_tpu/ops/embed_fused.py``).

From qact_input int8 patch codes to the first encoder block's inputs:

  patch matmul → clip(round(acc·r1 + b1))        patch-qact codes
  → clip(round(·r2))                               qact_embed codes
  → val = ·s_embed + pos_val[p]                    + positional values
  → clip(round(val / s_qact1[c]))                  qact1 codes (PTF divide)
  → [cls_xc; ·] = xc                               the residual carrier
  → ln_mn_chain(xc·mask) → clip(round(·)) = h      block-0 integer LN1

The op chain is the JAX package's staged ``embed_codes`` path, op for op, so
the outputs equal it bit for bit (the LN row sums are exact here).

CUDA kernel (``csrc/embed_fused.cu``) replaces the Pallas kernel
``p2vit_tpu/ops/embed_fused.py:fused_patch_embed`` (``_kernel``). At DeiT-S:
patches (B, 196, 768) × w (384, 768) → xc, h (B, 197, 384). A block owns 32
output token rows with their full width: the [CLS] rows take the constant
codes, the patch rows gather their patch from the (B·196, 768) matrix
inside the ``mma.sync`` tile loads, so no [cls; patches] concatenation is
materialized. Bound on the card: the K = 768 int8 matmul; one launch per
forward. The wrapper zero-pads K to a multiple of 16 and C to a multiple of 8
(``embed_pad``), as the JAX wrapper pads both to 128; the LN counts the
true C. The block's int32 row buffer (rows·C·4 bytes) lies in shared memory
beside the GEMM's two stages (``embed_block``): 32 rows up to C = 1616, 16
rows up to C = 3272. The JAX kernel's own guard is its VMEM estimate
(``_vmem_bytes`` ≤ 14 MiB at one image a step): at the zoo's 197 tokens and
K = 768 (16×16 patches, int8) that is 150,528 + 5,114·C_pad bytes, so it
admits C_pad ≤ 2816 (C ≤ 2816), which the 16-row block serves.
"""

from __future__ import annotations

import torch

from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch, pad_cols
from .intln import ln_codes
from .matmul_int8 import int_matmul_nt

_I8 = (-128, 127)
MAX_SMEM = 232_448  # dynamic shared memory one block may use
_STAGES = {32: 2 * (32 + 128) * 80, 16: 2 * (16 + 128) * 80}  # the GEMM's two stages per block size
MAX_C = (MAX_SMEM - _STAGES[16]) // (16 * 4)  # 3272: the 16-row block's row buffer


def embed_block(c: int) -> tuple:
    """(token rows per block, shared memory) of the kernel at the padded
    width C (``csrc/embed_fused.cu``): 32 rows where their int32 row buffer
    fits beside the GEMM's stages, else 16; raises past ``MAX_C``."""
    for rows in (32, 16):
        smem = _STAGES[rows] + rows * c * 4
        if smem <= MAX_SMEM:
            return rows, smem
    raise ValueError(f"fused_patch_embed kernel needs C <= {MAX_C} (its row buffer in shared memory); "
                     f"got C={c}")


def embed_consts(c, device, patch_requant, patch_bias, s_qact1, ln_mask, ln_w_os,
                 ln_b_os, embed_requant, s_embed, ln_s1):
    """Per-column vectors (6, C) and scalars (3,) shared by kernel and plain."""
    v = lambda a: f32_vec(a, c, device)  # noqa: E731
    vecs = torch.stack([v(patch_requant), v(patch_bias), v(s_qact1), v(ln_mask),
                        v(ln_w_os), v(ln_b_os)])
    scal = f32_scalars(embed_requant, s_embed, ln_s1, device=device)
    return vecs, scal


def embed_codes_plain(patches, w_q, vecs, scal, pos_val, cls_xc, c_true=None):
    """The kernel's chain on its constants (``embed_consts``); the LN counts
    ``c_true`` columns (default C)."""
    b, n_patch, k = patches.shape
    c = w_q.shape[0]
    r1, b1, sq1, mask, w_os, b_os = (row[None, :] for row in vecs)
    r2, s_emb, s1 = scal
    acc = int_matmul_nt(patches.reshape(-1, k), w_q).reshape(b, n_patch, c)
    mid1 = torch.clamp(torch.round(acc.to(torch.float32) * r1 + b1), *_I8)
    mid2 = torch.clamp(torch.round(mid1 * r2), *_I8)
    val = mid2 * s_emb + pos_val.to(torch.float32)[None]
    xcp = torch.clamp(torch.round(val / sq1), *_I8)
    cls_row = cls_xc.to(torch.float32).reshape(1, 1, c).expand(b, 1, c)
    xc = torch.cat([cls_row, xcp], dim=1)
    return xc.to(torch.int8), ln_codes(xc * mask, s1, w_os, b_os, 1.0, c_true=c_true)


def fused_patch_embed_plain(patches, w_q, patch_requant, patch_bias,
                            embed_requant, s_embed, pos_val, cls_xc, s_qact1,
                            ln_mask, ln_s1, ln_w_os, ln_b_os):
    """Plain PyTorch version of the kernel; returns (xc, h)."""
    dev = device_of(patches, w_q)
    vecs, scal = embed_consts(w_q.shape[0], dev, patch_requant, patch_bias, s_qact1, ln_mask,
                              ln_w_os, ln_b_os, embed_requant, s_embed, ln_s1)
    return embed_codes_plain(patches, w_q, vecs, scal, pos_val, cls_xc)


def embed_pad(patches, w_q, vecs, pos, cls):
    """The kernel's operands, zero-padded: K to a multiple of 16 (patches,
    w), C to a multiple of 8 (w rows, the vectors, pos and cls columns).
    The padded columns' codes are zeros (s_qact1 is padded with ones, so the
    PTF divide stays finite) and their mask is zero, so they add nothing to
    the LN row sums; the LN must still count the true C."""
    k, c = patches.shape[-1], w_q.shape[0]
    if k % 16 == 0 and c % 8 == 0:
        return patches, w_q, vecs, pos, cls
    patches = pad_cols(patches, 16)
    w_q = torch.nn.functional.pad(w_q, (0, patches.shape[-1] - k, 0, (-c) % 8))
    sq1 = pad_cols(vecs[2:3], 8, value=1.0)
    vecs = torch.cat([pad_cols(vecs[:2], 8), sq1, pad_cols(vecs[3:], 8)])
    return patches, w_q, vecs, pad_cols(pos, 8), pad_cols(cls, 8)


def fused_patch_embed(patches, w_q, patch_requant, patch_bias, embed_requant,
                      s_embed, pos_val, cls_xc, s_qact1, ln_mask, ln_s1, ln_w_os,
                      ln_b_os):
    """Image patch codes → (xc, h) int8 codes of the first encoder block.

    Args:
      patches: (B, N_patch, K) int8 qact_input codes, extracted after
        quantizing (quantize and extract commute exactly).
      w_q: (C, K) int8 patch weight codes.
      patch_requant/patch_bias: (C,) matmul epilogue onto the patch qact.
      embed_requant: s_patch/s_embed; s_embed; pos_val: (N_patch, C) float32
        positional values of the patch rows; cls_xc: (1, C) int8 [CLS] row.
      s_qact1: (C,) PTF scale (divides). ln_*: block-0 LN1 constants.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (any K, C ≤ 3272, both zero-padded by ``embed_pad``; ``embed_block``) or
    raise.
    """
    dev = device_of(patches, w_q)
    if dev.type == "cpu":
        return fused_patch_embed_plain(patches, w_q, patch_requant, patch_bias,
                                       embed_requant, s_embed, pos_val, cls_xc, s_qact1,
                                       ln_mask, ln_s1, ln_w_os, ln_b_os)
    b, n_patch, k = patches.shape
    c = w_q.shape[0]
    check_cuda_operand(patches, "patches", torch.int8)
    check_cuda_operand(w_q, "w_q", torch.int8, (c, k))
    embed_block(-(-c // 8) * 8)
    pos = pos_val.to(torch.float32).contiguous()
    cls = cls_xc.to(torch.int8).reshape(c).contiguous()
    if tuple(pos.shape) != (n_patch, c) or pos.device != dev or cls.device != dev:
        raise ValueError("pos_val must be (N_patch, C) and cls_xc (1, C), on the patches' device")
    vecs, scal = embed_consts(c, dev, patch_requant, patch_bias, s_qact1, ln_mask,
                              ln_w_os, ln_b_os, embed_requant, s_embed, ln_s1)
    patches, w_q, vecs, pos, cls = embed_pad(patches, w_q, vecs, pos, cls)
    c_pad = w_q.shape[0]
    xc = torch.empty((b, n_patch + 1, c_pad), dtype=torch.int8, device=dev)
    h = torch.empty((b, n_patch + 1, c_pad), dtype=torch.int8, device=dev)
    launch("p2v_fused_patch_embed", patches, w_q, vecs, scal, pos, cls, xc, h,
           b, n_patch, patches.shape[-1], c_pad, c)
    fused_patch_embed.launches += 1
    if c_pad != c:
        return xc[..., :c].contiguous(), h[..., :c].contiguous()
    return xc, h


fused_patch_embed.launches = 0

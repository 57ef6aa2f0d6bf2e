"""The Swin patch stem in one kernel (counterpart of
``p2vit_tpu/ops/swin_stem.py``).

From the float32 patch matrix of the fake-quantized image to the patch-qact
int8 codes:

  h     = patches @ wᵀ + bias        float32; w = w_q·sw, the dequantized
                                     patch weights of the fp stem
  codes = clip(round(h · 1/s_bn))    patch_qact_bn codes (hoisted reciprocal)
  out   = clip(round(LN(codes·mask)))  patch norm → patch_qact codes

The JAX package's twin is ``fused_swin_stem_ref``. The dot here is summed in
one fixed order, k = 0 to K−1, each product and each add rounded on its own,
in the kernel and in the plain version alike, so the two agree bit for bit
on any input. XLA sums in its own order: on calibrated states the products
are int8 codes times power-of-two scales and every partial sum is exact, so
the order does not matter there; on arbitrary float inputs it can move h by
an ulp (the CPU tests state the count). ``1/s_bn`` equals the staged stem's
divide by s_bn when s_bn is a power of two, as the minmax PoT observer
makes it; otherwise the two stems part at rounding edges.

CUDA kernel (``csrc/swin_stem.cu``) replaces the Pallas kernel
``p2vit_tpu/ops/swin_stem.py:fused_swin_stem`` (``_kernel``). At Swin-T
batch 64: (200,704, 48) patches × (96, 48) weights → (200,704, 96) codes, one
launch per forward. Bound on the card: the float32 dot (2·M·C·K
operations), above the 58 MB of patch reads and code writes; the weight and
the five constant vectors live in shared memory, a warp owns a patch row.
"""

from __future__ import annotations

import torch

from ._lib import check_cuda_operand, device_of, f32_vec, launch
from .intln import ln_codes

_I8 = (-128, 127)
MAX_STEM_C = 256  # channel slots per row in the kernel (8 per lane)
MAX_STEM_SMEM = 227 * 1024


def stem_consts(c, device, bias, s_bn, ln_w, ln_b, out_scale):
    """Per-column vectors (5, C) — bias, 1/max(s_bn, 1e-30), the PTF mask
    round(s_bn/s1), w/osc, b/osc with osc = max(out_scale, 1e-30) — and
    s1 = min(s_bn) as (1,), formed as the JAX kernel forms them."""
    v = lambda a: f32_vec(a, c, device)  # noqa: E731
    s_bn_v = v(s_bn)
    s1 = s_bn_v.min()
    osc = torch.clamp(v(out_scale), min=1e-30)
    vecs = torch.stack([
        v(bias), torch.ones_like(s_bn_v) / torch.clamp(s_bn_v, min=1e-30),
        torch.round(s_bn_v / s1), v(ln_w) / osc, v(ln_b) / osc,
    ])
    return vecs, s1.reshape(1)


def fused_swin_stem_plain(patches, w, bias, s_bn, ln_w, ln_b, out_scale):
    """Plain PyTorch version of the kernel: the dot as a loop over k in the
    kernel's order, each product and add rounded on its own."""
    dev = device_of(patches, w)
    m, k = patches.shape
    c = w.shape[0]
    vecs, s1 = stem_consts(c, dev, bias, s_bn, ln_w, ln_b, out_scale)
    bias_v, inv_sbn, mask, w_os, b_os = (row[None, :] for row in vecs)
    px = patches.to(torch.float32)
    wt = w.to(torch.float32).T
    h = torch.zeros((m, c), dtype=torch.float32, device=dev)
    for kk in range(k):
        h = h + px[:, kk:kk + 1] * wt[kk][None, :]
    codes = torch.clamp(torch.round((h + bias_v) * inv_sbn), *_I8)
    return ln_codes(codes * mask, s1[0], w_os, b_os, 1.0)


def fused_swin_stem(patches, w, bias, s_bn, ln_w, ln_b, out_scale):
    """(M, K) float32 patch rows → (M, C) int8 patch-qact codes.

    Args:
      patches: (M, K) float32 patch matrix of the fake-quantized image.
      w: (C, K) float32 dequantized patch weights (w_q·sw).
      bias: (C,) patch-embed bias. s_bn: the patch_qact_bn scale (scalar or
        (C,)). ln_w/ln_b: (C,) patch-norm affine. out_scale: the patch_qact
        scale (scalar or (C,)).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (C ≤ 256, weight and row in shared memory) or raise.
    """
    dev = device_of(patches, w)
    if dev.type == "cpu":
        return fused_swin_stem_plain(patches, w, bias, s_bn, ln_w, ln_b, out_scale)
    m, k = patches.shape
    c = w.shape[0]
    check_cuda_operand(patches, "patches", torch.float32)
    check_cuda_operand(w, "w", torch.float32, (c, k))
    if c > MAX_STEM_C or 4 * (k * c + 5 * c + 8 * k) > MAX_STEM_SMEM:
        raise ValueError(f"fused_swin_stem kernel needs C <= {MAX_STEM_C} and the (C, K) weight "
                         f"in shared memory; got C={c}, K={k}")
    vecs, s1 = stem_consts(c, dev, bias, s_bn, ln_w, ln_b, out_scale)
    out = torch.empty((m, c), dtype=torch.int8, device=dev)
    launch("p2v_fused_swin_stem", patches, w, vecs, s1, out, m, k, c)
    fused_swin_stem.launches += 1
    return out


fused_swin_stem.launches = 0

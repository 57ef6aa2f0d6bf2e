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
launch per forward. Bound on the card: the float32 dot, 2·M·C·K operations
(0.0276 ms at the 67 TFLOP/s FMA peak; 0.0552 ms with the separate
multiply and add the fixed order needs). Design: a persistent grid whose
CTAs take blocks of 64 contiguous patch rows (cp.async, double-buffered);
each thread holds 4 rows × CC channels of h in registers (CC = C_pad/16)
and reads, per k, 4 x values and CC weights from shared memory, so the
FP32 pipe and not the shared-memory pipe sets the pace; the epilogue and
the LN run in registers with exact row sums (``stem_plan``). Past C = 256
a cluster of CS = ⌈C/256⌉ CTAs (at most 16, the H100's largest cluster,
past 8 with the non-portable cluster size, so C ≤ 4096) splits the
channels, each CTA 16·CC of them, and the CTAs add their exact partial row
sums through distributed shared memory before the LN.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..profiling import op_span
from ._lib import check_cuda_operand, device_of, f32_vec, launch, library, pad_cols
from .intln import ln_codes

_I8 = (-128, 127)
MAX_STEM_CLUSTER = 16  # CTAs a cluster splitting C (the H100's largest cluster)
MAX_STEM_C = 256 * MAX_STEM_CLUSTER  # 16 channels a thread, 256 a CTA, at most
MAX_STEM_SMEM = 232_448  # dynamic shared memory one block may use
ROWS = 64  # patch rows a CTA block: 16 row groups of 4
CC_SET = (2, 4, 6, 8, 12, 16)  # channels a thread holds, as the kernel is built


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


@dataclasses.dataclass(frozen=True)
class StemPlan:
    """Launch plan of the stem kernel (``csrc/swin_stem.cu``)."""

    cc: int  # channels a thread holds (4 rows each); a CTA's 16 channel groups cover 16·cc
    c_pad: int  # cs·16·cc
    k_pad: int  # K, padded to a multiple of 4
    blocks: int  # blocks of 64 patch rows
    grid: int  # persistent CTAs: min(blocks, resident clusters) × cs
    smem_bytes: int  # a CTA's
    cs: int = 1  # CTAs a cluster, splitting C: ⌈C/256⌉

    @property
    def loads_per_product(self) -> float:
        """Shared-memory loads a multiply-add pair of the inner loop: per 4 k,
        4 x loads (float4) and 4·cc/G weight loads (G = 4 where 4 divides
        cc, else 2) for 16·cc products."""
        g = 4 if self.cc % 4 == 0 else 2
        return (4 + 4 * self.cc / g) / (16 * self.cc)


def stem_smem(k_pad: int, c_cta: int, cs: int = 1) -> int:
    """A CTA's shared memory: its transposed weight slice (K, c_cta), five
    vectors, two buffers of 64 patch rows (float32), the 64 × c_cta code
    tile and, in a cluster (cs > 1), two buffers of 64 rows' int64 partial
    sums."""
    return 4 * (k_pad * c_cta + 5 * c_cta + 2 * ROWS * k_pad) + ROWS * c_cta + (2 * ROWS * 16 if cs > 1 else 0)


def stem_plan(m: int, k: int, c: int, sms: int = 132, ctas_per_sm: int = 3, clusters: int | None = None) -> StemPlan:
    """The stem kernel's plan at (M, K, C), as the C entry computes it on
    ``sms`` SMs holding ``ctas_per_sm`` CTAs each, or ``clusters``
    resident clusters (``stem_kernel_info`` reads all three on the card):
    cs = ⌈C/256⌉ CTAs a cluster, cc the least of ``CC_SET`` with
    cs·16·cc ≥ C; raises past C = 4096 (a cluster of 16 CTAs) or where a
    CTA's shared memory does not fit."""
    k_pad = -(-k // 4) * 4
    cs = -(-c // 256)
    cc = next((v for v in CC_SET if cs * 16 * v >= c), None) if 1 <= cs <= MAX_STEM_CLUSTER else None
    if c < 1 or cc is None or stem_smem(k_pad, 16 * cc, cs) > MAX_STEM_SMEM:
        raise ValueError(f"fused_swin_stem kernel needs C <= {MAX_STEM_C} (clusters of at most "
                         f"{MAX_STEM_CLUSTER} CTAs of 256 channels) and each CTA's (K, C/CS) weight slice with two "
                         f"blocks of 64 patch rows in shared memory (4·(K·C' + 5·C' + 128·K) + 64·C' <= "
                         f"{MAX_STEM_SMEM} bytes at the padded widths, C' = C/CS); got C={c}, K={k}")
    blocks = -(-m // ROWS)
    resident = clusters if clusters is not None else sms * ctas_per_sm // cs
    return StemPlan(cc, cs * 16 * cc, k_pad, blocks, min(blocks, resident) * cs, stem_smem(k_pad, 16 * cc, cs), cs)


_INFO_KEYS = ("cc", "c_pad", "rows", "blocks", "grid", "smem_bytes", "registers", "spill_bytes", "ctas_per_sm",
              "sms", "cs", "clusters")


def stem_kernel_info(m: int, k: int, c: int) -> dict:
    """The built stem kernel's launch facts at (M, K, C) from the CUDA
    runtime (the plan, registers, spill bytes, CTAs per SM, SMs, CTAs a
    cluster, resident clusters). Needs the card."""
    plan = stem_plan(m, k, c)
    lib, _ = library()
    info = (ctypes.c_int * len(_INFO_KEYS))()
    rc = lib.p2v_fused_swin_stem_info(int(m), plan.k_pad, plan.c_pad, ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_fused_swin_stem_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    return dict(zip(_INFO_KEYS, list(info)))


@op_span
def fused_swin_stem(patches, w, bias, s_bn, ln_w, ln_b, out_scale):
    """(M, K) float32 patch rows → (M, C) int8 patch-qact codes.

    Args:
      patches: (M, K) float32 patch matrix of the fake-quantized image.
      w: (C, K) float32 dequantized patch weights (w_q·sw).
      bias: (C,) patch-embed bias. s_bn: the patch_qact_bn scale (scalar or
        (C,)). ln_w/ln_b: (C,) patch-norm affine. out_scale: the patch_qact
        scale (scalar or (C,)).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (C ≤ 4096, K and C zero-padded to the plan's widths, ``stem_plan``) or
    raise.
    """
    if device_of(patches, w).type == "cpu":
        return fused_swin_stem_plain(patches, w, bias, s_bn, ln_w, ln_b, out_scale)
    out = _stem_launch("p2v_fused_swin_stem", patches, w, bias, s_bn, ln_w, ln_b, out_scale)
    fused_swin_stem.launches += 1
    return out


def _stem_launch(entry, patches, w, bias, s_bn, ln_w, ln_b, out_scale, *extra):
    """Check, pad and launch the C entry ``entry``; returns the (M, C) codes."""
    dev = device_of(patches, w)
    m, k = patches.shape
    c = w.shape[0]
    check_cuda_operand(patches, "patches", torch.float32)
    check_cuda_operand(w, "w", torch.float32, (c, k))
    plan = stem_plan(m, k, c)
    vecs, s1 = stem_consts(c, dev, bias, s_bn, ln_w, ln_b, out_scale)
    if plan.k_pad != k or plan.c_pad != c:
        patches = pad_cols(patches, 4)
        w = torch.nn.functional.pad(w, (0, plan.k_pad - k, 0, plan.c_pad - c))
        vecs = torch.nn.functional.pad(vecs, (0, plan.c_pad - c))
    out = torch.empty((m, plan.c_pad), dtype=torch.int8, device=dev)
    launch(entry, patches, w, vecs, s1, out, m, plan.k_pad, plan.c_pad, c, *extra)
    return out if plan.c_pad == c else out[:, :c].contiguous()


def fused_swin_stem_forced(patches, w, bias, s_bn, ln_w, ln_b, out_scale, grid=0):
    """The kernel launched on ``grid`` clusters of ``plan.cs`` CTAs (CTAs
    where C ≤ 256; 0: the plan's persistent grid; ``plan.blocks``: one block
    a cluster). A measurement hook for CUDA tensors; not counted in
    ``fused_swin_stem.launches``."""
    return _stem_launch("p2v_fused_swin_stem_forced", patches, w, bias, s_bn, ln_w, ln_b, out_scale, grid)


fused_swin_stem.launches = 0

"""The whole serving prologue in one kernel (counterpart of
``p2vit_tpu/ops/embed_fused.py``).

From qact_input int8 patch codes (or float32 patches, quantized first as
clip(round(x / s_input))) to the first encoder block's inputs:

  patch matmul → clip(round(acc·r1 + b1))        patch-qact codes
  → clip(round(·r2))                               qact_embed codes
  → val = ·s_embed + pos_val[p]                    + positional values
  → clip(round(val / s_qact1[c]))                  qact1 codes (PTF divide)
  → [cls_xc; ·] = xc                               the residual carrier
  → ln_mn_chain(xc·mask) → clip(round(·)) = h      block-0 integer LN1

The op chain is the JAX package's staged ``embed_codes`` path, op for op, so
the outputs equal it bit for bit (the LN row sums are exact here).

CUDA kernel (``csrc/embed_fused.cu`` over ``csrc/gemm_wgmma.cuh``) replaces
the Pallas kernel ``p2vit_tpu/ops/embed_fused.py:fused_patch_embed``
(``_kernel``). At DeiT-S: patches (B, 196, 768) × w (384, 768) → xc, h
(B, 197, 384), one launch per forward. Bound on the card: the bytes (5.9 µs
at batch 64); the kernel is bound by its per-element epilogue and LN chain.
Design (Hopper, the junction kernel's, ``ops/matmul_ln.py``): the GEMM runs
over the contiguous (B·196, 768) patch matrix; a persistent grid of
clusters of up to four CTAs takes row blocks of 64·NC patch rows, each CTA
a part of C; a producer thread TMA-loads the patch and weight rows into a
ring and NC consumer warpgroups run ``wgmma`` on it; the epilogue runs on
the accumulators into a code tile with exact integer row sums, the LN pass
reads the tile and stores both outputs. Patch row m is token row
m + ⌊m/196⌋ + 1 (``token_row``); the [CLS] rows, the same in every image,
are computed once per CTA. ``embed_plan`` gives the plan as the C entry
computes it. The float32 arm converts its patch rows to codes in the
kernel, in the swizzled layout the ``wgmma`` reads (no TMA).

The wrapper zero-pads K and C to multiples of 16 (``embed_pad``), as the
JAX wrapper pads both to 128; the LN counts the true C. It serves C ≤ 3272
(``MAX_C``, a cluster splitting the row where one CTA's code tile does not
fit); the JAX kernel's own guard is its VMEM estimate (``_vmem_bytes`` ≤ 14
MiB at one image a step): at the zoo's 197 tokens and K = 768 (16×16
patches, int8) that is 150,528 + 5,114·C_pad bytes, so it admits
C_pad ≤ 2816 (C ≤ 2816).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from ..profiling import count, op_span
from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch, library, pad_cols
from .intln import ln_codes
from .matmul_int8 import MAX_SMEM, TILE_K, TILE_M, _sm_count, int_matmul_nt
from .matmul_ln import MAX_CLUSTER, MAX_CONSUMERS, code_ld, whole_row_plan

_I8 = (-128, 127)
MAX_C = 3272  # the widest row the kernel serves (JAX admits C ≤ 2816 at 197 tokens)
ALIGN = 16  # the wrapper's zero padding of K (whole 16-byte loads) and C (16-byte stores)
# chunk widths: the requant GEMM's but 256, whose accumulators leave no room
# for a chunk's positional values, loaded before its products
WIDTHS = (192, 144, 128, 96)


class EmbedConsts(NamedTuple):
    """The kernel's constants. Prepared (``embed_prepared``): C padded to a
    multiple of ``ALIGN``, s_qact1 with ones, the rest with zeros."""

    vecs: torch.Tensor  # (6, C) float32: ``embed_consts``' vectors
    scal: torch.Tensor  # (3,) float32: ``embed_consts``' scalars
    pos: torch.Tensor  # (N_patch, C) float32 positional values of the patch rows
    cls: torch.Tensor  # (C,) int8 [CLS] row


def embed_consts(c, device, patch_requant, patch_bias, s_qact1, ln_mask, ln_w_os,
                 ln_b_os, embed_requant, s_embed, ln_s1):
    """Per-column vectors (6, C) and scalars (3,) shared by kernel and plain."""
    count("consts_formed")
    v = lambda a: f32_vec(a, c, device)  # noqa: E731
    vecs = torch.stack([v(patch_requant), v(patch_bias), v(s_qact1), v(ln_mask),
                        v(ln_w_os), v(ln_b_os)])
    scal = f32_scalars(embed_requant, s_embed, ln_s1, device=device)
    return vecs, scal


def input_codes_plain(patches, s_input):
    """int8 patches as they are; float32 patches → clip(round(x / s_input))
    as int8, a true divide by a float32 tensor (JAX's in-kernel quantize)."""
    if patches.dtype == torch.int8:
        return patches
    if s_input is None:
        raise ValueError("fused_patch_embed: float32 patches need s_input")
    s_in = torch.as_tensor(s_input, dtype=torch.float32, device=patches.device).reshape(())
    return torch.clamp(torch.round(patches.to(torch.float32) / s_in), *_I8).to(torch.int8)


def embed_codes_plain(patches, w_q, vecs, scal, pos_val, cls_xc, c_true=None, s_input=None):
    """The kernel's chain on its constants (``embed_consts``); the LN counts
    ``c_true`` columns (default C); float32 patches are quantized by
    ``s_input`` first."""
    patches = input_codes_plain(patches, s_input)
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
                            ln_mask, ln_s1, ln_w_os, ln_b_os, *, s_input=None):
    """Plain PyTorch version of the kernel; returns (xc, h)."""
    dev = device_of(patches, w_q)
    vecs, scal = embed_consts(w_q.shape[0], dev, patch_requant, patch_bias, s_qact1, ln_mask,
                              ln_w_os, ln_b_os, embed_requant, s_embed, ln_s1)
    return embed_codes_plain(patches, w_q, vecs, scal, pos_val, cls_xc, s_input=s_input)


def fused_patch_embed_prepared_plain(patches, w_q, consts, *, s_input=None):
    """Plain version of ``fused_patch_embed_prepared``; returns (xc, h)."""
    c = w_q.shape[0]
    vecs, scal, pos, cls = consts
    return embed_codes_plain(patches, w_q, vecs[:, :c], scal, pos[:, :c], cls[:c], s_input=s_input)


def _pad_consts(vecs, pos, cls):
    """vecs, pos and cls with C padded to a multiple of ``ALIGN`` (s_qact1
    with ones, the rest with zeros); themselves where C needs none."""
    if vecs.shape[1] % ALIGN == 0:
        return vecs, pos, cls
    sq1 = pad_cols(vecs[2:3], ALIGN, value=1.0)
    vecs = torch.cat([pad_cols(vecs[:2], ALIGN), sq1, pad_cols(vecs[3:], ALIGN)])
    return vecs, pad_cols(pos, ALIGN), pad_cols(cls, ALIGN)


def embed_pad(patches, w_q, vecs, pos, cls):
    """The kernel's operands, zero-padded: K to a multiple of 16 (patches,
    int8 or float32, and w), C to a multiple of 16 (w rows, the vectors, pos
    and cls columns; already padded ones stay as they are). The padded
    columns' codes are zeros (s_qact1 is padded with ones, so the PTF divide
    stays finite) and their mask is zero, so they add nothing to the LN row
    sums; the LN must still count the true C."""
    k, c = patches.shape[-1], w_q.shape[0]
    if k % ALIGN == 0 and c % ALIGN == 0:
        return patches, w_q, vecs, pos, cls
    patches = pad_cols(patches, ALIGN)
    w_q = torch.nn.functional.pad(w_q, (0, patches.shape[-1] - k, 0, (-c) % ALIGN))
    return (patches, w_q, *_pad_consts(vecs, pos, cls))


def embed_kernel_consts(c, device, patch_requant, patch_bias, embed_requant, s_embed, pos_val, cls_xc, s_qact1,
                        ln_mask, ln_s1, ln_w_os, ln_b_os) -> EmbedConsts:
    """Everything the kernel reads but the patches and weights, at C, from
    ``fused_patch_embed``'s constant arguments."""
    vecs, scal = embed_consts(c, device, patch_requant, patch_bias, s_qact1, ln_mask, ln_w_os, ln_b_os,
                              embed_requant, s_embed, ln_s1)
    return EmbedConsts(vecs, scal, pos_val.to(torch.float32).contiguous(),
                       cls_xc.to(torch.int8).reshape(c).contiguous())


def embed_prepared(c, device, **consts) -> EmbedConsts:
    """``embed_kernel_consts`` padded (``embed_pad``) and 16-byte aligned:
    what ``fused_patch_embed_prepared`` reads, formed once per serving
    state. ``consts``: ``fused_patch_embed``'s constant arguments by name."""
    vecs, scal, pos, cls = embed_kernel_consts(c, device, **consts)
    vecs, pos, cls = _pad_consts(vecs, pos, cls)
    return EmbedConsts(vecs, scal, *(t if t.data_ptr() % 16 == 0 else t.clone() for t in (pos, cls)))


def token_row(m, n_patch: int):
    """The output token row of patch row ``m`` of the (B·NP, K) patch matrix:
    m + ⌊m/NP⌋ + 1 (row 0 of each image is its [CLS] row)."""
    return m + m // n_patch + 1


# ---------------------------------------------------------------------------
# The Hopper kernel's plan (csrc/embed_fused.cu, p2v::wg::EmbedPlan)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EmbedPlan:
    """Launch plan of the embed kernel at the padded width."""

    bn: int  # chunk width
    cpc: int  # chunks per CTA
    cs: int  # CTAs per cluster; CTA r of a cluster takes columns [r·cpc·bn, (r + 1)·cpc·bn)
    nc: int  # consumer warpgroups per CTA, 64 patch rows each (128·(nc + 1) threads)
    stages: int  # ring stages of (64·nc + bn)·128 bytes
    blocks: int  # row blocks of 64·nc patch rows
    grid: int  # persistent CTAs: min(blocks, resident clusters) clusters of cs
    smem_bytes: int
    c_pad: int  # C the kernel sees (multiple of 16)
    k_pad: int  # K the kernel sees (multiple of 16)

    @property
    def rows(self) -> int:
        return TILE_M * self.nc

    @property
    def cols(self) -> int:
        """Columns of one CTA."""
        return self.cpc * self.bn


def embed_smem(bn: int, cpc: int, nc: int, stages: int, cs: int) -> int:
    """Alignment slack, the ring, nc code tiles of 64 rows, the six vectors
    and the divisors' reciprocals over the CTA's columns, 8 bytes of row
    constants a row, a full and an empty barrier per stage and, in clusters
    of cs > 1, two row-sum barriers and two 16-byte partial row sums a row."""
    nw = bn * cpc
    return (1024 + stages * (TILE_M * nc + bn) * TILE_K + nc * TILE_M * code_ld(nw) + 7 * nw * 4
            + nc * TILE_M * 8 + 16 * stages + (16 + 2 * nc * TILE_M * 16 if cs > 1 else 0))


@functools.lru_cache(maxsize=256)
def embed_plan(m: int, c: int, k: int, sms: int, resident: tuple | None = None, cs: int = 0,
               nc: int = 0) -> EmbedPlan:
    """The embed kernel's plan at M = B·NP patch rows and width C, as the C
    entry computes it at the padded widths: the junction kernel's rule
    (``matmul_ln.whole_row_plan``) over this kernel's shared memory and
    chunk widths ``WIDTHS`` (384 → 2 × 192, 768 → 4 × 192, 1024 → 8 × 128);
    raises where the kernel does not run (C < 1 or C > ``MAX_C``; K ≤ 0; M
    outside the int32 coordinates). ``resident[s - 1]``: the clusters of s
    CTAs the card holds at once (``embed_kernel_info(...)["resident"]``;
    default ⌊sms/s⌋; the H100 holds 132, 66, 39 and 30). ``cs``, ``nc`` > 0
    restrict the choice (``fused_patch_embed_forced``)."""
    if not 1 <= c <= MAX_C:
        raise ValueError(f"fused_patch_embed kernel needs C <= {MAX_C} (whole rows of codes over a cluster of "
                         f"at most {MAX_CLUSTER} CTAs; JAX admits C <= 2816 at 197 tokens), got C={c}")
    if k <= 0:
        raise ValueError(f"fused_patch_embed kernel needs K > 0, got K={k}")
    if not 0 <= m < 2 ** 31:
        raise ValueError(f"fused_patch_embed kernel needs 0 <= B·NP < 2^31, got {m}")
    resident = resident or tuple(sms // s for s in range(1, MAX_CLUSTER + 1))
    c_pad, k_pad = -(-c // ALIGN) * ALIGN, -(-k // ALIGN) * ALIGN
    p = whole_row_plan(m, c_pad, WIDTHS, embed_smem, resident, cs, nc)
    if p is None:
        raise ValueError(f"fused_patch_embed kernel: no plan fits C={c} (cs={cs}, nc={nc})")
    bn, cpc, s, q, stages, blocks, grid = p
    return EmbedPlan(bn, cpc, s, q, stages, blocks, grid, embed_smem(bn, cpc, q, stages, s), c_pad, k_pad)


_INFO_KEYS = ("bn", "cpc", "cs", "nc", "stages", "blocks", "grid", "smem_bytes", "registers", "spill_bytes",
              "consumer_registers", "ctas_per_sm", "sms")


def embed_kernel_info(m: int, c: int, cs: int = 0, nc: int = 0) -> dict:
    """The built embed kernel's launch facts at M = B·NP patch rows and width
    C from the CUDA runtime: the plan (``cs``, ``nc`` as ``embed_plan``),
    registers and spill bytes per thread, a consumer's registers after
    ``setmaxnreg``, CTAs per SM, SMs, and ``resident``, the clusters of 1 to
    4 CTAs the card holds at once. Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * 17)()
    c_pad = -(-c // ALIGN) * ALIGN
    rc = lib.p2v_fused_patch_embed_info(int(m), c_pad, int(cs), int(nc), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_fused_patch_embed_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    out = dict(zip(_INFO_KEYS, list(info)))
    out["resident"] = tuple(info[13:17])
    return out


def embed_div_check(divisors: torch.Tensor) -> tuple:
    """The kernel's PTF divide (a staged reciprocal and one Markstein
    correction) against ``__fdiv_rn`` over all 2^32 float32 dividends, for
    each divisor in ``divisors`` (a CUDA tensor, each in [2^-64, 2^64]):
    (quotients in [1/4, 1024) in magnitude, where a code can depend on
    their last bit, that differ; codes that differ). Needs the card; both
    must be 0."""
    d = divisors.to(torch.float32).contiguous()
    if not bool(((d.abs() >= 2.0 ** -64) & (d.abs() <= 2.0 ** 64)).all()):
        raise ValueError("embed_div_check: divisors must lie in [2^-64, 2^64] in magnitude")
    bad = torch.zeros(2, dtype=torch.int64, device=d.device)
    launch("p2v_embed_div_check", d, d.numel(), bad)
    torch.cuda.synchronize(d.device)
    return tuple(int(v) for v in bad.tolist())


def _embed_launch(entry, patches, w_q, consts, s_input, *extra):
    """Check, pad and launch the C entry ``entry`` on the constants
    ``consts`` (at C, or prepared); returns (xc, h)."""
    dev = device_of(patches, w_q)
    b, n_patch, k = patches.shape
    c = w_q.shape[0]
    f32 = patches.dtype == torch.float32
    check_cuda_operand(patches, "patches", torch.float32 if f32 else torch.int8)
    check_cuda_operand(w_q, "w_q", torch.int8, (c, k))
    embed_plan(b * n_patch, c, k, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))
    if f32 and s_input is None:
        raise ValueError("fused_patch_embed: float32 patches need s_input")
    vecs, scal, pos, cls = consts
    patches, w_q, vecs, pos, cls = embed_pad(patches, w_q, vecs, pos, cls)
    c_pad = w_q.shape[0]
    if tuple(pos.shape) != (n_patch, c_pad) or tuple(cls.shape) != (c_pad,) or pos.device != dev or cls.device != dev:
        raise ValueError("pos_val must be (N_patch, C) and cls_xc (1, C), on the patches' device")
    pos, cls = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (pos, cls))  # 16-byte loads
    check_cuda_operand(vecs, "vecs", torch.float32, (6, c_pad))
    check_cuda_operand(scal, "scal", torch.float32, (3,))
    s_in = f32_scalars(s_input, device=dev) if f32 else None
    xc = torch.empty((b, n_patch + 1, c_pad), dtype=torch.int8, device=dev)
    h = torch.empty((b, n_patch + 1, c_pad), dtype=torch.int8, device=dev)
    launch(entry, None if f32 else patches, patches if f32 else None, s_in, w_q, vecs, scal, pos, cls, xc, h,
           b, n_patch, patches.shape[-1], c_pad, c, *extra)
    if c_pad != c:
        return xc[..., :c].contiguous(), h[..., :c].contiguous()
    return xc, h


EMBED_PHASES = ("start", "chunk 0 products", "chunk 0 epilogue", "chunk 1 products", "chunk 1 epilogue",
                "chunk 2 products", "chunk 2 epilogue", "chunk 3 products", "chunk 3 epilogue", "chunk 4 products",
                "chunk 4 epilogue", "chunk 5 products", "chunk 5 epilogue", "row constants", "LN pass", "end")


def fused_patch_embed_forced(patches, w_q, patch_requant, patch_bias, embed_requant, s_embed, pos_val, cls_xc,
                             s_qact1, ln_mask, ln_s1, ln_w_os, ln_b_os, *, s_input=None, cs=0, nc=0, phase_ns=None):
    """The kernel launched on the plan restricted to clusters of ``cs`` CTAs
    and ``nc`` consumers (0: free; raises where that plan does not fit);
    ``phase_ns``: a (16,) int64 CUDA tensor that receives the
    %globaltimer of one CTA's consumer at ``EMBED_PHASES`` (its first row
    block's chunks and passes; zeros where a slot is not reached). A
    measurement hook for CUDA tensors; not counted in
    ``fused_patch_embed.launches``."""
    if phase_ns is not None:
        check_cuda_operand(phase_ns, "phase_ns", torch.int64, (len(EMBED_PHASES),))
    consts = embed_kernel_consts(w_q.shape[0], patches.device, patch_requant, patch_bias, embed_requant, s_embed,
                                 pos_val, cls_xc, s_qact1, ln_mask, ln_s1, ln_w_os, ln_b_os)
    return _embed_launch("p2v_fused_patch_embed_forced", patches, w_q, consts, s_input, cs, nc, phase_ns)


@op_span
def fused_patch_embed(patches, w_q, patch_requant, patch_bias, embed_requant,
                      s_embed, pos_val, cls_xc, s_qact1, ln_mask, ln_s1, ln_w_os,
                      ln_b_os, *, s_input=None):
    """Image patches → (xc, h) int8 codes of the first encoder block.

    Args:
      patches: (B, N_patch, K) int8 qact_input codes, extracted after
        quantizing (quantize and extract commute exactly; the serving
        path's form), or float32 patches, quantized in the kernel as
        clip(round(x / s_input)).
      w_q: (C, K) int8 patch weight codes.
      patch_requant/patch_bias: (C,) matmul epilogue onto the patch qact.
      embed_requant: s_patch/s_embed; s_embed; pos_val: (N_patch, C) float32
        positional values of the patch rows; cls_xc: (1, C) int8 [CLS] row.
      s_qact1: (C,) PTF scale (divides). ln_*: block-0 LN1 constants.
      s_input: the qact_input scale, JAX's third argument (keyword here, so
        that positional callers keep their order); read only for float32
        patches, which need it.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (any K, C ≤ 3272, both zero-padded by ``embed_pad``; ``embed_plan``) or
    raise.
    """
    if device_of(patches, w_q).type == "cpu":
        return fused_patch_embed_plain(patches, w_q, patch_requant, patch_bias,
                                       embed_requant, s_embed, pos_val, cls_xc, s_qact1,
                                       ln_mask, ln_s1, ln_w_os, ln_b_os, s_input=s_input)
    consts = embed_kernel_consts(w_q.shape[0], patches.device, patch_requant, patch_bias, embed_requant, s_embed,
                                 pos_val, cls_xc, s_qact1, ln_mask, ln_s1, ln_w_os, ln_b_os)
    out = _embed_launch("p2v_fused_patch_embed", patches, w_q, consts, s_input)
    fused_patch_embed.launches += 1
    return out


fused_patch_embed.launches = 0


@op_span(of=fused_patch_embed)
def fused_patch_embed_prepared(patches, w_q, consts, *, s_input=None):
    """``fused_patch_embed`` on its constants formed beforehand
    (``embed_prepared``): the serving forward's entry, which forms nothing
    per call. CPU tensors take ``fused_patch_embed_prepared_plain``; CUDA
    tensors launch the kernel (counted in ``fused_patch_embed.launches``) or
    raise."""
    if device_of(patches, w_q).type == "cpu":
        return fused_patch_embed_prepared_plain(patches, w_q, consts, s_input=s_input)
    out = _embed_launch("p2v_fused_patch_embed", patches, w_q, consts, s_input)
    fused_patch_embed.launches += 1
    return out

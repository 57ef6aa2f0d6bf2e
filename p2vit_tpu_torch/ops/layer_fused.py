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
cooperative launch per layer, one 384-thread CTA per SM (three warpgroups,
each feeding its own two-stage TMA ring), three phases over a persistent
grid: the qkv GEMM in 64 × 64 tiles on int8 ``wgmma``; attention per
(image, head) on the per-item body of ``lis_attention_fused`` (int8
``mma.sync``), the next item prefetched; proj, LN2, fc1, fc2 and the next LN
per block of 64 or 32 whole rows (``block_split``), the products on ``wgmma``
in 64-column chunks dealt to the warpgroups in turn, the MLP input and the
GELU output in shared memory. Each epilogue runs the
standalone kernels' own device functions, so kernel and plain version agree
bit for bit. ``layer_plan`` mirrors the launch. The JAX kernel's
``images_per_step`` (a Mosaic tiling knob that changes no value) and its
VMEM guard belong to the TPU; in their place ``check_fits`` raises where
this kernel cannot run: a head_dim JAX's assert refuses (other than 1, 2,
4, 8, 16, 32, 64 or 128), or more than an H100 block's 227 KB of shared
memory (of the zoo, DeiT-T and DeiT-S fit; DeiT-B, ViT-B and ViT-L need
more, as they need more than JAX's VMEM budget). A width C or hidden width
that is no multiple of the kernel's 64-column chunks is zero-padded by the
wrapper (``layer_pad``): zero weights and vectors give the padded columns
zero codes, the LNs count the true C (the kernel's ``c_true``) and the
outputs are written C columns wide; ``fused_vit_layer_padded_plain`` is
that route's plain form. Past 256 tokens the attention rows run in the
wide forms (``attention_lis``), so N is bounded by shared memory alone.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..profiling import op_span
from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch, library
from .attention_lis import (FUSED_HEAD_DIMS, _check_lis_bits, _vit_scalars, lis_attention_fused_plain, pad_hd,
                            vit_attention_gc, vit_attention_layout)
from .matmul_int8 import int8_matmul_requant_plain, int_matmul_nt
from .matmul_ln import code_ld, int8_matmul_res_ln_plain, res_ln_consts, res_ln_epilogue_plain

MAX_SMEM = 232_448  # shared memory one H100 block can opt in to
THREADS = 384  # three warpgroups, every one a consumer with its own TMA ring
WARPGROUPS = 3
BLOCK_ROWS = 64  # rows of one phase-C block and of a wgmma tile
CHUNK = 64  # output columns of every product's chunk (wgmma m64n64k32)
RING = 2  # stages of a warpgroup's ring, 128 K bytes each
STAGE_A = (BLOCK_ROWS + CHUNK) * 128  # phase A: 64 h rows and 64 weight rows
STAGE_C = CHUNK * 128  # phase C: 64 weight rows
GELU_LD = 32 + 4  # ints per row of a warpgroup's GELU staging tile (half a chunk)
BAR_BYTES = 8 * (2 * WARPGROUPS * RING + 1)


@dataclasses.dataclass(frozen=True)
class LayerPlan:
    """The fused layer's launch (``csrc/layer_fused.cu`` ``layout`` and
    ``plan``): one CTA of ``threads`` per SM, ``grid`` CTAs walking each
    phase's work grid-stride: ``tiles`` 64 × 64 qkv tiles (A, each
    warpgroup its own share), ``items`` (image, head) attention items (B),
    ``blocks`` blocks of rows (C: ``blocks_64`` of 64 rows, then 32-row
    blocks over the rest; their ``chunks`` 64-column chunks dealt to the
    three warpgroups in turn)."""

    threads: int
    grid: int
    smem_bytes: int  # dynamic shared memory: the largest phase, barriers and 1 KB of alignment slack
    smem_a: int  # each phase's bytes, with the slack
    smem_b: int
    smem_c: int
    gc: int  # attention query groups a chunk
    hdp: int  # head_dim padded to 32, 64 or 128
    tiles: int
    items: int
    blocks: int
    chunks: int  # phase C's 64-column chunks a block: proj, fc1, fc2
    blocks_64: int  # phase C's blocks of 64 rows (the rest: 32-row blocks)
    ring: int = RING
    c_pad: int = 0  # C and the hidden width as the kernel runs them: multiples of 64
    hid_pad: int = 0


def swizzle_offset(row: int, col: int) -> int:
    """The byte of (row, col) in a 64-row shared-memory tile of 128-byte
    K-blocks (8 KB each) in the 128-byte swizzle that TMA writes and the
    wgmma descriptors read: 16-byte chunk j of row r at chunk j ^ (r mod 8)
    (``csrc/layer_fused.cu`` ``swz``; the MLP-input and GELU tiles)."""
    return (col >> 7) * BLOCK_ROWS * 128 + row * 128 + ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15)


def pad64(w: int) -> int:
    """A width padded to the kernel's 64-column chunks."""
    return -(-w // CHUNK) * CHUNK


def layer_layout(n: int, c: int, heads: int, hid: int, lis: bool = True, gc: int = 0) -> dict:
    """Byte offsets of the kernel's shared memory (``layout``) at the true
    widths C and ``hid``, run padded to multiples of 64: phase A's
    three rings (two stages of 64 h rows and 64 weight rows) from 0 and the
    warpgroups' output tiles after them; phase C's three rings (two stages
    of 64 weight rows) from 0, then the GELU tile (which holds the block's
    attention rows during proj), the MLP-input tile (64-row tiles of
    128-byte K-blocks), the res1 tile, the staging, row-sum and row-constant
    buffers; phase B's item layout from 0 (two stages); the barriers after
    the largest."""
    hd = c // heads
    c, hid = pad64(c), pad64(hid)
    tile = BLOCK_ROWS * 128
    lay = dict(ot=WARPGROUPS * RING * STAGE_A)
    lay["end_a"] = lay["ot"] + WARPGROUPS * BLOCK_ROWS * (CHUNK + 16)
    lay["gelu"] = WARPGROUPS * RING * STAGE_C
    lay["mlp"] = lay["gelu"] + tile * -(-max(hid, c) // 128)
    lay["res1"] = lay["mlp"] + tile * -(-c // 128)
    lay["gst"] = lay["res1"] + BLOCK_ROWS * code_ld(c)
    lay["part"] = lay["gst"] + WARPGROUPS * BLOCK_ROWS * GELU_LD * 4
    lay["lnr"] = lay["part"] + WARPGROUPS * BLOCK_ROWS * 16
    lay["end_c"] = lay["lnr"] + BLOCK_ROWS * 8
    lay["gc"] = vit_attention_gc(n, hd, lis, 2, MAX_SMEM - 1024 - BAR_BYTES, gc)
    lay["end_b"] = vit_attention_layout(n, hd, lis, 2, lay["gc"])["total"]
    lay["hdp"] = pad_hd(hd)
    lay["bar"] = -(-max(lay["end_a"], lay["end_b"], lay["end_c"]) // 8) * 8
    lay["smem"] = 1024 + lay["bar"] + BAR_BYTES
    return lay


def smem_bytes(n: int, c: int, hid: int, num_heads: int | None = None, lis: bool = True) -> int:
    """The kernel's dynamic shared memory (``layer_layout``), its largest
    phase; head_dim 64 unless ``num_heads`` is given."""
    return layer_layout(n, c, num_heads or max(1, c // 64), hid, lis)["smem"]


def check_fits(n: int, c: int, num_heads: int, hid: int) -> None:
    """Raise ValueError, naming ``fuse_layer=False``, unless the CUDA kernel
    runs this geometry (N tokens, width C, hidden width ``hid``): a head_dim
    JAX's assert admits, up to 128, and the shared memory of one block (the
    widths padded to 64, N's attention item with two stages)."""
    why = None
    if c % num_heads or c // num_heads not in FUSED_HEAD_DIMS:
        why = f"head_dim {c / num_heads:g} (the kernel takes {', '.join(map(str, FUSED_HEAD_DIMS))})"
    elif n < 1 or hid < 1:
        why = f"N = {n}, hidden {hid}"
    elif max(smem_bytes(n, c, hid, num_heads, lis) for lis in (True, False)) > MAX_SMEM:
        why = (f"{max(smem_bytes(n, c, hid, num_heads, lis) for lis in (True, False))} bytes of shared memory "
               f"at N = {n} tokens, head_dim {c // num_heads}, C = {c} and hidden {hid} run at the multiples of 64 "
               f"{pad64(c)} and {pad64(hid)} (an H100 block has {MAX_SMEM})")
    if why is not None:
        raise ValueError(f"fused_vit_layer kernel cannot run N={n}, C={c}, heads={num_heads}, "
                         f"hidden={hid}: {why}; serve with fuse_layer=False")


def block_split(m: int, grid: int, br: int = 0) -> int:
    """Phase C's blocks of 64 rows (``csrc/layer_fused.cu``
    ``block_split``): rounds of 64-row blocks over the grid, then 32-row
    blocks over the rest, each at about 3/4 of a 64-row block's time
    (measured); the number of 64-row rounds whose blocks end soonest, the
    fewest 64-row blocks on a tie. ``br`` 64 (all) or 32 (none) forces it."""
    nb64 = -(-m // 64)
    if br:
        return nb64 if br == 64 else 0
    best, best_t = 0, None
    for f in range(-(-nb64 // grid) + 1):
        n64 = min(nb64, f * grid)
        n32 = -(-max(0, m - 64 * n64) // 32)
        t = 4 * -(-n64 // grid) + 3 * -(-n32 // grid)
        if best_t is None or t < best_t:
            best, best_t = n64, t
    return best


def layer_plan(b: int, n: int, c: int, heads: int, hid: int, lis: bool = True, sms: int = 132,
               grid: int = 0, gc: int = 0, br: int = 0) -> LayerPlan:
    """The kernel's plan at batch ``b`` on ``sms`` SMs (one CTA each):
    grid = min(SMs, the largest phase's work: the qkv tiles or the
    attention items), phase C's ``block_split``; ``grid`` > 0 (at most
    ``sms``), ``gc`` > 0 (the attention's query groups a chunk) and ``br``
    (32 or 64 rows for every block) force theirs (measurement hooks).
    Raises where ``check_fits`` does."""
    check_fits(n, c, heads, hid)
    if br not in (0, 32, 64):
        raise ValueError(f"phase C takes blocks of 32 or 64 rows; got {br}")
    lay = layer_layout(n, c, heads, hid, lis, gc)
    m = b * n
    c, hid = pad64(c), pad64(hid)
    tiles = -(-m // BLOCK_ROWS) * (3 * c // CHUNK)
    items = b * heads
    g = grid if grid > 0 else min(sms, max(tiles, items))
    if g > sms:
        raise ValueError(f"a cooperative launch of {g} CTAs of {lay['smem']} B needs {g} SMs; the card has {sms}")
    n64 = block_split(m, g, br)
    blocks = n64 + -(-max(0, m - 64 * n64) // 32)
    return LayerPlan(THREADS, g, lay["smem"], 1024 + lay["end_a"], 1024 + lay["end_b"], 1024 + lay["end_c"],
                     lay["gc"], lay["hdp"], tiles, items, blocks, 2 * (c // CHUNK) + hid // CHUNK, n64,
                     c_pad=c, hid_pad=hid)


def layer_kernel_info(b: int, n: int, c: int, heads: int, hid: int, lis: bool = True, grid: int = 0,
                      gc: int = 0, br: int = 0) -> dict:
    """The built kernel's launch facts, from the CUDA runtime (``plan``):
    threads, grid, shared memory (and per phase), groups a chunk, padded
    head_dim, registers and spill bytes per thread, CTAs per SM, SMs, stages
    of a warpgroup's ring, chunk width, phase C's 64-row blocks and all its
    blocks. Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * 16)()
    rc = lib.p2v_fused_vit_layer_info(int(b), int(n), pad64(c), int(c), int(heads), pad64(hid), int(bool(lis)),
                                      int(grid), int(gc), int(br), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_fused_vit_layer_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    keys = ("threads", "grid", "smem_bytes", "smem_a", "smem_b", "smem_c", "gc", "hdp", "registers",
            "spill_bytes", "ctas_per_sm", "sms", "ring", "chunk", "blocks_64", "blocks")
    return dict(zip(keys, list(info)))


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


def layer_pad(c: int, hid: int, h_q, xc_q, w_qkv, qv, w_proj, pv, w_fc1, f1v, w_fc2, f2v):
    """The kernel's operands at the padded widths cp = ``pad64(C)`` and
    hp = ``pad64(hid)``: h and xc (B, N, cp); the qkv weight (3cp, cp) and
    its vectors qv (2, 3cp) with q, k and v each in the first C rows of
    their cp-row part; proj (cp, cp), fc1 (hp, cp), fc2 (cp, hp); the
    junction vectors pv, f2v (9, cp) and fc1's f1v (2, hp); zeros
    everywhere else. A zero weight row with zero vectors gives the padded
    column the code 0 at every epilogue, so it adds nothing to Σx or Σx²
    and, times the next product's zero weight column, nothing to its sum.
    The operands themselves where C and hid are multiples of 64."""
    cp, hp = pad64(c), pad64(hid)
    if (cp, hp) == (c, hid):
        return h_q, xc_q, w_qkv, qv, w_proj, pv, w_fc1, f1v, w_fc2, f2v
    pad = torch.nn.functional.pad

    def parts(t):  # (..., 3C) → (..., 3cp), each of q, k, v in its own cp columns
        return pad(t.reshape(*t.shape[:-1], 3, c), (0, cp - c)).reshape(*t.shape[:-1], 3 * cp)

    w_qkv = pad(parts(w_qkv.T).T, (0, cp - c))
    return (pad(h_q, (0, cp - c)), pad(xc_q, (0, cp - c)), w_qkv.contiguous(), parts(qv).contiguous(),
            pad(w_proj, (0, cp - c, 0, cp - c)), pad(pv, (0, cp - c)), pad(w_fc1, (0, cp - c, 0, hp - hid)),
            pad(f1v, (0, hp - hid)), pad(w_fc2, (0, hp - hid, 0, cp - c)), pad(f2v, (0, cp - c)))


def _layer_consts(c, hid, dev, qkv_requant, qkv_bias, score_requant, attn_scale, out_requant, proj_requant,
                  proj_bias, s_mid, s_res_prev, s_res1, ln2_w, ln2_b, ln2_out, ln2_ratio, fc1_requant, fc1_bias,
                  fc1_out_inv, fc2_requant, fc2_bias, s_mid2, s_res2, lnn_w, lnn_b, lnn_out, lnn_ratio):
    """The JAX kernel's constant packing at the true widths: qv (2, 3C),
    pv (9, C), f1v (2, hid), f2v (9, C) and the scalars; the pipeline's own
    vectors, with the 1e-30 floors on 1/s_res and on both LN out-scales
    (``res_ln_consts``)."""
    pv, s1_ln2 = res_ln_consts(c, dev, proj_requant, proj_bias, s_mid, s_res_prev, s_res1, ln2_w,
                               ln2_b, ln2_out, ln2_ratio)
    f2v, s1_lnn = res_ln_consts(c, dev, fc2_requant, fc2_bias, s_mid2, s_res1, s_res2, lnn_w, lnn_b,
                                lnn_out, lnn_ratio)
    scal = torch.cat([_vit_scalars(score_requant, attn_scale, out_requant, dev),
                      f32_scalars(fc1_out_inv, device=dev), s1_ln2, s1_lnn])
    qv = torch.stack([f32_vec(qkv_requant, 3 * c, dev), f32_vec(qkv_bias, 3 * c, dev)])
    f1v = torch.stack([f32_vec(fc1_requant, hid, dev), f32_vec(fc1_bias, hid, dev)])
    return qv, pv, f1v, f2v, scal


def fused_vit_layer_padded_plain(h_q, xc_q, w_qkv, qkv_requant, qkv_bias, num_heads, score_requant,
                                 attn_scale, out_requant, w_proj, proj_requant, proj_bias, s_mid,
                                 s_res_prev, s_res1, ln2_w, ln2_b, ln2_out, ln2_ratio, w_fc1, fc1_requant,
                                 fc1_bias, fc1_out_inv, w_fc2, fc2_requant, fc2_bias, s_mid2, s_res2,
                                 lnn_w, lnn_b, lnn_out, lnn_ratio, lis_bits=4, lis=True):
    """The wrapper's padding route on the CPU: ``layer_pad``'s operands
    through the kernel's steps (the qkv epilogue over 3cp columns, the
    heads' attention in the first C columns of each part, zeros past them,
    both junctions with the LN counting the true C, fc1 over hp columns),
    the outputs cut to C; equals ``fused_vit_layer_plain``."""
    b, n, c = h_q.shape
    hid = w_fc1.shape[0]
    qv, pv, f1v, f2v, scal = _layer_consts(
        c, hid, h_q.device, qkv_requant, qkv_bias, score_requant, attn_scale, out_requant, proj_requant,
        proj_bias, s_mid, s_res_prev, s_res1, ln2_w, ln2_b, ln2_out, ln2_ratio, fc1_requant, fc1_bias,
        fc1_out_inv, fc2_requant, fc2_bias, s_mid2, s_res2, lnn_w, lnn_b, lnn_out, lnn_ratio)
    h_p, xc_p, wq, qv, wp, pv, w1, f1v, w2, f2v = layer_pad(c, hid, h_q, xc_q, w_qkv, qv, w_proj, pv, w_fc1,
                                                             f1v, w_fc2, f2v)
    cp = h_p.shape[-1]
    qkv = int8_matmul_requant_plain(h_p.reshape(-1, cp), wq, qv[0], qv[1]).reshape(b * n, 3, cp)
    attn = lis_attention_fused_plain(qkv[..., :c].reshape(b, n, 3 * c), num_heads, score_requant, attn_scale,
                                     out_requant, lis_bits, lis)
    attn = torch.nn.functional.pad(attn.reshape(-1, c), (0, cp - c))
    res1, mlp_in = res_ln_epilogue_plain(int_matmul_nt(attn, wp), xc_p.reshape(-1, cp), pv, scal[7:8], n_true=c)
    h1 = int8_matmul_requant_plain(mlp_in, w1, f1v[0], f1v[1], out_inv=scal[6], gelu=True)
    res2, hn = res_ln_epilogue_plain(int_matmul_nt(h1, w2), res1, f2v, scal[8:9], n_true=c)
    return hn[:, :c].reshape(b, n, c), res2[:, :c].reshape(b, n, c)


@op_span
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
    version; CUDA tensors launch the kernel (``check_fits``; C and hid
    padded by ``layer_pad`` where they are no multiples of 64) or raise.
    ``phase_ns``: a (4,) int64 CUDA tensor that receives block 0's
    %globaltimer (ns) at the kernel's start and after its qkv GEMM,
    attention and row-block phases (a measurement hook; it adds one
    grid-wide barrier).
    """
    dev = device_of(h_q, xc_q, w_qkv, w_proj, w_fc1, w_fc2)
    if dev.type == "cpu":
        return fused_vit_layer_plain(
            h_q, xc_q, w_qkv, qkv_requant, qkv_bias, num_heads, score_requant, attn_scale,
            out_requant, w_proj, proj_requant, proj_bias, s_mid, s_res_prev, s_res1, ln2_w, ln2_b,
            ln2_out, ln2_ratio, w_fc1, fc1_requant, fc1_bias, fc1_out_inv, w_fc2, fc2_requant,
            fc2_bias, s_mid2, s_res2, lnn_w, lnn_b, lnn_out, lnn_ratio, lis_bits, lis)
    out = _launch_layer(
        "p2v_fused_vit_layer", (), h_q, xc_q, w_qkv, qkv_requant, qkv_bias, num_heads, score_requant, attn_scale,
        out_requant, w_proj, proj_requant, proj_bias, s_mid, s_res_prev, s_res1, ln2_w, ln2_b, ln2_out, ln2_ratio,
        w_fc1, fc1_requant, fc1_bias, fc1_out_inv, w_fc2, fc2_requant, fc2_bias, s_mid2, s_res2, lnn_w, lnn_b,
        lnn_out, lnn_ratio, lis_bits, lis, phase_ns)
    fused_vit_layer.launches += 1
    return out


fused_vit_layer.launches = 0


def fused_vit_layer_forced(*args, lis_bits=4, lis=True, grid=0, gc=0, br=0, phase_ns=None):
    """``fused_vit_layer`` on CUDA tensors (its 32 positional arguments) on
    a forced plan: ``grid`` CTAs, ``gc`` attention query groups a chunk,
    ``br`` rows for every phase-C block (0: the plan's; ``layer_plan``'s hooks); not
    counted as a launch."""
    return _launch_layer("p2v_fused_vit_layer_forced", (int(grid), int(gc), int(br)), *args, lis_bits, lis,
                         phase_ns)


def _launch_layer(entry, extra, h_q, xc_q, w_qkv, qkv_requant, qkv_bias, num_heads, score_requant, attn_scale,
                  out_requant, w_proj, proj_requant, proj_bias, s_mid, s_res_prev, s_res1, ln2_w, ln2_b, ln2_out,
                  ln2_ratio, w_fc1, fc1_requant, fc1_bias, fc1_out_inv, w_fc2, fc2_requant, fc2_bias, s_mid2, s_res2,
                  lnn_w, lnn_b, lnn_out, lnn_ratio, lis_bits, lis, phase_ns):
    """Check the operands, pack the constants and launch ``entry``."""
    dev = device_of(h_q, xc_q, w_qkv, w_proj, w_fc1, w_fc2)
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
    qv, pv, f1v, f2v, scal = _layer_consts(
        c, hid, dev, qkv_requant, qkv_bias, score_requant, attn_scale, out_requant, proj_requant, proj_bias,
        s_mid, s_res_prev, s_res1, ln2_w, ln2_b, ln2_out, ln2_ratio, fc1_requant, fc1_bias, fc1_out_inv,
        fc2_requant, fc2_bias, s_mid2, s_res2, lnn_w, lnn_b, lnn_out, lnn_ratio)
    h_q, xc_q, w_qkv, qv, w_proj, pv, w_fc1, f1v, w_fc2, f2v = layer_pad(c, hid, h_q, xc_q, w_qkv, qv, w_proj, pv,
                                                                         w_fc1, f1v, w_fc2, f2v)
    cp, hp = h_q.shape[-1], w_fc1.shape[0]
    ws = torch.empty(b * n * 4 * cp, dtype=torch.int8, device=dev)
    ho = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    xo = torch.empty((b, n, c), dtype=torch.int8, device=dev)
    if phase_ns is not None:
        check_cuda_operand(phase_ns, "phase_ns", torch.int64, (4,))
    launch(entry, h_q, xc_q, w_qkv, qv, w_proj, pv, w_fc1, f1v, w_fc2, f2v, scal, ws,
           ho, xo, phase_ns, b, n, cp, c, num_heads, hp, int(bool(lis)), *extra)
    return ho, xo

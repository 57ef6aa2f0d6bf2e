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
this kernel cannot run: head_dim other than 1, 2, 4, 8, 16, 32 or 64,
N > 256, C or the hidden width not a multiple of 64, C > 1024, or more than
an H100 block's 227 KB of shared memory (of the zoo, DeiT-T and DeiT-S fit; DeiT-B, ViT-B
and ViT-L need more, as they need more than JAX's VMEM budget).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch, library
from .attention_lis import (FUSED_HEAD_DIMS, MAX_N, _check_lis_bits, _vit_scalars, lis_attention_fused_plain,
                            vit_attention_gc, vit_attention_layout)
from .matmul_int8 import int8_matmul_requant_plain
from .matmul_ln import MAX_ROW, code_ld, int8_matmul_res_ln_plain, res_ln_consts

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
    hdp: int  # head_dim padded to 32 or 64
    tiles: int
    items: int
    blocks: int
    chunks: int  # phase C's 64-column chunks a block: proj, fc1, fc2
    blocks_64: int  # phase C's blocks of 64 rows (the rest: 32-row blocks)
    ring: int = RING


def swizzle_offset(row: int, col: int) -> int:
    """The byte of (row, col) in a 64-row shared-memory tile of 128-byte
    K-blocks (8 KB each) in the 128-byte swizzle that TMA writes and the
    wgmma descriptors read: 16-byte chunk j of row r at chunk j ^ (r mod 8)
    (``csrc/layer_fused.cu`` ``swz``; the MLP-input and GELU tiles)."""
    return (col >> 7) * BLOCK_ROWS * 128 + row * 128 + ((((col >> 4) & 7) ^ (row & 7)) << 4) + (col & 15)


def layer_layout(n: int, c: int, heads: int, hid: int, lis: bool = True, gc: int = 0) -> dict:
    """Byte offsets of the kernel's shared memory (``layout``): phase A's
    three rings (two stages of 64 h rows and 64 weight rows) from 0 and the
    warpgroups' output tiles after them; phase C's three rings (two stages
    of 64 weight rows) from 0, then the GELU tile (which holds the block's
    attention rows during proj), the MLP-input tile (64-row tiles of
    128-byte K-blocks), the res1 tile, the staging, row-sum and row-constant
    buffers; phase B's item layout from 0 (two stages); the barriers after
    the largest."""
    hd = c // heads
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
    lay["hdp"] = 32 if hd <= 32 else 64
    lay["bar"] = -(-max(lay["end_a"], lay["end_b"], lay["end_c"]) // 8) * 8
    lay["smem"] = 1024 + lay["bar"] + BAR_BYTES
    return lay


def smem_bytes(n: int, c: int, hid: int, num_heads: int | None = None, lis: bool = True) -> int:
    """The kernel's dynamic shared memory (``layer_layout``), its largest
    phase; head_dim 64 unless ``num_heads`` is given."""
    return layer_layout(n, c, num_heads or max(1, c // 64), hid, lis)["smem"]


def check_fits(n: int, c: int, num_heads: int, hid: int) -> None:
    """Raise ValueError, naming ``fuse_layer=False``, unless the CUDA kernel
    runs this geometry (N tokens, width C, hidden width ``hid``)."""
    why = None
    if c % num_heads or c // num_heads not in FUSED_HEAD_DIMS:
        why = f"head_dim {c / num_heads:g} (the kernel takes {', '.join(map(str, FUSED_HEAD_DIMS))})"
    elif n > MAX_N:
        why = f"N = {n} tokens (the kernel takes N <= {MAX_N})"
    elif c % 64 or hid % 64 or c > MAX_ROW:
        why = f"C = {c}, hidden {hid} (the kernel takes multiples of 64, C <= {MAX_ROW})"
    elif max(smem_bytes(n, c, hid, num_heads, lis) for lis in (True, False)) > MAX_SMEM:
        why = f"{smem_bytes(n, c, hid, num_heads)} bytes of shared memory (an H100 block has {MAX_SMEM})"
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
    tiles = -(-m // BLOCK_ROWS) * (3 * c // CHUNK)
    items = b * heads
    g = grid if grid > 0 else min(sms, max(tiles, items))
    if g > sms:
        raise ValueError(f"a cooperative launch of {g} CTAs of {lay['smem']} B needs {g} SMs; the card has {sms}")
    n64 = block_split(m, g, br)
    blocks = n64 + -(-max(0, m - 64 * n64) // 32)
    return LayerPlan(THREADS, g, lay["smem"], 1024 + lay["end_a"], 1024 + lay["end_b"], 1024 + lay["end_c"],
                     lay["gc"], lay["hdp"], tiles, items, blocks, 2 * (c // CHUNK) + hid // CHUNK, n64)


def layer_kernel_info(b: int, n: int, c: int, heads: int, hid: int, lis: bool = True, grid: int = 0,
                      gc: int = 0, br: int = 0) -> dict:
    """The built kernel's launch facts, from the CUDA runtime (``plan``):
    threads, grid, shared memory (and per phase), groups a chunk, padded
    head_dim, registers and spill bytes per thread, CTAs per SM, SMs, stages
    of a warpgroup's ring, chunk width, phase C's 64-row blocks and all its
    blocks. Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * 16)()
    rc = lib.p2v_fused_vit_layer_info(int(b), int(n), int(c), int(heads), int(hid), int(bool(lis)), int(grid),
                                      int(gc), int(br), ctypes.cast(info, ctypes.c_void_p))
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
    launch(entry, h_q, xc_q, w_qkv, qv, w_proj, pv, w_fc1, f1v, w_fc2, f2v, scal, ws,
           ho, xo, phase_ns, b, n, c, num_heads, hid, int(bool(lis)), *extra)
    return ho, xo

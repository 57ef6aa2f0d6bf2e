"""int8 matmul + residual junction + the following integer LayerNorm
(counterpart of ``p2vit_tpu/ops/matmul_ln.py``).

Per row of the output:

  mid   = clip(round(acc·r + b))                       (mid-node codes)
  res   = clip(round((mid·s_mid + res_in·s_res)·(1/s_out)))
  ln    = clip(round(ln_mn_chain(res·mask)·ratio))

Two int8 outputs: the residual carrier ``res`` and the consumer's LN codes
``ln``. The mid round/clip before the add, the hoisted reciprocal 1/s_out
and the hoisted w/osc, b/osc vectors are the JAX kernel's, op for op.

CUDA kernel (``csrc/matmul_ln.cu`` over ``csrc/gemm_wgmma.cuh``) replaces
the Pallas kernel ``p2vit_tpu/ops/matmul_ln.py:int8_matmul_res_ln``
(``_kernel``). On the default paths: DeiT-S's proj (K = 384) and fc2
(K = 1536) junctions, M = B·197, N = 384, 24 calls per forward; Swin-T's
fc2 junctions, N = C of the stage and K = 4C, 9 calls. Bound on the card:
the bytes (0.19 ms per DeiT-S forward at batch 64); the kernel is bound by
its epilogue, ~55 instructions an element. Design (Hopper): a persistent
grid of clusters of up to four CTAs; a cluster owns row blocks of 64·NC
whole rows, each CTA a part of N. A producer thread TMA-loads 64·NC x rows
and BN w rows per ring stage, and NC consumer warpgroups run ``wgmma`` on
the same stage (the weights are read once per 64·NC rows), sweeping the
CTA's columns in chunks of BN. Each warp owns 16 rows: the junction runs on
the accumulator registers after each chunk, reading the residual codes
that the warp copied into a code tile in shared memory and writing the new
codes in their place, with Σx (int32) and Σx² (int64) per row in
registers; the CTAs of a cluster add each other's row sums through
distributed shared memory; then the LN pass reads the tile and stores both
outputs. The row sums are exact integers, so the result does not depend on
the order of the sums. ``res_ln_plan`` gives the plan as the C entry
computes it.

The wrapper zero-pads K to a multiple of 32 and N to a multiple of 16
(``res_ln_pad``), as the JAX wrapper pads both to 128: zero codes add
nothing to the products, zero vectors give x = 0 past N, and the LN counts
the true N (the kernel's ``n_true``, JAX's ``c_true``). Outputs are sliced
back to (M, N).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..profiling import count, op_span
from ._lib import check_cuda_operand, device_of, f32_vec, launch, library, pad_cols
from .intln import ln_codes
from .matmul_int8 import MAX_CODE, MAX_SMEM, MAX_STAGES, TILE_K, TILE_M, WIDTHS, _sm_count, int_matmul_nt

MAX_ROW = 2048  # N: the JAX kernel's widest row (its padded N ≤ 2048)
MAX_CONSUMERS = 2  # consumer warpgroups of 64 rows per CTA
MAX_CLUSTER = 4  # CTAs per cluster that split N
N_ALIGN, K_ALIGN = 16, 32  # the wrapper's zero padding of N (16-byte rows) and K (whole TMA words)


class ResLnConsts(NamedTuple):
    """The kernel's constants: the hoisted per-column vectors and s1."""

    vecs: torch.Tensor  # (9, N), or (9, N padded to N_ALIGN) where prepared
    s1: torch.Tensor  # (1,) float32


def res_ln_consts(n, device, requant_scale, bias_scaled, s_mid, s_res, s_out,
                  ln_w, ln_b, ln_out_scale, ratio) -> ResLnConsts:
    """The hoisted per-column vectors (9, n) and the LN input scale s1 (1,),
    shared by the kernel and the plain version."""
    count("consts_formed")
    v = lambda a: f32_vec(a, n, device)  # noqa: E731
    s_out_v = v(s_out)
    s1 = s_out_v.min()
    mask = torch.round(s_out_v / s1)
    osc = torch.clamp(v(ln_out_scale), min=1e-30)
    inv_s_out = torch.ones_like(s_out_v) / torch.clamp(s_out_v, min=1e-30)
    vecs = torch.stack([
        v(requant_scale), v(bias_scaled), v(s_mid), v(s_res), inv_s_out,
        mask, v(ln_w) / osc, v(ln_b) / osc, v(ratio),
    ])
    return ResLnConsts(vecs, s1.reshape(1))


def res_ln_prepared(n, device, *scales) -> ResLnConsts:
    """``res_ln_consts(n, device, *scales)`` with the vectors zero-padded to
    the kernel's N (``N_ALIGN``): what ``int8_matmul_res_ln_prepared``
    reads, formed once per serving state."""
    vecs, s1 = res_ln_consts(n, device, *scales)
    return ResLnConsts(pad_cols(vecs, N_ALIGN), s1)


def res_ln_epilogue_plain(acc, res_q, vecs, s1, qmin=-128, qmax=127, n_true=None):
    """Everything after the matmul, on an int32 accumulator (M, N); the LN
    counts ``n_true`` columns (default N)."""
    r, b, s_mid, s_res, inv_s_out, mask, w_os, b_os, ratio = (row[None, :] for row in vecs)
    mid = torch.clamp(torch.round(acc.to(torch.float32) * r + b), qmin, qmax)
    val = mid * s_mid + res_q.to(torch.float32) * s_res
    res_codes = torch.clamp(torch.round(val * inv_s_out), qmin, qmax)
    return res_codes.to(torch.int8), ln_codes(res_codes * mask, s1[0], w_os, b_os, ratio, qmin, qmax, n_true)


def int8_matmul_res_ln_plain(x_q, w_q, requant_scale, bias_scaled, res_q, s_mid,
                             s_res, s_out, ln_w, ln_b, ln_out_scale, ratio,
                             qmin=-128, qmax=127):
    """Plain PyTorch version of the kernel."""
    dev = device_of(x_q, w_q, res_q)
    vecs, s1 = res_ln_consts(w_q.shape[0], dev, requant_scale, bias_scaled, s_mid,
                             s_res, s_out, ln_w, ln_b, ln_out_scale, ratio)
    return res_ln_epilogue_plain(int_matmul_nt(x_q, w_q), res_q, vecs, s1, qmin, qmax)


def int8_matmul_res_ln_prepared_plain(x_q, w_q, res_q, consts, qmin=-128, qmax=127):
    """Plain version of ``int8_matmul_res_ln_prepared``."""
    return res_ln_epilogue_plain(int_matmul_nt(x_q, w_q), res_q, consts.vecs[:, :w_q.shape[0]], consts.s1,
                                 qmin, qmax)


def res_ln_pad(x_q, w_q, res_q, vecs):
    """The kernel's operands, zero-padded: K to a multiple of 32 (x, w), N
    to a multiple of 16 (w rows, the residual codes' and the vectors'
    columns). Zero codes add nothing to the int32 sums, and zero vectors
    make the padded columns' codes and x = code·mask zero, so Σx and Σx²
    are those of the true N; the LN must still count the true N."""
    k, n = x_q.shape[1], w_q.shape[0]
    x_p = pad_cols(x_q, K_ALIGN)
    if x_p.shape[1] != k or n % N_ALIGN:
        w_q = F.pad(w_q, (0, x_p.shape[1] - k, 0, (-n) % N_ALIGN))
    return x_p, w_q, pad_cols(res_q, N_ALIGN), pad_cols(vecs, N_ALIGN)


# ---------------------------------------------------------------------------
# The Hopper kernel's plan (csrc/matmul_ln.cu, p2v::wg::ResLnPlan)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ResLnPlan:
    """Launch plan of the junction kernel at the padded widths."""

    bn: int  # chunk width
    cpc: int  # chunks per CTA
    cs: int  # CTAs per cluster; CTA r of a cluster takes columns [r·cpc·bn, (r + 1)·cpc·bn)
    nc: int  # consumer warpgroups per CTA, 64 rows each (128·(nc + 1) threads)
    stages: int  # ring stages of (64·nc + bn)·128 bytes
    blocks: int  # row blocks of 64·nc rows
    grid: int  # persistent CTAs: min(blocks, ⌊SMs/cs⌋) clusters of cs
    smem_bytes: int
    n_pad: int  # N the kernel sees (multiple of 16)
    k_pad: int  # K the kernel sees (multiple of 32)

    @property
    def rows(self) -> int:
        return TILE_M * self.nc

    @property
    def cols(self) -> int:
        """Columns of one CTA."""
        return self.cpc * self.bn

    def walk(self):
        """Every row block as the kernel takes it: (cluster, the block's
        index in the cluster, block). Cluster c takes blocks c, c + grid/cs,
        …; each of its CTAs takes its columns of every block, each of its
        consumers 64 rows."""
        clusters = self.grid // self.cs
        for c in range(clusters):
            for i, blk in enumerate(range(c, self.blocks, clusters)):
                yield c, i, blk


def code_ld(nw: int) -> int:
    """Bytes between two rows of a consumer's code tile (``p2v::wg::code_ld``):
    the CTA's width plus 16 or 32 bytes, so that the eight rows a quad
    group writes lie in distinct banks."""
    return nw + (16 if (nw // 4) % 8 == 0 else 32)


def res_ln_smem(bn: int, cpc: int, nc: int, stages: int, cs: int) -> int:
    """Alignment slack, the ring, nc code tiles of 64 rows, the nine vectors
    over the CTA's columns, 8 bytes of row constants a row, a full and an
    empty barrier per stage and, in clusters of cs > 1, two row-sum barriers
    and two 16-byte partial row sums a row."""
    nw = bn * cpc
    return (1024 + stages * (TILE_M * nc + bn) * TILE_K + nc * TILE_M * code_ld(nw) + 9 * nw * 4
            + nc * TILE_M * 8 + 16 * stages + (16 + 2 * nc * TILE_M * 16 if cs > 1 else 0))


def ring_stages(smem, bn: int, cpc: int, nc: int, cs: int) -> int:
    """Ring stages that fit shared memory beside the rest of a whole-row
    kernel's (``smem(bn, cpc, nc, stages, cs)``), at most ``MAX_STAGES``."""
    return min(MAX_STAGES, (MAX_SMEM - smem(bn, cpc, nc, 0, cs)) // ((TILE_M * nc + bn) * TILE_K + 16))


def whole_row_plan(m: int, n_pad: int, widths, smem, resident: tuple, cs: int = 0, nc: int = 0):
    """The plan rule of the whole-row kernels (``csrc/gemm_wgmma.cuh``
    ``whole_row_plan``: this junction kernel and the fused embed) at M rows
    and the padded width, chunk widths ``widths`` and shared memory
    ``smem``: (bn, cpc, cs, nc, stages, blocks, grid), or None where nothing
    fits. For each cluster size CS of 1 to ``MAX_CLUSTER``: BN and the
    chunks per CTA cpc waste the fewest columns, ⌈N/(CS·BN)⌉·CS·BN − N, the
    widest BN on a tie; where CS = 1 fits (some NC with two ring stages), a
    CS > 1 that wastes more than CS = 1 is skipped; where it does not (a
    whole row's code tile leaves no room for two stages), the clusters need
    not beat its waste. Of the (CS, NC) whose CTA fits shared memory with a
    ring of two stages or more, the one whose busiest consumer owns the
    fewest elements, ⌈⌈M/(64·NC)⌉/resident⌉·64·cpc·BN (the epilogue's time:
    a CTA's consumers issue it side by side), then the smaller CS, then the
    smaller NC; the ring takes as many stages as shared memory holds, up to
    ``MAX_STAGES``. ``cs``, ``nc`` > 0 restrict the choice."""
    best, waste1 = None, None
    for c in range(1, MAX_CLUSTER + 1):
        bn = min(widths, key=lambda w: (-(-n_pad // (c * w)) * c * w - n_pad, -w))
        cpc = -(-n_pad // (c * bn))
        waste = c * cpc * bn - n_pad
        if c == 1:  # CS = 1's waste bounds the clusters' only where CS = 1 fits
            fits = any(ring_stages(smem, bn, cpc, q, 1) >= 2 for q in range(1, MAX_CONSUMERS + 1))
            waste1 = waste if fits else None
        if (waste1 is not None and waste > waste1) or resident[c - 1] < 1 or cs not in (0, c):
            continue
        for q in range(MAX_CONSUMERS, 0, -1):  # as the C plan: a tie goes to the smaller q
            stages = ring_stages(smem, bn, cpc, q, c)
            if stages < 2 or nc not in (0, q):
                continue
            blocks = -(-m // (TILE_M * q))
            load = -(-blocks // resident[c - 1]) * TILE_M * cpc * bn
            if best is None or load < best[0] or (load == best[0] and c == best[3] and q < best[4]):
                best = (load, bn, cpc, c, q, stages, blocks, min(blocks, resident[c - 1]) * c)
    return None if best is None else best[1:]


@functools.lru_cache(maxsize=256)
def res_ln_plan(m: int, n: int, k: int, sms: int, resident: tuple | None = None, cs: int = 0,
                nc: int = 0) -> ResLnPlan:
    """The junction kernel's plan at (M, N, K) on ``sms`` SMs, as the C entry
    computes it at the padded widths (``whole_row_plan`` over every width
    of the requant GEMM, ``WIDTHS``: 96 → 96, 384 → 2 × 192, 768 → 3 × 256);
    raises where the kernel does not run (K ≤ 0; N < 1 or N > ``MAX_ROW``;
    M outside the int32 coordinates; no SM). ``resident[c - 1]``: the
    clusters of c CTAs the card holds at once (``res_ln_kernel_info(...)
    ["resident"]`` reads them on the card; default ⌊sms/c⌋; the H100 holds
    132, 66, 39 and 30). ``cs``, ``nc`` > 0 restrict the choice (the
    measurement hook ``int8_matmul_res_ln_forced``)."""
    if k <= 0:
        raise ValueError(f"int8_matmul_res_ln kernel needs K > 0, got K={k}")
    if not 1 <= n <= MAX_ROW:
        raise ValueError(f"int8_matmul_res_ln kernel needs 1 <= N <= {MAX_ROW} (whole rows of codes and "
                         f"the per-column vectors in shared memory), got N={n}")
    if not 0 <= m < 2 ** 31:
        raise ValueError(f"int8_matmul_res_ln kernel needs 0 <= M < 2^31, got M={m}")
    if sms < 1:
        raise ValueError(f"int8_matmul_res_ln kernel needs at least one SM, got {sms}")
    resident = resident or tuple(sms // c for c in range(1, MAX_CLUSTER + 1))
    n_pad, k_pad = -(-n // N_ALIGN) * N_ALIGN, -(-k // K_ALIGN) * K_ALIGN
    p = whole_row_plan(m, n_pad, [w for w, _ in WIDTHS], res_ln_smem, resident, cs, nc)
    if p is None:
        raise ValueError(f"int8_matmul_res_ln kernel: no plan fits N={n} (cs={cs}, nc={nc})")
    bn, cpc, c, q, stages, blocks, grid = p
    return ResLnPlan(bn, cpc, c, q, stages, blocks, grid, res_ln_smem(bn, cpc, q, stages, c), n_pad, k_pad)


_INFO_KEYS = ("bn", "cpc", "cs", "nc", "stages", "blocks", "grid", "smem_bytes", "registers", "spill_bytes",
              "consumer_registers", "ctas_per_sm", "sms")


def res_ln_kernel_info(m: int, n: int, cs: int = 0, nc: int = 0) -> dict:
    """The built junction kernel's launch facts at (M, N) from the CUDA
    runtime: the plan (``cs``, ``nc`` as ``res_ln_plan``), registers and
    spill bytes per thread, a consumer's registers after ``setmaxnreg``,
    CTAs per SM, SMs, and ``resident``, the clusters of 1 to 4 CTAs the card
    holds at once. Needs the card."""
    lib, _ = library()
    info = (ctypes.c_int * 17)()
    n_pad = -(-n // N_ALIGN) * N_ALIGN
    rc = lib.p2v_int8_matmul_res_ln_info(int(m), n_pad, int(cs), int(nc), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"p2v_int8_matmul_res_ln_info: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    out = dict(zip(_INFO_KEYS, list(info)))
    out["resident"] = tuple(info[13:17])
    return out


def _res_ln_launch(entry, x_q, w_q, res_q, consts, qmin, qmax, *extra):
    """Check, pad and launch the C entry ``entry`` on the constants
    ``consts`` (vectors at N or already padded); returns (res, ln) (M, N)."""
    dev = device_of(x_q, w_q, res_q)
    m, k = x_q.shape
    n = w_q.shape[0]
    if max(abs(qmin), abs(qmax)) > MAX_CODE:
        raise ValueError(f"int8_matmul_res_ln kernel needs |qmin|, |qmax| <= 2^22, got [{qmin}, {qmax}]")
    check_cuda_operand(x_q, "x_q", torch.int8)
    check_cuda_operand(w_q, "w_q", torch.int8, (n, k))
    check_cuda_operand(res_q, "res_q", torch.int8, (m, n))
    plan = res_ln_plan(m, n, k, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()))
    x_p, w_p, res_p, vecs = res_ln_pad(x_q, w_q, res_q, consts.vecs)
    s1 = consts.s1
    check_cuda_operand(vecs, "vecs", torch.float32, (9, plan.n_pad))
    check_cuda_operand(s1, "s1", torch.float32, (1,))
    res_out = torch.empty((m, plan.n_pad), dtype=torch.int8, device=dev)
    ln_out = torch.empty((m, plan.n_pad), dtype=torch.int8, device=dev)
    launch(entry, x_p, w_p, res_p, vecs, s1, res_out, ln_out, m, plan.n_pad, n, plan.k_pad, qmin, qmax, *extra)
    if plan.n_pad != n:
        return res_out[:, :n].contiguous(), ln_out[:, :n].contiguous()
    return res_out, ln_out


def int8_matmul_res_ln_forced(x_q, w_q, requant_scale, bias_scaled, res_q, s_mid, s_res, s_out, ln_w, ln_b,
                              ln_out_scale, ratio, qmin=-128, qmax=127, cs=0, nc=0):
    """The kernel launched on the plan restricted to clusters of ``cs`` CTAs
    and ``nc`` consumers (0: free; raises where that plan does not fit). A
    measurement hook for CUDA tensors; not counted in
    ``int8_matmul_res_ln.launches``."""
    consts = res_ln_consts(w_q.shape[0], x_q.device, requant_scale, bias_scaled, s_mid, s_res, s_out, ln_w, ln_b,
                           ln_out_scale, ratio)
    return _res_ln_launch("p2v_int8_matmul_res_ln_forced", x_q, w_q, res_q, consts, qmin, qmax, cs, nc)


@op_span
def int8_matmul_res_ln(x_q, w_q, requant_scale, bias_scaled, res_q, s_mid, s_res,
                       s_out, ln_w, ln_b, ln_out_scale, ratio, qmin=-128, qmax=127):
    """Returns (res_codes, ln_codes), both (M, N) int8.

    Args:
      x_q: (M, K) int8; w_q: (N, K) int8; res_q: (M, N) int8 residual codes.
      requant_scale/bias_scaled: (N,) matmul epilogue onto the mid node.
      s_mid/s_res/s_out: the residual junction's scales; ``s_out`` is also
        the LN's input scale (s1 = min, PTF mask = round(s_out/s1)).
      ln_w/ln_b/ln_out_scale/ratio: the following LN and its requant.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (``res_ln_plan``: N ≤ 2048; |qmin|, |qmax| ≤ 2^22; any K, padded) or
    raise.
    """
    if device_of(x_q, w_q, res_q).type == "cpu":
        return int8_matmul_res_ln_plain(x_q, w_q, requant_scale, bias_scaled, res_q,
                                        s_mid, s_res, s_out, ln_w, ln_b,
                                        ln_out_scale, ratio, qmin, qmax)
    consts = res_ln_consts(w_q.shape[0], x_q.device, requant_scale, bias_scaled, s_mid, s_res, s_out, ln_w, ln_b,
                           ln_out_scale, ratio)
    out = _res_ln_launch("p2v_int8_matmul_res_ln", x_q, w_q, res_q, consts, qmin, qmax)
    int8_matmul_res_ln.launches += 1
    return out


int8_matmul_res_ln.launches = 0


@op_span(of=int8_matmul_res_ln)
def int8_matmul_res_ln_prepared(x_q, w_q, res_q, consts, qmin=-128, qmax=127):
    """``int8_matmul_res_ln`` on its constants formed beforehand
    (``res_ln_prepared``): the serving forwards' entry, which forms nothing
    per call. CPU tensors take ``int8_matmul_res_ln_prepared_plain``; CUDA
    tensors launch the kernel (counted in ``int8_matmul_res_ln.launches``)
    or raise."""
    if device_of(x_q, w_q, res_q).type == "cpu":
        return int8_matmul_res_ln_prepared_plain(x_q, w_q, res_q, consts, qmin, qmax)
    out = _res_ln_launch("p2v_int8_matmul_res_ln", x_q, w_q, res_q, consts, qmin, qmax)
    int8_matmul_res_ln.launches += 1
    return out

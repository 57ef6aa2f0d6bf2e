"""int8 matmul with the fused PoT requant epilogue, over an int8 or an
int4-packed weight store (counterpart of ``p2vit_tpu/ops/matmul_int8.py``).

  plain: out = clip(round(acc·r[n] + b[n]))                 r = s_x·s_w/s_out
  gelu:  out = clip(round(GELU(acc·r[n] + b[n])·out_inv))   r = s_x·s_w

with acc = Σ_k x[m,k]·w[n,k] exact in int32, and GELU the erf form with the
Abramowitz & Stegun 7.1.26 erf of the JAX kernel (not ``erff``).

CUDA kernel (``csrc/matmul_int8.cu`` over ``csrc/gemm_wgmma.cuh``) replaces
the Pallas kernel ``p2vit_tpu/ops/matmul_int8.py:int8_matmul_requant``
(``_kernel``). On the default paths it runs DeiT-S's fc1+GELU (M = B·197,
N = 1536, K = 384) and head, and Swin-T's qkv, proj, fc1+GELU, the plain
fc2s, the PatchMerging reductions and the head (N = 96 … 3072, K = 96 …
1536). Bound on the card: the bytes of x and out at Swin's narrow layers,
and at fc1 the GELU epilogue (~128 instructions an element, its float64
``exp`` about half: issue-bound); the int8 products are cheap. Design
(Hopper): a persistent grid of one CTA per SM, a producer thread that
TMA-loads 64 x rows and BN w rows (128 bytes of K, 128-byte swizzle, zeros
past the edges) into an mbarrier ring, and consumer warpgroups that take the
CTA's 64 × BN tiles in turn, each running ``wgmma`` s8·s8→s32 then its
epilogue while the others issue their products; the int8 tile goes out
through shared memory in 16-byte stores. Plain tiles: BN sized to N, two
consumers, the epilogue on the accumulator registers. GELU tiles: BN 64,
six consumers, the epilogue from the int32 tile in shared memory in a
rolled loop. ``requant_plan`` gives the plan as the C entry computes it.
The rounding is ``clip`` then ``+ 1.5·2^23`` (no conversion instruction),
equal to the plain version's round-then-clip for every float32
(``requant_rint_check`` proves it on the card).

``int4_matmul_requant`` (the same CUDA source and body) replaces the Pallas
kernel ``p2vit_tpu/ops/matmul_int8.py:int4_matmul_requant``
(``_packed_kernel``): the weights come as ``pack_int4``'s store, two int4
codes per byte (half the bytes). A ring stage holds one 64-byte box of the
packed store and the two x boxes it multiplies, at columns s·64 and
K/2 + s·64 (as many codes and bytes as the int8 store's stage); the
producer warpgroup's idle warps unpack the box in shared memory, chunk to
chunk at the same 64-byte-swizzled offset, into a low and a high int8 B
tile; the consumers run the low slice's then the high slice's
``wgmma``s and the int8 store's epilogue. The accumulation is exact, so
kernel, plain version (unpack, then ``int8_matmul_requant_plain``),
``int8_matmul_requant`` over the unpacked codes and the JAX kernel agree bit
for bit. Bound on the card: the weight bytes at small M (half the int8
store's); above, as the int8 store. ``int4_requant_plan`` gives its plan,
``packed_slices`` its walk over K.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import torch

from ..profiling import count, op_span
from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch, library, pad_cols
from .fastmath import exp_rn

# A&S 7.1.26 coefficients, as float32 like the JAX kernel's weak-typed consts
_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)


def int_matmul_nt(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """Exact Σ_k x[m,k]·w[n,k] as int32. ``torch.mm`` on int8 wraps, so the
    product runs in float64: every partial sum is an integer below 2^53
    (|acc| ≤ K·128² < 2^25 for K ≤ 2048), exact in any order, on CPU or GPU."""
    return (x_q.to(torch.float64) @ w_q.to(torch.float64).T).to(torch.int32)


def erf_as(x: torch.Tensor) -> torch.Tensor:
    """erf via A&S 7.1.26 (|err| ≤ 1.5e-7), op for op as the CUDA kernel."""
    a1, a2, a3, a4, a5 = _A
    s = torch.sign(x)
    ax = x.abs()
    t = torch.reciprocal(1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return s * (1.0 - poly * exp_rn(-ax * ax))


def gelu_as(y: torch.Tensor) -> torch.Tensor:
    return 0.5 * y * (1.0 + erf_as(y * 0.7071067811865476))


def requant_epilogue_plain(acc, requant_scale, bias_scaled, out_inv=1.0,
                           qmin=-128, qmax=127, gelu=False):
    """The kernel's post-matmul chain on an int32 accumulator."""
    y = acc.to(torch.float32) * requant_scale[None, :] + bias_scaled[None, :]
    if gelu:
        y = gelu_as(y) * torch.as_tensor(out_inv, dtype=torch.float32, device=y.device)
    return torch.clamp(torch.round(y), qmin, qmax).to(torch.int8)


class RequantConsts(NamedTuple):
    """The epilogue's constants as the kernel reads them."""

    r: torch.Tensor  # (N,) float32 requant scale
    b: torch.Tensor  # (N,) float32 bias
    s: torch.Tensor  # (1,) float32 out_inv


def requant_consts(n, device, requant_scale, bias_scaled, out_inv=1.0) -> RequantConsts:
    """The epilogue's constants from scalars or (N,) values: per call in the
    wrappers, once per serving state in ``serving{,_swin}.prepare``."""
    count("consts_formed")
    return RequantConsts(f32_vec(requant_scale, n, device), f32_vec(bias_scaled, n, device),
                         f32_scalars(out_inv, device=device))


def int8_matmul_requant_plain(x_q, w_q, requant_scale, bias_scaled, out_inv=1.0,
                              qmin=-128, qmax=127, gelu=False):
    """Plain PyTorch version of the kernel (CPU, or CUDA for comparison)."""
    r, b, s = requant_consts(w_q.shape[0], device_of(x_q, w_q), requant_scale, bias_scaled, out_inv)
    return requant_epilogue_plain(int_matmul_nt(x_q, w_q), r, b, s[0], qmin, qmax, gelu)


def int8_matmul_requant_prepared_plain(x_q, w_q, consts, qmin=-128, qmax=127, gelu=False):
    """Plain version of ``int8_matmul_requant_prepared``."""
    return requant_epilogue_plain(int_matmul_nt(x_q, w_q), consts.r, consts.b, consts.s[0], qmin, qmax, gelu)


# The Hopper kernel's tiling (csrc/gemm_wgmma.cuh, p2v::wg)
TILE_M = 64  # output rows per consumer tile: one m64 wgmma
TILE_K = 128  # K bytes per ring stage: the 128-byte swizzle span
PACKED_K = 64  # the packed store's bytes of a B row per stage: the 64-byte swizzle span
# (BN, consumer warpgroups per CTA) built, BN a legal m64nNk32 width; the
# GELU epilogue runs from an int32 tile in shared memory: narrow tiles, many
# consumers
WIDTHS = ((256, 2), (192, 2), (144, 2), (128, 2), (96, 2))
GELU_WIDTHS = ((64, 6),)
MAX_STAGES = 8
MAX_SMEM = 232_448  # dynamic shared memory one block may use
MAX_CODE = 2 ** 22  # |qmin|, |qmax| bound of the kernel's rounding (p2v::wg::rint_clip)


@dataclasses.dataclass(frozen=True)
class RequantPlan:
    """Launch plan of the int8 kernel (``p2v::wg::RequantPlan``)."""

    bn: int  # tile width
    nc: int  # consumer warpgroups per CTA (128·(nc + 1) threads)
    stages: int  # ring stages of (64 + bn)·128 bytes
    tiles_m: int
    tiles_n: int
    grid: int  # persistent CTAs, min(SMs, tiles)
    smem_bytes: int

    @property
    def tiles(self) -> int:
        return self.tiles_m * self.tiles_n

    def tile(self, t: int) -> tuple:
        """Output origin (m0, n0) of tile t: M-outer, N-inner."""
        return (t // self.tiles_n) * TILE_M, (t % self.tiles_n) * self.bn

    def walk(self):
        """Every tile as the kernel takes it: (CTA, consumer warpgroup, the
        tile's index in the CTA, tile). CTA c takes tiles c, c + grid, …;
        its consumers take them in turn; the i-th tile's K slices fill ring
        positions i·⌈K/128⌉ onwards."""
        for c in range(self.grid):
            for i, t in enumerate(range(c, self.tiles, self.grid)):
                yield c, i % self.nc, i, t


def stage_bytes(bn: int) -> int:
    """A ring stage: 64 x rows and bn w rows of 128 bytes; for the packed
    store its two x boxes of 64 rows, its packed box of bn rows (unpacked in
    place into the low B tile) and the high B tile, 64 bytes each: the same
    bytes."""
    return (TILE_M + bn) * TILE_K


def requant_smem(bn: int, nc: int, stages: int, gelu: bool, packed: bool = False) -> int:
    """Alignment slack, ring, a 64 × (bn + 16) output tile and r and b per
    consumer, with GELU a 64 × (bn + 8) int32 accumulator tile per consumer,
    a full and an empty barrier per stage (and, packed, the packed box's),
    an order barrier per consumer."""
    return (1024 + stages * stage_bytes(bn) + nc * TILE_M * (bn + 16) + nc * 8 * bn
            + (nc * TILE_M * (bn + 8) * 4 if gelu else 0) + (24 if packed else 16) * stages + 8 * nc)


@functools.lru_cache(maxsize=256)
def requant_plan(m: int, n: int, k: int, sms: int, gelu: bool = False) -> RequantPlan:
    """The int8 kernel's plan at (M, N, K) on ``sms`` SMs, as the C entry
    computes it; raises where the kernel does not run (K ≤ 0 or K % 16, the
    TMA row stride; M or N outside the int32 coordinates; no SM).

    BN is the width of ``WIDTHS`` (``GELU_WIDTHS``) that wastes the fewest
    columns, ⌈N/BN⌉·BN − N, the widest on a tie (96 → 96, 288 → 144,
    1536 → 256, 1000 → 144 with an 8-column masked edge); the ring takes as
    many stages as shared memory holds, up to ``MAX_STAGES``."""
    if k <= 0 or k % 16:
        raise ValueError(f"int8_matmul_requant kernel needs K % 16 == 0 and K > 0, got K={k}")
    return _plan(m, n, sms, gelu, False, "int8_matmul_requant")


def _plan(m, n, sms, gelu, packed, name):
    if not (0 <= m < 2 ** 31 and 0 <= n < 2 ** 31):
        raise ValueError(f"{name} kernel needs 0 <= M, N < 2^31, got M={m}, N={n}")
    if sms < 1:
        raise ValueError(f"{name} kernel needs at least one SM, got {sms}")
    bn, nc = min(GELU_WIDTHS if gelu else WIDTHS, key=lambda w: (-(-n // w[0]) * w[0] - n, -w[0]))
    stages = min(MAX_STAGES, (MAX_SMEM - requant_smem(bn, nc, 0, gelu, packed))
                 // (stage_bytes(bn) + (24 if packed else 16)))
    tiles_m, tiles_n = -(-m // TILE_M), -(-n // bn)
    return RequantPlan(bn, nc, stages, tiles_m, tiles_n, min(sms, tiles_m * tiles_n),
                       requant_smem(bn, nc, stages, gelu, packed))


@functools.lru_cache(maxsize=256)
def int4_requant_plan(m: int, n: int, k: int, sms: int, gelu: bool = False) -> RequantPlan:
    """The int4-store kernel's plan at (M, N) and x's K = 2·kh (the
    wrapper's padded K, kh % 16 == 0), as the C entry computes it: the int8
    store's widths, rules and ``stage_bytes``, each ring stage a packed box,
    two x boxes and the high B tile, with one more barrier; raises where the
    kernel does not run."""
    if k <= 0 or k % 32:
        raise ValueError(f"int4_matmul_requant kernel needs K/2 % 16 == 0 and K > 0, got K={k}")
    return _plan(m, n, sms, gelu, True, "int4_matmul_requant")


def packed_slices(k: int) -> list:
    """The int4-store kernel's walk over x's K = 2·kh, one entry per ring
    stage s: (x column of the low box s·64, x column of the high box
    kh + s·64, packed column s·64, 32-code wgmma steps of each half). TMA
    fills zeros past x's K columns and past the store's kh; a zero byte
    unpacks to two zero codes."""
    kh = k // 2
    return [(s, kh + s, s, -(-min(PACKED_K, kh - s) // 32)) for s in range(0, kh, PACKED_K)]


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _kernel_info(entry: str, m: int, n: int, k: int, gelu: bool) -> dict:
    lib, _ = library()
    info = (ctypes.c_int * 12)()
    rc = getattr(lib, entry)(int(m), int(n), int(k), int(bool(gelu)), ctypes.cast(info, ctypes.c_void_p))
    if rc != 0:
        raise RuntimeError(f"{entry}: CUDA error {rc}: {lib.p2v_error_string(rc).decode()}")
    keys = ("bn", "nc", "stages", "tiles_m", "tiles_n", "grid", "smem_bytes", "registers", "spill_bytes",
            "consumer_registers", "ctas_per_sm", "sms")
    return dict(zip(keys, list(info)))


def requant_kernel_info(m: int, n: int, k: int, gelu: bool = False) -> dict:
    """The built int8 kernel's launch facts at (M, N, K) from the CUDA
    runtime: the plan, registers and spill bytes per thread, CTAs per SM and
    SMs. Needs the card."""
    return _kernel_info("p2v_int8_matmul_requant_info", m, n, k, gelu)


def int4_kernel_info(m: int, n: int, k: int, gelu: bool = False) -> dict:
    """``requant_kernel_info`` of the int4-store kernel at (M, N) and x's
    padded K. Needs the card."""
    return _kernel_info("p2v_int4_matmul_requant_info", m, n, k, gelu)


def requant_rint_check(qmin: int, qmax: int, device=None) -> int:
    """The kernel's rounding (``p2v::wg::rint_clip``: clip, then round by
    adding 1.5·2^23) against the plain rintf-then-clip, over all 2^32 float32
    bit patterns at [qmin, qmax], on the card; returns the floats whose codes
    differ."""
    bad = torch.zeros(1, dtype=torch.int64, device=device or torch.device("cuda", torch.cuda.current_device()))
    launch("p2v_requant_rint_check", qmin, qmax, bad)
    return int(bad.item())


def requant_pad(x_q, w_q):
    """x (M, K) and w (N, K) with K zero-padded to a multiple of 32 (zeros
    add nothing to the exact sum; JAX pads K to 128): rows of K % 16 ≠ 0
    bytes cannot be TMA rows, and TMA loads rows of K % 32 ≠ 0 slowly (the
    int stem's K = 48 took over twice K = 96's time at the same M and N,
    ``tools/requant_bench.py``)."""
    return pad_cols(x_q, 32), pad_cols(w_q, 32)


def _requant_launch(entry, x_q, w_q, consts, qmin, qmax, gelu, *extra):
    """Check the operands, pad K (``requant_pad``) and launch the C entry
    ``entry`` on the epilogue constants ``consts``; returns (M, N) int8.
    Raises where the kernel does not run (``requant_plan`` at the padded K;
    |qmin|, |qmax| ≤ 2^22)."""
    dev = x_q.device
    if max(abs(qmin), abs(qmax)) > MAX_CODE:
        raise ValueError(f"int8_matmul_requant kernel needs |qmin|, |qmax| <= 2^22, got [{qmin}, {qmax}]")
    m, k = x_q.shape
    n = w_q.shape[0]
    check_cuda_operand(x_q, "x_q", torch.int8)
    check_cuda_operand(w_q, "w_q", torch.int8, (n, k))
    for name, t, size in (("r", consts.r, n), ("b", consts.b, n), ("out_inv", consts.s, 1)):
        check_cuda_operand(t, name, torch.float32, (size,))
    x_q, w_q = requant_pad(x_q, w_q)
    k = x_q.shape[1]
    requant_plan(m, n, k, _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()),
                 bool(gelu))
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    launch(entry, x_q, w_q, consts.r, consts.b, consts.s, out, m, n, k, qmin, qmax, int(bool(gelu)), *extra)
    return out


def int8_matmul_requant_grid(x_q, w_q, requant_scale, bias_scaled, out_inv=1.0,
                             qmin=-128, qmax=127, gelu=False, grid=0):
    """The int8 kernel launched on ``grid`` CTAs (0: the plan's persistent
    grid; ``requant_plan(...).tiles``: one tile per CTA). A measurement hook
    for CUDA tensors; not counted in ``int8_matmul_requant.launches``."""
    consts = requant_consts(w_q.shape[0], x_q.device, requant_scale, bias_scaled, out_inv)
    return _requant_launch("p2v_int8_matmul_requant_grid", x_q, w_q, consts, qmin, qmax, gelu, grid)


@op_span
def int8_matmul_requant(x_q, w_q, requant_scale, bias_scaled, out_inv=1.0,
                        qmin=-128, qmax=127, gelu=False):
    """out_q = clip(round(epilogue(Σ_k x_q·w_q · requant[n] + bias[n]))).

    Args:
      x_q: (M, K) int8 activation codes. w_q: (N, K) int8 weight codes.
      requant_scale, bias_scaled: (N,) float32 (or scalars).
      out_inv: 1/s_out for the GELU epilogue.
    Returns (M, N) int8. CPU tensors take the plain version; CUDA tensors
    launch the kernel (any K > 0, zero-padded by ``requant_pad``;
    ``requant_plan``) or raise.
    """
    dev = device_of(x_q, w_q)
    if dev.type == "cpu":
        return int8_matmul_requant_plain(x_q, w_q, requant_scale, bias_scaled,
                                         out_inv, qmin, qmax, gelu)
    consts = requant_consts(w_q.shape[0], dev, requant_scale, bias_scaled, out_inv)
    out = _requant_launch("p2v_int8_matmul_requant", x_q, w_q, consts, qmin, qmax, gelu)
    int8_matmul_requant.launches += 1
    return out


int8_matmul_requant.launches = 0


@op_span(of=int8_matmul_requant)
def int8_matmul_requant_prepared(x_q, w_q, consts, qmin=-128, qmax=127, gelu=False):
    """``int8_matmul_requant`` on its epilogue constants formed beforehand
    (``requant_consts``): the serving forwards' entry, which forms nothing
    per call. CPU tensors take ``int8_matmul_requant_prepared_plain``; CUDA
    tensors launch the kernel (counted in ``int8_matmul_requant.launches``)
    or raise."""
    if device_of(x_q, w_q).type == "cpu":
        return int8_matmul_requant_prepared_plain(x_q, w_q, consts, qmin, qmax, gelu)
    out = _requant_launch("p2v_int8_matmul_requant", x_q, w_q, consts, qmin, qmax, gelu)
    int8_matmul_requant.launches += 1
    return out


def pack_int4(w_q: torch.Tensor) -> torch.Tensor:
    """Pack int4-valued int8 weight codes two per byte: byte j of row n holds
    w[n, j] in its LOW nibble and w[n, j + K/2] in its HIGH nibble (two
    contiguous half-K panels). K must be even; codes outside [-8, 7] raise."""
    n, k = w_q.shape
    if k % 2:
        raise ValueError(f"pack_int4 needs an even K, got K={k}")
    if w_q.numel():
        lo, hi = int(w_q.min()), int(w_q.max())
        if lo < -8 or hi > 7:
            raise ValueError(
                f"pack_int4 expects int4 codes in [-8, 7]; got [{lo}, {hi}] — `& 0xF` would "
                f"silently corrupt out-of-range values (w=-100 packs as 12)")
    w32 = w_q.to(torch.int32)
    v = (w32[:, : k // 2] & 0xF) | ((w32[:, k // 2:] & 0xF) << 4)  # 0..255
    return (v - ((v >> 7) << 8)).to(torch.int8)  # two's complement byte


def unpack_int4(w_packed: torch.Tensor) -> torch.Tensor:
    """``pack_int4``'s store → the (N, K) int8 codes: the low nibble
    sign-extended by (v ^ 8) − 8, the high one by an arithmetic shift."""
    w32 = w_packed.to(torch.int32)
    return torch.cat([((w32 & 0xF) ^ 8) - 8, w32 >> 4], dim=1).to(torch.int8)


def _check_packed(x_q, w_packed) -> None:
    k = x_q.shape[1]
    if k % 2 or w_packed.shape[1] != k // 2:
        raise ValueError(f"int4_matmul_requant: x has K={k}; the packed store needs an even K and "
                         f"K/2 bytes per row, got {tuple(w_packed.shape)}")


def int4_matmul_requant_plain(x_q, w_packed, requant_scale, bias_scaled, out_inv=1.0,
                              qmin=-128, qmax=127, gelu=False):
    """Plain PyTorch version of the int4-store kernel: unpack, then the int8
    plain version (the accumulation is exact, so this is the kernel's
    result bit for bit)."""
    _check_packed(x_q, w_packed)
    return int8_matmul_requant_plain(x_q, unpack_int4(w_packed), requant_scale, bias_scaled,
                                     out_inv, qmin, qmax, gelu)


def int4_pad(x_q, w_packed):
    """x (M, K) and the store (N, K/2) with each half of x and the store's
    rows zero-padded to a multiple of 16 codes (the kernel's TMA rows; JAX
    pads both halves to its lane width); zeros add nothing to the exact
    sum."""
    kh = w_packed.shape[1]
    pad = (-kh) % 16
    if not pad:
        return x_q, w_packed
    f = torch.nn.functional.pad
    return torch.cat([f(x_q[:, :kh], (0, pad)), f(x_q[:, kh:], (0, pad))], dim=1), f(w_packed, (0, pad))


def _int4_args(x_q, w_packed, requant_scale, bias_scaled, out_inv, gelu):
    """Checked CUDA launch arguments of the int4-store kernel, (x, store, r,
    b, scalars, out), both halves padded by ``int4_pad``; raises where it
    does not run (``int4_requant_plan`` at the padded K)."""
    dev = x_q.device
    m = x_q.shape[0]
    n, kh = w_packed.shape
    check_cuda_operand(x_q, "x_q", torch.int8)
    check_cuda_operand(w_packed, "w_packed", torch.int8, (n, kh))
    x_q, w_packed = int4_pad(x_q, w_packed)
    int4_requant_plan(m, n, x_q.shape[1],
                      _sm_count(dev.index if dev.index is not None else torch.cuda.current_device()), bool(gelu))
    r, b, s = requant_consts(n, dev, requant_scale, bias_scaled, out_inv)
    return x_q, w_packed, r, b, s, torch.empty((m, n), dtype=torch.int8, device=dev)


def int4_matmul_requant_grid(x_q, w_packed, requant_scale, bias_scaled, out_inv=1.0,
                             qmin=-128, qmax=127, gelu=False, grid=0):
    """The int4-store kernel launched on ``grid`` CTAs (0: the plan's
    persistent grid; ``int4_requant_plan(...).tiles``: one tile per CTA). A
    measurement hook for CUDA tensors; not counted in
    ``int4_matmul_requant.launches``."""
    _check_packed(x_q, w_packed)
    x_q, w_packed, r, b, s, out = _int4_args(x_q, w_packed, requant_scale, bias_scaled, out_inv, gelu)
    (m, k), n = x_q.shape, w_packed.shape[0]
    launch("p2v_int4_matmul_requant_grid", x_q, w_packed, r, b, s, out, m, n, k, qmin, qmax, int(bool(gelu)),
           grid)
    return out


@op_span
def int4_matmul_requant(x_q, w_packed, requant_scale, bias_scaled, out_inv=1.0,
                        qmin=-128, qmax=127, gelu=False):
    """``int8_matmul_requant`` over the int4-packed store ``pack_int4(w_q)``.

    Args:
      x_q: (M, K) int8 activation codes, K even. w_packed: (N, K/2) int8.
      requant_scale, bias_scaled, out_inv, qmin, qmax, gelu: as
        ``int8_matmul_requant`` (any qmin, qmax: past |2^22| the kernel
        rounds as the plain version, rintf then the clip).
    Returns (M, N) int8. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise. Where K/2 is not a multiple of 16 the wrapper
    pads both halves of x and the store with zero codes (``int4_pad``), as
    the JAX wrapper pads them to its lane width.
    """
    dev = device_of(x_q, w_packed)
    _check_packed(x_q, w_packed)
    if dev.type == "cpu":
        return int4_matmul_requant_plain(x_q, w_packed, requant_scale, bias_scaled,
                                         out_inv, qmin, qmax, gelu)
    x_q, w_packed, r, b, s, out = _int4_args(x_q, w_packed, requant_scale, bias_scaled, out_inv, gelu)
    (m, k), n = x_q.shape, w_packed.shape[0]
    launch("p2v_int4_matmul_requant", x_q, w_packed, r, b, s, out, m, n, k,
           qmin, qmax, int(bool(gelu)))
    int4_matmul_requant.launches += 1
    return out


int4_matmul_requant.launches = 0

"""bf16 matmul over a streamed quantized weight store (counterpart of
``p2vit_tpu/ops/matmul_wstream.py``).

  out[m, n] = bf16([GELU](S[m, n]·row_scale[n] + bias[n]))

for the weight-only GEMMs: bf16 activations against the weight codes of
``serving.weight_only_params`` kept in one of four stores:

* ``bf16``: (N, K) bf16 values (the codes, or any bf16 weights);
* ``i8``: (N, K) int8 codes;
* ``w8p``: ``pack_w8(codes)``, (N, pk) int32 words, byte p of word j the
  code of K index p·pk + j (4 panels, pk = ``panel_len(K, 4)``);
* ``w4p``: ``pack_w4(codes)``, nibble p of word j (8 panels), int4 codes.

SmoothQuant layers fold 1/cs into x outside (a power of two, exact in bf16),
as the JAX module says. The GELU is the A&S-erf ``gelu_as`` of
``ops/matmul_int8.py``.

Numerics contract (kernel and plain version bit for bit; the JAX package's
kernel accumulates in float32 in an unspecified order): S = Σ_p fl32(A_p),
the panels' sums A_p taken EXACTLY, each rounded once to float32, added in
order p = 0..P−1 (P = 1 for ``bf16`` and ``i8``), then ``×r`` and ``+b`` as
two separately rounded float32 operations and the bf16 rounding to nearest
even. A_p is exact because every bf16 × code product has at most 16
significant bits: a float64 sum of them is exact, in any order, while the
products of a row span ≤ 25 binades (true of every input the tests and
``chip_smoke.py`` draw). The CUDA kernel accumulates A_p with float64 FMAs,
the plain version with one float64 matmul per panel. Against the JAX kernel
this lies within its own envelope, ≤ 1 bf16 ulp of the panel-matched
float32 twin (≤ 2 with GELU); ``tests/test_torch_wstream.py`` states the
measured maxima.

CUDA kernel (``csrc/matmul_wstream.cu``) replaces the Pallas kernel
``p2vit_tpu/ops/matmul_wstream.py:wstream_matmul`` (``_kernel``). Bound on
the card: the bound counts the bf16 tensor-core peak, but this design runs
the products as float64 FMAs (exact, order-free sums), so it sits far above
its bound and behind the bf16 library GEMM; the weight bytes it saves
matter only once the products are cheap.
"""

from __future__ import annotations

import torch

from ._lib import check_cuda_operand, device_of, f32_vec, launch
from .matmul_int8 import gelu_as

LANE = 128
FORMATS = ("bf16", "i8", "w8p", "w4p")
PANELS = {"bf16": 1, "i8": 1, "w8p": 4, "w4p": 8}
_FORMAT_ID = {f: i for i, f in enumerate(FORMATS)}
_STORE_DTYPE = {"bf16": torch.bfloat16, "i8": torch.int8, "w8p": torch.int32, "w4p": torch.int32}


def panel_len(k: int, panels: int) -> int:
    """Per-panel length: K split into ``panels`` parts, padded to 128."""
    per_panel = -(-k // panels)
    return -(-per_panel // LANE) * LANE


def _wrap_i32(v: torch.Tensor) -> torch.Tensor:
    """int64 words in [0, 2^32) → the int32 with the same bits."""
    return (v - ((v >> 31) << 32)).to(torch.int32)


def _pack(w_q: torch.Tensor, panels: int, bits: int) -> torch.Tensor:
    k = w_q.shape[1]
    pk = panel_len(k, panels)
    w = torch.nn.functional.pad(w_q.to(torch.int64), (0, panels * pk - k)) & ((1 << bits) - 1)
    out = w[:, :pk].clone()
    for p in range(1, panels):
        out |= w[:, p * pk:(p + 1) * pk] << (bits * p)
    return _wrap_i32(out)


def pack_w8(w_q: torch.Tensor) -> torch.Tensor:
    """(N, K) int8 codes → (N, panel_len(K, 4)) int32 words: word j holds
    panel p's code w[n, p·pk + j] in byte p. K pads with zero codes."""
    return _pack(w_q, 4, 8)


def pack_w4(w_q: torch.Tensor) -> torch.Tensor:
    """(N, K) int4-valued codes → (N, panel_len(K, 8)) int32 words: word j
    holds panel p's code in nibble p. Codes outside [-8, 7] raise."""
    if w_q.numel():
        lo, hi = int(w_q.min()), int(w_q.max())
        if lo < -8 or hi > 7:
            raise ValueError(f"pack_w4 expects int4 codes in [-8, 7]; got [{lo}, {hi}]")
    return _pack(w_q, 8, 4)


def _check(x, w, row_scale, w_format):
    """The JAX wrapper's format and shape checks; returns (panels, pk)."""
    if w_format not in FORMATS:
        raise ValueError(f"unknown w_format {w_format!r}")
    k = x.shape[1]
    n = row_scale.shape[0]
    panels = PANELS[w_format]
    pk = panel_len(k, panels)
    if w.shape[0] != n:
        raise ValueError(f"weight store has {w.shape[0]} rows; row_scale has {n}")
    if w_format in ("bf16", "i8"):
        if w.shape[1] != k:
            raise ValueError(f"{w_format} store has {w.shape[1]} cols; x has K={k}")
    elif w.shape[1] != pk:
        raise ValueError(
            f"{w_format} store has {w.shape[1]} words/row; expected {pk} for K={k} — repack with "
            f"{'pack_w8' if w_format == 'w8p' else 'pack_w4'}")
    return panels, pk


def unpack_store(w: torch.Tensor, w_format: str) -> torch.Tensor:
    """A store → its (N, K') values in float64: K' = K for ``bf16``/``i8``,
    panels·pk for the packed stores (the pad holds zero codes)."""
    if w_format in ("bf16", "i8"):
        return w.to(torch.float64)
    panels, bits = (4, 8) if w_format == "w8p" else (8, 4)
    w64 = w.to(torch.int64) & 0xFFFFFFFF
    half = 1 << (bits - 1)
    parts = [(((w64 >> (bits * p)) & ((1 << bits) - 1)) ^ half) - half for p in range(panels)]
    return torch.cat(parts, dim=1).to(torch.float64)


def wstream_matmul_plain(x, w_store, row_scale, bias, w_format="w8p", gelu=False):
    """Plain PyTorch version of the kernel: one exact float64 matmul per
    panel, each rounded once to float32, summed in panel order, then the
    float32 epilogue and the bf16 rounding (module docstring)."""
    panels, pk = _check(x, w_store, row_scale, w_format)
    m, k = x.shape
    codes = unpack_store(w_store, w_format)
    span = codes.shape[1] // panels
    xd = torch.nn.functional.pad(x.to(torch.bfloat16).to(torch.float64), (0, codes.shape[1] - k))
    s = None
    for p in range(panels):
        # + 0.0: an all-zero panel sums to +0, as the kernel's accumulator does
        acc = (xd[:, p * span:(p + 1) * span] @ codes[:, p * span:(p + 1) * span].T + 0.0).to(torch.float32)
        s = acc if s is None else s + acc
    n = row_scale.shape[0]
    y = s * f32_vec(row_scale, n, x.device)[None, :] + f32_vec(bias, n, x.device)[None, :]
    if gelu:
        y = gelu_as(y)
    return y.to(torch.bfloat16)


def wstream_matmul(x, w_store, row_scale, bias, w_format="w8p", gelu=False):
    """out = [gelu](x @ codesᵀ · row_scale[n] + bias[n]) in bf16.

    Args:
      x: (M, K) activations, taken as bf16 (SmoothQuant layers: pre-scaled
        by the PoT 1/cs outside).
      w_store: the weight store of ``w_format`` (module docstring).
      row_scale: (N,) float32 per-out-channel weight scale. bias: (N,).
    Returns (M, N) bf16. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise.
    """
    _, pk = _check(x, w_store, row_scale, w_format)
    dev = device_of(x, w_store)
    if dev.type == "cpu":
        return wstream_matmul_plain(x, w_store, row_scale, bias, w_format, gelu)
    m, k = x.shape
    n = row_scale.shape[0]
    x = x.to(torch.bfloat16)
    check_cuda_operand(x, "x", torch.bfloat16)
    check_cuda_operand(w_store, "w_store", _STORE_DTYPE[w_format])
    r = f32_vec(row_scale, n, dev)
    b = f32_vec(bias, n, dev)
    out = torch.empty((m, n), dtype=torch.bfloat16, device=dev)
    launch("p2v_wstream_matmul", x, w_store, r, b, out, m, n, k, pk, _FORMAT_ID[w_format], int(bool(gelu)))
    wstream_matmul.launches += 1
    return out


wstream_matmul.launches = 0

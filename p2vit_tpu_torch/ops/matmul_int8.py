"""int8 matmul with the fused PoT requant epilogue (counterpart of
``p2vit_tpu/ops/matmul_int8.py``).

  plain: out = clip(round(acc·r[n] + b[n]))                 r = s_x·s_w/s_out
  gelu:  out = clip(round(GELU(acc·r[n] + b[n])·out_inv))   r = s_x·s_w

with acc = Σ_k x[m,k]·w[n,k] exact in int32, and GELU the erf form with the
Abramowitz & Stegun 7.1.26 erf of the JAX kernel (not ``erff``).

CUDA kernel (``csrc/matmul_int8.cu``) replaces the Pallas kernel
``p2vit_tpu/ops/matmul_int8.py:int8_matmul_requant`` (``_kernel``). On the
main path it runs fc1+GELU (M = B·197, N = 1536, K = 384) and the head
(M = B, N = 1000, K = 384). Bound on the card: int8 tensor-core throughput
for fc1 at batch ≥ 8 (2·M·N·K operations against M·K + N·K + M·N bytes);
the head is launch-bound. Design: 128×128 output tiles, 8 warps of
``mma.sync.m16n8k32`` s8×s8→s32, K staged in 64-byte slices through
shared memory, edges masked (no padding copies), and the epilogue applied to
the accumulator registers before the one int8 store.
"""

from __future__ import annotations

import torch

from ._lib import check_cuda_operand, device_of, f32_scalars, f32_vec, launch
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


def int8_matmul_requant_plain(x_q, w_q, requant_scale, bias_scaled, out_inv=1.0,
                              qmin=-128, qmax=127, gelu=False):
    """Plain PyTorch version of the kernel (CPU, or CUDA for comparison)."""
    dev = device_of(x_q, w_q)
    n = w_q.shape[0]
    return requant_epilogue_plain(
        int_matmul_nt(x_q, w_q), f32_vec(requant_scale, n, dev),
        f32_vec(bias_scaled, n, dev), out_inv, qmin, qmax, gelu,
    )


def int8_matmul_requant(x_q, w_q, requant_scale, bias_scaled, out_inv=1.0,
                        qmin=-128, qmax=127, gelu=False):
    """out_q = clip(round(epilogue(Σ_k x_q·w_q · requant[n] + bias[n]))).

    Args:
      x_q: (M, K) int8 activation codes. w_q: (N, K) int8 weight codes.
      requant_scale, bias_scaled: (N,) float32 (or scalars).
      out_inv: 1/s_out for the GELU epilogue.
    Returns (M, N) int8. CPU tensors take the plain version; CUDA tensors
    launch the kernel (K must be a multiple of 16) or raise.
    """
    dev = device_of(x_q, w_q)
    if dev.type == "cpu":
        return int8_matmul_requant_plain(x_q, w_q, requant_scale, bias_scaled,
                                         out_inv, qmin, qmax, gelu)
    m, k = x_q.shape
    n = w_q.shape[0]
    check_cuda_operand(x_q, "x_q", torch.int8)
    check_cuda_operand(w_q, "w_q", torch.int8, (n, k))
    if k % 16:
        raise ValueError(f"int8_matmul_requant kernel needs K % 16 == 0, got K={k}")
    r = f32_vec(requant_scale, n, dev)
    b = f32_vec(bias_scaled, n, dev)
    s = f32_scalars(out_inv, device=dev)
    out = torch.empty((m, n), dtype=torch.int8, device=dev)
    launch("p2v_int8_matmul_requant", x_q, w_q, r, b, s, out, m, n, k,
           qmin, qmax, int(bool(gelu)))
    int8_matmul_requant.launches += 1
    return out


int8_matmul_requant.launches = 0

"""int8 matmul + residual junction + the following integer LayerNorm
(counterpart of ``p2vit_tpu/ops/matmul_ln.py``).

Per row of the output:

  mid   = clip(round(acc·r + b))                       (mid-node codes)
  res   = clip(round((mid·s_mid + res_in·s_res)·(1/s_out)))
  ln    = clip(round(ln_mn_chain(res·mask)·ratio))

Two int8 outputs: the residual carrier ``res`` and the consumer's LN codes
``ln``. The mid round/clip before the add, the hoisted reciprocal 1/s_out
and the hoisted w/osc, b/osc vectors are the JAX kernel's, op for op.

CUDA kernel (``csrc/matmul_ln.cu``) replaces the Pallas kernel
``p2vit_tpu/ops/matmul_ln.py:int8_matmul_res_ln`` (``_kernel``). On the main
path: the proj (K = 384) and fc2 (K = 1536) junctions, M = B·197, N = 384,
24 calls per forward. The LN needs whole rows (N up to 1024 in the zoo), so
a block owns 32 full rows: its ``mma.sync`` int8 tiles sweep the row in
128-column chunks into a shared-memory int32 row buffer, then each warp runs
the epilogue on whole rows. Σx and Σx² are exact int32 warp sums, so the
result does not depend on the order threads add in. Bound on the card:
tensor-core issue for fc2 (K = 1536); the 32-row blocks re-read the weight
panel from L2 once per block.
"""

from __future__ import annotations

import torch

from ._lib import check_cuda_operand, device_of, f32_vec, launch
from .intln import ln_codes
from .matmul_int8 import int_matmul_nt

MAX_ROW = 1024  # the kernel's shared-memory row buffer; Σx² < 2^31 up to here


def res_ln_consts(n, device, requant_scale, bias_scaled, s_mid, s_res, s_out,
                  ln_w, ln_b, ln_out_scale, ratio):
    """The hoisted per-column vectors (9, n) and the LN input scale s1 (1,),
    shared by the kernel and the plain version."""
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
    return vecs, s1.reshape(1)


def res_ln_epilogue_plain(acc, res_q, vecs, s1, qmin=-128, qmax=127):
    """Everything after the matmul, on an int32 accumulator (M, N)."""
    r, b, s_mid, s_res, inv_s_out, mask, w_os, b_os, ratio = (row[None, :] for row in vecs)
    mid = torch.clamp(torch.round(acc.to(torch.float32) * r + b), qmin, qmax)
    val = mid * s_mid + res_q.to(torch.float32) * s_res
    res_codes = torch.clamp(torch.round(val * inv_s_out), qmin, qmax)
    return res_codes.to(torch.int8), ln_codes(res_codes * mask, s1[0], w_os, b_os, ratio, qmin, qmax)


def int8_matmul_res_ln_plain(x_q, w_q, requant_scale, bias_scaled, res_q, s_mid,
                             s_res, s_out, ln_w, ln_b, ln_out_scale, ratio,
                             qmin=-128, qmax=127):
    """Plain PyTorch version of the kernel."""
    dev = device_of(x_q, w_q, res_q)
    vecs, s1 = res_ln_consts(w_q.shape[0], dev, requant_scale, bias_scaled, s_mid,
                             s_res, s_out, ln_w, ln_b, ln_out_scale, ratio)
    return res_ln_epilogue_plain(int_matmul_nt(x_q, w_q), res_q, vecs, s1, qmin, qmax)


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
    (K % 16 == 0, N % 8 == 0, N ≤ 1024) or raise.
    """
    dev = device_of(x_q, w_q, res_q)
    if dev.type == "cpu":
        return int8_matmul_res_ln_plain(x_q, w_q, requant_scale, bias_scaled, res_q,
                                        s_mid, s_res, s_out, ln_w, ln_b,
                                        ln_out_scale, ratio, qmin, qmax)
    m, k = x_q.shape
    n = w_q.shape[0]
    check_cuda_operand(x_q, "x_q", torch.int8)
    check_cuda_operand(w_q, "w_q", torch.int8, (n, k))
    check_cuda_operand(res_q, "res_q", torch.int8, (m, n))
    if k % 16 or n % 8 or n > MAX_ROW:
        raise ValueError(
            f"int8_matmul_res_ln kernel needs K % 16 == 0, N % 8 == 0 and "
            f"N <= {MAX_ROW} (whole rows in shared memory); got K={k}, N={n}")
    vecs, s1 = res_ln_consts(n, dev, requant_scale, bias_scaled, s_mid, s_res,
                             s_out, ln_w, ln_b, ln_out_scale, ratio)
    res_out = torch.empty((m, n), dtype=torch.int8, device=dev)
    ln_out = torch.empty((m, n), dtype=torch.int8, device=dev)
    launch("p2v_int8_matmul_res_ln", x_q, w_q, res_q, vecs, s1, res_out, ln_out,
           m, n, k, qmin, qmax)
    int8_matmul_res_ln.launches += 1
    return res_out, ln_out


int8_matmul_res_ln.launches = 0

"""Integer serving arithmetic of the plain reference, in plain PyTorch.

The int8 GEMM with its power-of-two requant (and the erf GELU of
Abramowitz & Stegun 7.1.26), the residual junction with the following
integer LayerNorm (M·2^-N), the PTF integer LayerNorm alone, and the
Log-Int-Softmax attention with its exact integer sums, each written out as
the P²-ViT integer pipeline defines it. Integer products run in float64,
exact in any order; every float32 step is rounded on its own. Nothing of
the program is imported.

``act`` (``codes4``) is the control's knob: it rounds every activation code
tensor that an operation produces to 4 bits (16 levels of the same range).
"""

from __future__ import annotations

import torch

from .quant import exp2i, exp_rn, floor_log2i, sqrt_rn

I8 = (-128, 127)
_A = (0.254829592, -0.284496736, 1.421413741, -1.453152027, 1.061405429)  # A&S 7.1.26
EXP_N, AV_SHIFT = 32, 15


def codes8(c):
    return c


def codes4(c):
    """The control's activations: int8 codes rounded to a 4-bit grid."""
    return (torch.clamp(torch.round(c.to(torch.float32) / 16.0), -8, 7) * 16.0).to(c.dtype)


def vec(v, n: int, device):
    return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32, device=device), (n,)).contiguous()


def int_mm(x_q, w_q):
    """Exact Σ_k x[m,k]·w[n,k] as int32."""
    return (x_q.to(torch.float64) @ w_q.to(torch.float64).T).to(torch.int32)


def gelu_as(y):
    a1, a2, a3, a4, a5 = _A
    x = y * 0.7071067811865476
    s, ax = torch.sign(x), x.abs()
    t = torch.reciprocal(1.0 + 0.3275911 * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    return 0.5 * y * (1.0 + s * (1.0 - poly * exp_rn(-ax * ax)))


def requant_mm(x_q, w_q, r, b, out_inv=1.0, gelu=False):
    """clip(round(acc·r + b)), or with GELU clip(round(GELU(acc·r + b)·out_inv))."""
    n, dev = w_q.shape[0], x_q.device
    y = int_mm(x_q, w_q).to(torch.float32) * vec(r, n, dev)[None, :] + vec(b, n, dev)[None, :]
    if gelu:
        y = gelu_as(y) * torch.as_tensor(out_inv, dtype=torch.float32, device=dev)
    return torch.clamp(torch.round(y), *I8).to(torch.int8)


def ln_codes(x, s1, w_os, b_os, ratio):
    """M·2^-N integer LN of PTF-aligned codes ``x`` (M, C), exact row sums,
    then clip(round(y·ratio)) as int8."""
    xi = x.to(torch.int64)
    sx = xi.sum(dim=-1, keepdim=True).to(torch.float32)
    sxx = (xi * xi).sum(dim=-1, keepdim=True).to(torch.float32)
    c = torch.as_tensor(float(x.shape[-1]), dtype=torch.float32, device=x.device)
    mean = (sx / c) * s1
    std = (s1 / c) * sqrt_rn(c * sxx - sx * sx)
    a = (s1 / std) * w_os
    a_abs = a.abs()
    nexp = torch.clamp(7 - floor_log2i(a_abs), 0, 31)
    p2n = exp2i(nexp)
    m = torch.clamp(torch.floor(a_abs * p2n), 0.0, 255.0)
    bb = torch.round((b_os - (mean / std) * w_os) * p2n)
    y = torch.round((torch.sign(a) * m * x + bb) * exp2i(-nexp))
    return torch.clamp(torch.round(y * ratio), *I8).to(torch.int8)


def int_ln(codes, s_in, w, b, out_scale, ratio=1.0):
    """PTF integer LN of (..., C) codes at the producer's scale ``s_in``."""
    c, dev = codes.shape[-1], codes.device
    s_in_v = vec(s_in, c, dev)
    s1 = s_in_v.min()
    mask = torch.round(s_in_v / s1)
    osc = torch.clamp(vec(out_scale, c, dev), min=1e-30)
    x = codes.reshape(-1, c).to(torch.float32) * mask[None, :]
    out = ln_codes(x, s1.reshape(1)[0], (vec(w, c, dev) / osc)[None, :], (vec(b, c, dev) / osc)[None, :],
                   vec(ratio, c, dev)[None, :])
    return out.reshape(codes.shape)


def _junction(mid, res_q, s_mid, s_res, s_out, ln_w, ln_b, ln_out, ratio):
    """res = clip(round((mid·s_mid + res·s_res)·(1/s_out))), then the LN of
    res onto ``ln_out``. Returns (res codes, LN codes)."""
    n, dev = mid.shape[-1], mid.device
    s_out_v = vec(s_out, n, dev)
    s1 = s_out_v.min()
    inv = torch.ones_like(s_out_v) / torch.clamp(s_out_v, min=1e-30)
    osc = torch.clamp(vec(ln_out, n, dev), min=1e-30)
    val = mid * vec(s_mid, n, dev)[None, :] + res_q.to(torch.float32) * vec(s_res, n, dev)[None, :]
    res = torch.clamp(torch.round(val * inv[None, :]), *I8)
    ln = ln_codes(res * torch.round(s_out_v / s1)[None, :], s1, (vec(ln_w, n, dev) / osc)[None, :],
                  (vec(ln_b, n, dev) / osc)[None, :], vec(ratio, n, dev)[None, :])
    return res.to(torch.int8), ln


def mm_res_ln(x_q, w_q, r, b, res_q, s_mid, s_res, s_out, ln_w, ln_b, ln_out, ratio):
    """GEMM + requant to the mid node + residual junction + the next LN."""
    n, dev = w_q.shape[0], x_q.device
    mid = torch.clamp(torch.round(int_mm(x_q, w_q).to(torch.float32) * vec(r, n, dev)[None, :]
                                  + vec(b, n, dev)[None, :]), *I8)
    return _junction(mid, res_q, s_mid, s_res, s_out, ln_w, ln_b, ln_out, ratio)


def res_ln(a_q, s_a, b_q, s_b, s_out, ln_w, ln_b, ln_out, ratio):
    """Elementwise residual junction of two code tensors + the next LN."""
    return _junction(a_q.to(torch.float32), b_q, s_a, s_b, s_out, ln_w, ln_b, ln_out, ratio)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def exact_sum_f32(t):
    """Σ of non-negative integer-valued float32 terms over the last axis,
    exact in int64 limbs, rounded once to float32."""
    hi_f = torch.floor(t * 2.0 ** -32)
    lo = (t - hi_f * 2.0 ** 32).to(torch.int64).sum(dim=-1, keepdim=True)
    hi = hi_f.to(torch.int64).sum(dim=-1, keepdim=True) + (lo >> 32)
    lo = lo & 0xFFFFFFFF
    small = ((hi << 32) + lo).to(torch.float32)
    big = ((hi << 1) | (lo != 0).to(torch.int64)).to(torch.float32) * 2.0 ** 31
    return torch.where(hi < 2 ** 31, small, big)


def lis_exponents(attn_c, s_attn):
    """Log-Int-Softmax exponent q per score (weight 2^-q) from score codes."""
    def full(v):
        return torch.full_like(s_attn, v)
    c0, c1, c2 = 0.35815147, 0.96963238, 1.0
    x0_int = torch.floor(full(-0.6931) / s_attn)
    b_int = torch.floor(full(c1 / c0) / s_attn)
    c_int = torch.floor(full(c2 / c0) / (s_attn * s_attn))
    x_int = attn_c - attn_c.amax(dim=-1, keepdim=True)
    x_int = torch.maximum(x_int, EXP_N * x0_int)
    q = torch.floor(x_int / x0_int)
    r = x_int - x0_int * q
    exp_int = torch.clamp(torch.floor((r * (r + b_int) + c_int) * exp2i(EXP_N - q.to(torch.int32))), min=0.0)
    softmax_out = torch.round(exact_sum_f32(exp_int) / exp_int)
    big = floor_log2i(softmax_out)
    return big + (softmax_out >= 1.5 * exp2i(big)).to(torch.int32)


def scores(q_q, k_q, rq):
    acc = (q_q.to(torch.float64) @ k_q.to(torch.float64).transpose(-1, -2)).to(torch.float32)
    return torch.clamp(torch.round(acc * rq), *I8)


def attend(sc, v_q, s_attn, ro):
    """LIS weights 2^(15-q) (uint4 codes: q ≥ 16 weighs 0) @ v, exact, → int8."""
    big = lis_exponents(sc, s_attn)
    w_int = torch.where(big < 16, exp2i(AV_SHIFT - big), torch.zeros_like(sc))
    av = (w_int.to(torch.float64) @ v_q.to(torch.float64)).to(torch.float32) * 2.0 ** -AV_SHIFT
    return torch.clamp(torch.round(av * torch.as_tensor(ro, dtype=torch.float32, device=sc.device)),
                       *I8).to(torch.int8)


def split_heads(qkv, heads):
    """(B, N, 3C) → (3, B, H, N, d)."""
    b, n, c3 = qkv.shape
    return qkv.reshape(b, n, 3, heads, c3 // (3 * heads)).permute(2, 0, 3, 1, 4)


def merge_heads(av):
    b, h, n, d = av.shape
    return av.permute(0, 2, 1, 3).reshape(b, n, h * d)

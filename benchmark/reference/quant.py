"""Calibration primitives of the plain reference: the minmax power-of-two
observers, the PTF observer, the output-aware weight search, PoT
SmoothQuant and the simulated Log-Int-Softmax, in plain PyTorch.

A frozen copy of the arithmetic P²-ViT's post-training quantization
prescribes (arXiv 2405.19915; FQ-ViT's PTF and LIS, arXiv 2111.13824), op
for op in the order the served program calibrates, so that the same
weights and images give the same scales bit for bit on the same device.
It imports nothing of the program. Every rounding is round-half-to-even.
"""

from __future__ import annotations

import dataclasses

import torch

EPS = float(torch.finfo(torch.float32).eps)
POT_OFFSETS = (-1.0, 0.0, 1.0, 2.0)  # exponents searched around floor(log2 s0)


@dataclasses.dataclass(frozen=True)
class BitType:
    bits: int
    signed: bool

    @property
    def upper(self) -> int:
        return 2 ** (self.bits - 1) - 1 if self.signed else 2 ** self.bits - 1

    @property
    def lower(self) -> int:
        return -(2 ** (self.bits - 1)) if self.signed else 0


UINT3, UINT4, INT4, INT8 = BitType(3, False), BitType(4, False), BitType(4, True), BitType(8, True)
WEIGHT_SWEEP = (UINT3, UINT4, INT4, INT8)  # rows of a weight-scale table, in order
WEIGHT_ROW = {4: 2, 8: 3}  # the row of an eval bit width


# ---------------------------------------------------------------------------
# float primitives
# ---------------------------------------------------------------------------


def layer_norm(x, w, b, eps: float):
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * w + b


def gelu(x):
    return torch.nn.functional.gelu(x, approximate="none")


def linear(x, w, b=None):
    y = x @ w.T
    return y if b is None else y + b


def lp_loss(pred, tgt):
    return ((pred - tgt).abs() ** 2.0).mean()


def fake_quant(x, scale, zp, bt: BitType):
    q = torch.clamp(torch.round(x / scale + zp), bt.lower, bt.upper)
    return (q - zp) * scale


def round_to_pot(x):
    y = torch.floor(torch.log2(x))
    up = (x - 2.0 ** y) > (2.0 ** (y + 1) - x)
    return y + up.to(y.dtype)


# ---------------------------------------------------------------------------
# observers and solvers
# ---------------------------------------------------------------------------


def channel_minmax(v, kind: str, layer_wise: bool):
    m = v.reshape(v.shape[0], -1) if kind == "weight" else v.reshape(-1, v.shape[-1]).T
    mx, mn = m.amax(dim=1), m.amin(dim=1)
    if layer_wise:
        mx, mn = mx.amax(), mn.amin()
    return mn, mx


def _pot_candidates(scale0):
    af = torch.floor(torch.log2(torch.clamp(scale0, min=EPS)))
    offs = torch.tensor(POT_OFFSETS, dtype=af.dtype, device=af.device)
    return af, 2.0 ** (af[None, ...] + offs.reshape((-1,) + (1,) * af.ndim))


def _scale0(mn, mx, bt: BitType):
    return torch.maximum(-mn, mx) / (float(bt.upper - bt.lower) / 2)


def minmax_act(x, bt: BitType = INT8):
    """Layer-wise symmetric PoT scale: the first of four candidates with the
    least fake-quant L2 error. Returns (scale, zp)."""
    mn, mx = channel_minmax(x, "activation", True)
    af, cand = _pot_candidates(_scale0(mn, mx, bt))
    idx = torch.argmin(torch.stack([lp_loss(x, fake_quant(x, s, 0.0, bt)) for s in cand]))
    scale = torch.clamp(2.0 ** (af - 1.0 + idx.to(af.dtype)), min=EPS)
    return scale, torch.zeros_like(scale)


def ptf_act(x, bt: BitType = INT8):
    """Per-channel power-of-two factor on one global scale. Returns (scale[C], zp, mask[C])."""
    mn, mx = channel_minmax(x, "activation", False)
    max_val = torch.maximum(-mn.amin(), mx.amax())
    scale8 = torch.clamp(2.0 * max_val / float(bt.upper - bt.lower), min=EPS)
    scale1 = scale8 / 8.0
    scales = torch.stack([scale1, scale1 * 2, scale1 * 4, scale8])
    lead = tuple(range(x.ndim - 1))
    losses = torch.stack([((x - fake_quant(x, s, 0.0, bt)) ** 2).mean(dim=lead) for s in scales])
    mask = 2.0 ** torch.argmin(losses, dim=0).to(torch.float32)
    return scale1 * mask, torch.zeros((), dtype=torch.float32, device=x.device), mask


def qact(method: str, x):
    """One activation node's state from this batch: minmax or ptf."""
    if method == "ptf":
        s, zp, mask = ptf_act(x)
        return {"scale": s, "zp": zp, "mask": mask}
    if method != "minmax":
        raise NotImplementedError(f"the reference calibrates with minmax and ptf only, not {method}")
    s, zp = minmax_act(x)
    return {"scale": s, "zp": zp}


def _weight_pot(w2d, x2d, bt: BitType, channel_wise: bool):
    mn, mx = channel_minmax(w2d, "weight", not channel_wise)
    af, cand = _pot_candidates(_scale0(mn, mx, bt))
    out_fp = x2d @ w2d.T
    if channel_wise:
        losses = torch.stack([((out_fp - x2d @ fake_quant(w2d, s[:, None], 0.0, bt).T) ** 2).mean(dim=0)
                              for s in cand])
        idx = torch.argmin(losses, dim=0)
    else:
        losses = torch.stack([((out_fp - x2d @ fake_quant(w2d, s, 0.0, bt).T) ** 2).mean() for s in cand])
        idx = torch.argmin(losses)
    return torch.clamp(2.0 ** (af - 1.0 + idx.to(af.dtype)), min=EPS)


def weight_scales(w2d, x2d):
    """(4, O) output-aware PoT weight scales, one row per ``WEIGHT_SWEEP``
    format: channel-wise but for int8's layer-wise scalar."""
    o = w2d.shape[0]
    rows = []
    for bt in WEIGHT_SWEEP:
        cw = bt is not INT8
        s = _weight_pot(w2d, x2d, bt, cw)
        rows.append(torch.broadcast_to(s, (o,)))
    return torch.stack(rows)


def pot_smooth_scale(x, w, alpha: float):
    """PoT-rounded SmoothQuant channel scale (C,)."""
    gx = x.abs().reshape(-1, x.shape[-1]).amax(dim=0)
    cs = gx ** alpha / torch.clamp(w.abs().amax(dim=0) ** (1.0 - alpha), min=EPS)
    return 2.0 ** round_to_pot(torch.clamp(cs, min=EPS))


# ---------------------------------------------------------------------------
# exact exponent-field math and the simulated Log-Int-Softmax
# ---------------------------------------------------------------------------


def floor_log2i(x):
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits >> 23) & 0xFF) - 127


def exp2i(k):
    return ((k.to(torch.int32) + 127) << 23).contiguous().view(torch.float32)


def sqrt_rn(x):
    return torch.sqrt(x.to(torch.float64)).to(torch.float32)


def exp_rn(x):
    return torch.exp(x.to(torch.float64)).to(torch.float32)


def pow2(n):
    """Exact 2**n over the float32 range (subnormals by a mantissa bit)."""
    n_i = n.to(torch.int32)
    normal = exp2i(torch.clamp(n_i, -126, 128))
    sub = (torch.ones_like(n_i) << torch.clamp(n_i + 149, 0, 22)).view(torch.float32)
    out = torch.where(n_i >= -126, normal, torch.where(n_i >= -149, sub, torch.zeros_like(normal)))
    return out.to(torch.promote_types(n.dtype, torch.float32))


def log_round(x):
    xf = x.to(torch.float32)
    bits = xf.contiguous().view(torch.int32)
    e = ((bits >> 23) & 0xFF) - 127
    res = (e + ((bits >> 22) & 1)).to(torch.float32)
    normal = (bits >= 0) & (e > -127) & (e < 128)
    return torch.where(normal, res, torch.floor(torch.log2(xf))).to(torch.promote_types(x.dtype, torch.float32))


def log_int_softmax(x, scale, bt: BitType = UINT4):
    """int exp → round(sum/exp) → log2 round → 2^-q (0 past the code range)."""
    x_int = x / scale
    x_int = x_int - x_int.amax(dim=-1, keepdim=True)
    x0_int = torch.floor(-0.6931 / scale)
    x_int = torch.maximum(x_int, 32 * x0_int)
    q = torch.floor(x_int / x0_int)
    r = x_int - x0_int * q
    c0, c1, c2 = 0.35815147, 0.96963238, 1.0
    b_int = torch.floor((c1 / c0) / scale)
    c_int = torch.floor((c2 / c0) / scale ** 2)
    z = r * (r + b_int) + c_int
    exp_int = torch.clamp(torch.floor(z * pow2(32 - q)), min=0.0)
    rounds = log_round(torch.round(exp_int.sum(dim=-1, keepdim=True) / exp_int))
    mask = rounds >= 2 ** bt.bits
    p = pow2(-torch.clamp(rounds, 0, 2 ** bt.bits - 1))
    return torch.where(mask, torch.zeros_like(p), p)

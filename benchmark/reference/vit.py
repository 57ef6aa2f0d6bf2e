"""Plain reference of the quantized ViT/DeiT (Dosovitskiy et al., arXiv
2010.11929; DeiT, arXiv 2012.12877) under P²-ViT's post-training
quantization: calibration on one batch (PTF integer LN inputs, LIS
attention, PoT SmoothQuant on qkv and fc1, minmax PoT elsewhere), the
freeze into weight codes and requant constants, uint8 ingest, and the
integer forward, all in plain PyTorch.

Each step is worked out here again from the weights and the calibration
images that the benchmark made; nothing of the program is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import intops as io
from .quant import WEIGHT_ROW, gelu, layer_norm, linear, log_int_softmax, pot_smooth_scale, qact, weight_scales

ATTN_ALPHA, MLP_ALPHA = 0.35, 0.5  # the SmoothQuant α of qkv and fc1
QMIN = {4: -8.0, 8: -128.0}
QMAX = {4: 7.0, 8: 127.0}


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    img_size: int
    patch_size: int
    in_chans: int
    num_classes: int
    embed_dim: int
    depth: int
    num_heads: int
    mlp_ratio: float
    ln_eps: float

    @property
    def hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def attn_scale(self) -> float:
        return (self.embed_dim // self.num_heads) ** -0.5


def config(sizes: dict) -> ViTConfig:
    return ViTConfig(**{f.name: sizes[f.name] for f in dataclasses.fields(ViTConfig)})


def patches(x, p: int):
    """(B, C, H, W) → (B, N, C·p·p), K ordered c·p·p + i·p + j."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def _split_qkv(x, heads):
    b, n, c3 = x.shape
    qkv = x.reshape(b, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _merge(x):
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


def _smooth(x, w, bias, alpha, a):
    """SmoothQuant state of qkv / fc1 for the eval bits (4, 8), and the
    smoothed float output that flows on. One α a layer, so both bits keep it."""
    cs = pot_smooth_scale(x, w, alpha)
    x_sm = x / cs
    w_sm = w * cs[None, :]
    q0 = qact(a, x_sm)
    wscale = weight_scales(w_sm, x_sm.reshape(-1, x.shape[-1]))
    st = {"channel_scale": torch.stack([cs, cs]), "qact0_scale": torch.stack([q0["scale"]] * 2),
          "wscale": torch.stack([wscale, wscale])}
    return st, linear(x_sm, w_sm, bias)


@torch.no_grad()
def calibrate(params, cfg: ViTConfig, x, a: str = "minmax", a_ln: str = "ptf") -> dict:
    """The quant state of one calibration batch ``x`` (float32, normalized)."""
    eps = cfg.ln_eps
    qs: dict = {"qact_input": qact(a, x)}
    pt = patches(x, cfg.patch_size)
    pw, pb = params["patch_embed"]["w"], params["patch_embed"]["b"]
    qs["patch"] = {"wscale": weight_scales(pw, pt.reshape(-1, pt.shape[-1]))}
    x = linear(pt, pw, pb)
    qs["patch"]["qact"] = qact(a, x)
    b = x.shape[0]
    x = torch.cat([params["cls_token"].expand(b, 1, cfg.embed_dim), x], dim=1)
    qs["qact_embed"] = qact(a, x)
    qs["qact_pos"] = qact(a, params["pos_embed"])
    x = x + params["pos_embed"]
    qs["qact1"] = qact(a_ln, x)
    qs["blocks"] = []
    for blk in params["blocks"]:
        bq: dict = {}
        h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
        at, h = _smooth(h, blk["qkv"]["w"], blk["qkv"]["b"], ATTN_ALPHA, a)
        at["qact1"] = qact(a, h)
        q, k, v = _split_qkv(h, cfg.num_heads)
        attn = (q @ k.transpose(-1, -2)) * cfg.attn_scale
        at["qact_attn1"] = qact(a, attn)
        attn = log_int_softmax(attn, at["qact_attn1"]["scale"])
        h = _merge(attn @ v)
        at["qact2"] = qact(a, h)
        at["proj_wscale"] = weight_scales(blk["proj"]["w"], h.reshape(-1, cfg.embed_dim))
        h = linear(h, blk["proj"]["w"], blk["proj"]["b"])
        at["qact3"] = qact(a_ln, h)
        bq["attn"] = at
        x = x + h
        bq["qact2"] = qact(a_ln, x)
        h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
        ml, h = _smooth(h, blk["fc1"]["w"], blk["fc1"]["b"], MLP_ALPHA, a)
        h = gelu(h)
        ml["qact1"] = qact(a, h)
        ml["fc2_wscale"] = weight_scales(blk["fc2"]["w"], h.reshape(-1, cfg.hidden_dim))
        h = linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
        ml["qact2"] = qact(a_ln, h)
        bq["mlp"] = ml
        x = x + h
        bq["qact4"] = qact(a_ln, x)
        qs["blocks"].append(bq)
    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps)[:, 0]
    qs["qact2"] = qact(a, x)
    qs["head_wscale"] = weight_scales(params["head"]["w"], x)
    x = linear(x, params["head"]["w"], params["head"]["b"])
    qs["act_out"] = qact(a, x)
    return qs


# ---------------------------------------------------------------------------
# freeze
# ---------------------------------------------------------------------------


def _wcodes(w, sw, bit):
    return torch.clamp(torch.round(w / sw[:, None]), QMIN[bit], QMAX[bit]).to(torch.int8)


def freeze(params, qs, cfg: ViTConfig, bits: int, mean, std) -> dict:
    """Weight codes and requant constants at a uniform weight bit width, and
    the uint8 ingest's constants."""
    j = {4: 0, 8: 1}[bits]
    row = WEIGHT_ROW[bits]

    def smooth_layer(st, w, b):
        cs = st["channel_scale"][j]
        sw = st["wscale"][j][row]
        return {"w_q": _wcodes(w * cs[None, :], sw, bits), "sw": sw, "s_act": st["qact0_scale"][j], "cs": cs,
                "bias": b}

    def plain_layer(wtab, w, b):
        return {"w_q": _wcodes(w, wtab[row], bits), "sw": wtab[row], "bias": b}

    s: dict = {"s_input": qs["qact_input"]["scale"]}
    s["patch"] = plain_layer(qs["patch"]["wscale"], params["patch_embed"]["w"], params["patch_embed"]["b"])
    s["patch"]["s_out"] = qs["patch"]["qact"]["scale"]
    s2 = qs["qact_embed"]["scale"]
    s["cls_codes"] = torch.clamp(torch.round(params["cls_token"] / s2), *io.I8).to(torch.int8)
    s["s_embed"] = s2
    sp = qs["qact_pos"]["scale"]
    s["pos_codes"] = torch.clamp(torch.round(params["pos_embed"] / sp), *io.I8)
    s["s_pos"] = sp
    s["s_qact1"] = qs["qact1"]["scale"]
    s["blocks"] = []
    for blk, bq in zip(params["blocks"], qs["blocks"]):
        aq, mq = bq["attn"], bq["mlp"]
        sb = {"norm1_w": blk["norm1"]["w"], "norm1_b": blk["norm1"]["b"],
              "norm2_w": blk["norm2"]["w"], "norm2_b": blk["norm2"]["b"],
              "qkv": smooth_layer(aq, blk["qkv"]["w"], blk["qkv"]["b"]),
              "s_qact1": aq["qact1"]["scale"], "s_attn1": aq["qact_attn1"]["scale"],
              "s_qact2a": aq["qact2"]["scale"],
              "proj": plain_layer(aq["proj_wscale"], blk["proj"]["w"], blk["proj"]["b"]),
              "s_qact3": aq["qact3"]["scale"], "s_res1": bq["qact2"]["scale"],
              "fc1": smooth_layer(mq, blk["fc1"]["w"], blk["fc1"]["b"]),
              "s_mq1": mq["qact1"]["scale"],
              "fc2": plain_layer(mq["fc2_wscale"], blk["fc2"]["w"], blk["fc2"]["b"]),
              "s_mq2": mq["qact2"]["scale"], "s_res2": bq["qact4"]["scale"]}
        # the reference model's norm2 output quantizer takes attn's channel scale
        sb["norm2_cs"] = aq["channel_scale"][j]
        sb["norm2_ratio"] = sb["norm2_cs"] / mq["channel_scale"][j]
        s["blocks"].append(sb)
    s["norm_w"], s["norm_b"] = params["norm"]["w"], params["norm"]["b"]
    s["s_qact2"] = qs["qact2"]["scale"]
    s["head"] = plain_layer(qs["head_wscale"], params["head"]["w"], params["head"]["b"])
    s["s_out"] = qs["act_out"]["scale"]
    dev = s["s_input"].device
    s["mean"] = torch.from_numpy(np.asarray(mean, np.float32).reshape(3)).to(dev)
    s["std"] = torch.from_numpy(np.asarray(std, np.float32).reshape(3)).to(dev)
    return s


def normalize_u8(x, mean, std):
    """uint8 (B, 3, H, W) → (u/255 − mean)/std in float32, each divide by a tensor."""
    f = x.to(torch.float32) / torch.full((), 255.0, dtype=torch.float32, device=x.device)
    return (f - mean[:, None, None]) / std[:, None, None]


# ---------------------------------------------------------------------------
# the integer forward
# ---------------------------------------------------------------------------


def _prologue(s, cfg: ViTConfig, x, act):
    """uint8 images → (h, xc): block 0's LN1 codes and the qact1 residual codes."""
    c = cfg.embed_dim
    p = s["patch"]
    x_q = torch.clamp(torch.round(normalize_u8(x, s["mean"], s["std"]) / s["s_input"]), *io.I8).to(torch.int8)
    pt = patches(act(x_q), cfg.patch_size).contiguous()
    b, n_patch, k = pt.shape
    sq1 = torch.broadcast_to(s["s_qact1"].to(torch.float32), (c,))
    dev = pt.device
    acc = io.int_mm(pt.reshape(-1, k), p["w_q"]).reshape(b, n_patch, c)
    mid1 = torch.clamp(torch.round(acc.to(torch.float32) * io.vec(s["s_input"] * p["sw"] / p["s_out"], c, dev)
                                   + io.vec(p["bias"] / p["s_out"], c, dev)), *io.I8)
    r2 = torch.as_tensor(p["s_out"] / s["s_embed"], dtype=torch.float32, device=dev).reshape(())
    s_emb = torch.as_tensor(s["s_embed"], dtype=torch.float32, device=dev).reshape(())
    mid2 = torch.clamp(torch.round(mid1 * r2), *io.I8)
    pos_val = (s["pos_codes"][0, 1:, :] * s["s_pos"]).to(torch.float32)
    xcp = torch.clamp(torch.round((mid2 * s_emb + pos_val[None]) / io.vec(sq1, c, dev)), *io.I8)
    cls_val = s["cls_codes"].to(torch.float32) * s["s_embed"] + s["pos_codes"][:, :1, :] * s["s_pos"]
    cls_xc = torch.clamp(torch.round(cls_val / sq1), *io.I8).to(torch.int8).reshape(1, 1, c)
    xc = torch.cat([cls_xc.to(torch.float32).expand(b, 1, c), xcp], dim=1)
    qkv0 = s["blocks"][0]["qkv"]
    s1 = sq1.min()
    osc = torch.clamp(torch.broadcast_to((qkv0["s_act"] * qkv0["cs"]).to(torch.float32), (c,)), min=1e-30)
    w_os = io.vec(s["blocks"][0]["norm1_w"].to(torch.float32) / osc, c, dev)
    b_os = io.vec(s["blocks"][0]["norm1_b"].to(torch.float32) / osc, c, dev)
    h = io.ln_codes(xc * io.vec(torch.round(sq1 / s1), c, dev)[None, None, :],
                    torch.as_tensor(s1, dtype=torch.float32, device=dev).reshape(()), w_os, b_os, 1.0)
    return act(h), act(xc.to(torch.int8))


def _layer(s, cfg: ViTConfig, bi: int, h, xc, act):
    """One encoder layer on codes: qkv + LIS attention, the proj junction
    with LN2, fc1 + GELU, the fc2 junction with the next LN."""
    blocks = s["blocks"]
    sb = blocks[bi]
    qkv, pr, fc1, fc2 = sb["qkv"], sb["proj"], sb["fc1"], sb["fc2"]
    s_prev = s["s_qact1"] if bi == 0 else blocks[bi - 1]["s_res2"]
    if bi + 1 < len(blocks):
        nb = blocks[bi + 1]
        lnn = (nb["norm1_w"], nb["norm1_b"], nb["qkv"]["s_act"] * nb["qkv"]["cs"], 1.0)
    else:
        lnn = (s["norm_w"], s["norm_b"], s["s_qact2"], 1.0)
    b, n, c = h.shape
    heads = cfg.num_heads
    dev = h.device
    t = io.requant_mm(h.reshape(-1, c), qkv["w_q"], qkv["s_act"] * qkv["sw"] / sb["s_qact1"],
                      qkv["bias"] / sb["s_qact1"])
    q, k, v = io.split_heads(act(t).reshape(b, n, 3 * c), heads)
    rq = torch.as_tensor(sb["s_qact1"] ** 2 * cfg.attn_scale / sb["s_attn1"], dtype=torch.float32, device=dev)
    sa = torch.as_tensor(sb["s_attn1"], dtype=torch.float32, device=dev)
    ro = torch.as_tensor(sb["s_qact1"] / sb["s_qact2a"], dtype=torch.float32, device=dev)
    h = act(io.merge_heads(io.attend(io.scores(q, k, rq), v, sa, ro)))
    xc2, h = io.mm_res_ln(h.reshape(-1, c), pr["w_q"], sb["s_qact2a"] * pr["sw"] / sb["s_qact3"],
                          pr["bias"] / sb["s_qact3"], xc.reshape(-1, c), sb["s_qact3"], s_prev, sb["s_res1"],
                          sb["norm2_w"], sb["norm2_b"], fc1["s_act"] * sb["norm2_cs"], sb["norm2_ratio"])
    h = act(io.requant_mm(act(h), fc1["w_q"], fc1["s_act"] * fc1["sw"], fc1["bias"], out_inv=1.0 / sb["s_mq1"],
                          gelu=True))
    xc2, h = io.mm_res_ln(h, fc2["w_q"], sb["s_mq1"] * fc2["sw"] / sb["s_mq2"], fc2["bias"] / sb["s_mq2"],
                          act(xc2), sb["s_mq2"], sb["s_res1"], sb["s_res2"], *lnn)
    return act(h).reshape(b, n, c), act(xc2).reshape(b, n, c)


@torch.no_grad()
def forward(s, cfg: ViTConfig, x, act=io.codes8):
    """uint8 images (B, 3, H, W) → float32 logits (B, classes)."""
    h, xc = _prologue(s, cfg, x, act)
    for bi in range(len(s["blocks"])):
        h, xc = _layer(s, cfg, bi, h, xc, act)
    hd = s["head"]
    logits = io.requant_mm(h[:, 0].contiguous(), hd["w_q"], s["s_qact2"] * hd["sw"] / s["s_out"],
                           hd["bias"] / s["s_out"])
    return logits.to(torch.float32) * s["s_out"]


"""Int8 serving pipeline (counterpart of ``p2vit_tpu/serving.py``).

``convert`` specializes (params, QuantState, bit_config) into a serving
state of int8 weight codes and requant constants; ``serving_forward`` runs
the network on int8 codes. The default flags (``fuse_embed=True,
fuse_qkv=True, fuse_layer=False``, the JAX package's default, unrolled) run
four kernels:

  * ``ops/embed_fused.fused_patch_embed``: image codes → block-0 inputs,
  * ``ops/attention_lis.lis_attention_qkv_fused``: qkv + attention,
  * ``ops/matmul_ln.int8_matmul_res_ln``: proj / fc2 + residual + next LN,
  * ``ops/matmul_int8.int8_matmul_requant``: fc1 + GELU, and the head.

The staged flags run the same codes through more, smaller steps:
``fuse_embed=False`` the patch GEMM (``int8_matmul_requant``), the [CLS] and
position add in PyTorch and block 0's LN1 (``ops/intln.int_ln_requant``);
``fuse_qkv=False`` the qkv GEMM (``int8_matmul_requant``) and
``ops/attention_lis.lis_attention_fused`` over the (B, N, 3C) codes.
``fuse_layer=True`` runs each encoder layer in one launch
(``ops/layer_fused.fused_vit_layer``; it overrides ``fuse_qkv``). All give
the default path's logits bit for bit. Every layer is driven from its 29
constants (``layer_consts``; ``stack_layer_consts`` stacks them over depth)
by ``apply_unfused_layer`` or ``apply_fused_layer``. ``lis=False`` runs
every attention kernel's fp32 softmax arm. ``attach_u8_ingest`` lets the
forward take raw uint8 images. ``weight_only_params`` dequantizes the same
weight codes into float32 params for a bf16 ``fp_forward`` (weight-only
serving). Not ported: the TPU-only arms (``scan_layers``, the ``resln`` and
``lis="bypass"`` timing probes).

Numerics: every requant scale the PoT search produces is a power of two,
so the requant multiplies are exact; serving is compared with the
simulation statistically, and with the JAX serving path code for code.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import QuantPolicy
from .models.common import ViTConfig, extract_patches
from .ops import attention_lis, embed_fused, intln, layer_fused, matmul_int8, matmul_ln

_I8 = (-128, 127)


def _wcodes(w, scale, qmin, qmax):
    """Weight → int8 codes under a per-out-channel PoT scale."""
    return torch.clamp(torch.round(w / scale[:, None]), qmin, qmax).to(torch.int8)


def _bit_bounds(bit):
    return (-8, 7) if bit == 4 else (-128, 127)


# ---------------------------------------------------------------------------
# uint8 image ingestion
# ---------------------------------------------------------------------------


def u8_ingest_consts(mean, std, s_input=None, device=None):
    """Constants for ingesting raw uint8 images instead of host-normalized
    float32 (a quarter of the host → device bytes; the host skips the
    normalize).

    The host pipeline emits ``x = (u/255 − mean)/std`` in float32; the
    device replays that op sequence (``_u8_normalize``), so a uint8 batch
    gives the host-normalized batch bit for bit. ``host`` is that sequence's
    (256, 3) table, computed on the host in numpy float32 as the JAX package
    computes its tables. With ``s_input`` (the ViT qact_input scale) also the
    fused affine ``clip(round(u·a + b))`` and the golden codes ``lut``, so
    that ``u8_ingest_exact`` can prove either form on the serving device.
    The tensors go to ``s_input``'s device, else to ``device``."""
    mean = np.asarray(mean, np.float32).reshape(3)
    std = np.asarray(std, np.float32).reshape(3)
    dev = device if s_input is None else torch.as_tensor(s_input).device
    v = np.arange(256, dtype=np.float32)[:, None]  # (256, 1)
    x = (v / np.float32(255.0) - mean[None]) / std[None]  # the host sequence
    out = {"mean": mean, "std": std, "host": x}
    if s_input is not None:
        s_in = np.float32(torch.as_tensor(s_input).detach().cpu().numpy().reshape(()))
        out["lut"] = np.clip(np.round(x / s_in), -128, 127).astype(np.int8)
        out["a"] = np.float32(1.0) / (np.float32(255.0) * std * s_in)
        out["b"] = -mean / (std * s_in)
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in out.items()}


def attach_u8_ingest(s, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
    """Enable uint8 ingestion on a converted serving state (in place).
    ``mean``/``std`` are the host pipeline's normalization."""
    s["u8"] = u8_ingest_consts(mean, std, s_input=s["s_input"])
    return s


def _u8_normalize(x, u8):
    """(B, 3, H, W) uint8 → (u/255 − mean)/std in float32, op for op as the
    host does. Every divide is tensor by tensor: PyTorch's CUDA division by
    a Python scalar multiplies by the reciprocal."""
    f = x.to(torch.float32) / torch.full((), 255.0, dtype=torch.float32, device=x.device)
    return (f - u8["mean"][:, None, None]) / u8["std"][:, None, None]


def _u8_exact_codes(x, u8, s_input):
    """uint8 images → input codes by the literal host sequence, then the
    input quantizer: bit for bit the codes of float32 ingestion."""
    return torch.clamp(torch.round(_u8_normalize(x, u8) / s_input), *_I8).to(torch.int8)


def _u8_affine_codes(x, u8):
    """uint8 images → input codes through the fused affine u·a + b. Use only
    after ``u8_ingest_exact(s, affine=True)`` returned True on this device."""
    f = x.to(torch.float32) * u8["a"][:, None, None] + u8["b"][:, None, None]
    return torch.clamp(torch.round(f), *_I8).to(torch.int8)


def u8_ingest_exact(s, affine: bool = False) -> bool:
    """Prove by enumeration that device-side uint8 ingestion gives the host's
    results for every uint8 value and channel, 768 cases, on the device the
    serving state lives on: the input codes against ``lut`` (ViT; with
    ``affine=True`` through the fused multiply-add), or, for a state without
    ``lut`` (Swin), the normalized values against ``host``."""
    u8 = s["u8"]
    v = torch.arange(256, dtype=torch.uint8, device=u8["host"].device)[None, None, :, None]
    v = v.expand(1, 3, 256, 1)
    if "lut" not in u8:
        if affine:
            raise ValueError("the fused affine needs the input quantizer's scale (ViT states)")
        return bool((_u8_normalize(v, u8) == u8["host"].T[None, :, :, None]).all())
    got = _u8_affine_codes(v, u8) if affine else _u8_exact_codes(v, u8, s["s_input"])
    return bool((got == u8["lut"].T[None, :, :, None]).all())


def _input_codes(s, x, u8_affine: bool = False):
    """Image batch (float32 normalized, or raw uint8 once the state carries
    the ingestion constants) → qact_input int8 codes."""
    if x.dtype == torch.uint8:
        if "u8" not in s:
            raise ValueError("uint8 batch but no ingestion constants: call "
                             "serving.attach_u8_ingest(s, mean, std) after convert()")
        if u8_affine:
            return _u8_affine_codes(x, s["u8"])
        return _u8_exact_codes(x, s["u8"], s["s_input"])
    if x.dtype != torch.float32:
        raise TypeError(f"serving takes float32 or uint8 images, got {x.dtype}")
    return torch.clamp(torch.round(x / s["s_input"]), *_I8).to(torch.int8)


def convert(params, qstate, cfg: ViTConfig, policy: QuantPolicy, bit_config) -> dict:
    """Specialize calibrated state to a fixed bit_config for serving."""
    if not policy.int_norm:
        raise ValueError("the int8 serving path requires the PTF integer-LN pipeline")
    bits = [int(b) for b in bit_config]
    n_idx = {4: 0, 8: 1}

    def smooth_layer(state, w, b, bit):
        j = n_idx[bit]
        cs = state["channel_scale"][j]
        sw = state["wscale"][j][2 + j]
        qmin, qmax = _bit_bounds(bit)
        return {"w_q": _wcodes(w * cs[None, :], sw, qmin, qmax), "sw": sw,
                "s_act": state["qact0_scale"][j], "cs": cs, "bias": b}

    def plain_layer(wscale_dic, w, b, bit):
        j = n_idx[bit]
        sw = wscale_dic[2 + j]
        qmin, qmax = _bit_bounds(bit)
        return {"w_q": _wcodes(w, sw, qmin, qmax), "sw": sw, "bias": b}

    s: dict = {"s_input": qstate["qact_input"]["scale"]}
    s["patch"] = plain_layer(qstate["patch"]["wscale"], params["patch_embed"]["w"],
                             params["patch_embed"]["b"], bits[0])
    s["patch"]["s_out"] = qstate["patch"]["qact"]["scale"]
    s2 = qstate["qact_embed"]["scale"]
    s["cls_codes"] = torch.clamp(torch.round(params["cls_token"] / s2), *_I8).to(torch.int8)
    s["s_embed"] = s2
    sp = qstate["qact_pos"]["scale"]
    s["pos_codes"] = torch.clamp(torch.round(params["pos_embed"] / sp), *_I8)
    s["s_pos"] = sp
    s["s_qact1"] = qstate["qact1"]["scale"]

    s["blocks"] = []
    for i, blk in enumerate(params["blocks"]):
        bq = qstate["blocks"][i]
        aq, mq = bq["attn"], bq["mlp"]
        b_qkv, b_proj, b_fc1, b_fc2 = bits[1 + 4 * i: 5 + 4 * i]
        jq, jm = n_idx[b_qkv], n_idx[b_fc1]
        if policy.int_softmax:
            attention_lis.check_lis_scale(aq["qact_attn1"]["scale"])
        sb = {
            "norm1_w": blk["norm1"]["w"], "norm1_b": blk["norm1"]["b"],
            "norm2_w": blk["norm2"]["w"], "norm2_b": blk["norm2"]["b"],
            "qkv": smooth_layer(aq, blk["qkv"]["w"], blk["qkv"]["b"], b_qkv),
            "s_qact1": aq["qact1"]["scale"],
            "s_attn1": aq["qact_attn1"]["scale"],
            "s_qact2a": aq["qact2"]["scale"],
            "proj": plain_layer(aq["proj_wscale"], blk["proj"]["w"], blk["proj"]["b"], b_proj),
            "s_qact3": aq["qact3"]["scale"],
            "s_res1": bq["qact2"]["scale"],
            "mlp_fc1": smooth_layer(mq, blk["fc1"]["w"], blk["fc1"]["b"], b_fc1),
            "s_mq1": mq["qact1"]["scale"],
            "fc2": plain_layer(mq["fc2_wscale"], blk["fc2"]["w"], blk["fc2"]["b"], b_fc2),
            "s_mq2": mq["qact2"]["scale"],
            "s_res2": bq["qact4"]["scale"],
        }
        cs_m = mq["channel_scale"][jm]
        norm2_cs = aq["channel_scale"][jq] if policy.norm2_attn_channel_scale_compat else cs_m
        sb["norm2_cs"] = norm2_cs
        sb["norm2_ratio"] = norm2_cs / cs_m
        s["blocks"].append(sb)
    s["norm_w"] = params["norm"]["w"]
    s["norm_b"] = params["norm"]["b"]
    s["s_qact2"] = qstate["qact2"]["scale"]
    s["head"] = plain_layer(qstate["head_wscale"], params["head"]["w"], params["head"]["b"],
                            bits[-1])
    s["s_out"] = qstate["act_out"]["scale"]
    s["bits"] = tuple(bits)
    s["lis"] = 1 if policy.int_softmax else 0
    return s


def weight_only_params(params, qstate, cfg: ViTConfig, policy: QuantPolicy, bit_config) -> dict:
    """Weight-only quantized serving (W4/W8, float activations): the exact
    weight codes the int8 pipeline serves, dequantized back into a copy of
    ``params`` (float32, on the params' device) for ``vit.fp_forward``.

    On the SmoothQuant layers (qkv, fc1) the int8 path serves fq(w·cs)
    against activations smoothed by 1/cs; weight-only serving takes the
    unsmoothed activations, so the effective weight is w_q·sw/cs. Every
    other weight, the patch embed and the head included, is w_q·sw. sw and
    cs are powers of two, so requantizing the result with the serving scales
    gives ``convert``'s codes bit for bit. Every non-weight leaf is the
    caller's own tensor. Cast and serve::

        pw = serving.weight_only_params(params, qstate, cfg, policy, bits)
        pw16 = {bf16 copy of pw}
        logits = vit.fp_forward(pw16, cfg, x.to(torch.bfloat16))
    """
    if not policy.int_norm:
        raise ValueError(
            "weight-only serving freezes convert()'s weight codes, which are defined by the PTF "
            "integer-LN calibration pipeline (policy.int_norm=True): ptf=False changes the LN-output "
            "observers and therefore the SmoothQuant channel scales the codes are built from. "
            "Recalibrate with ptf=True, or run the simulation path for ptf=False ablations.")
    s = convert(params, qstate, cfg, policy, bit_config)

    def smooth_eff(layer):
        return layer["w_q"].to(torch.float32) * layer["sw"][:, None] / layer["cs"][None, :]

    def plain_eff(layer):
        return layer["w_q"].to(torch.float32) * layer["sw"][:, None]

    new = dict(params)
    new["patch_embed"] = {**params["patch_embed"], "w": plain_eff(s["patch"])}
    new["head"] = {**params["head"], "w": plain_eff(s["head"])}
    new["blocks"] = [
        {**blk,
         "qkv": {**blk["qkv"], "w": smooth_eff(sb["qkv"])},
         "proj": {**blk["proj"], "w": plain_eff(sb["proj"])},
         "fc1": {**blk["fc1"], "w": smooth_eff(sb["mlp_fc1"])},
         "fc2": {**blk["fc2"], "w": plain_eff(sb["fc2"])}}
        for blk, sb in zip(params["blocks"], s["blocks"])
    ]
    return new


def _embed_fused_consts(s, cfg: ViTConfig):
    """Constants of ``fused_patch_embed``, formed as the JAX twin forms them."""
    c = cfg.embed_dim
    p = s["patch"]
    sq1 = torch.broadcast_to(s["s_qact1"].to(torch.float32), (c,))
    # the [CLS] row of xc is image-independent: cls codes + pos row 0 → qact1
    cls_val = (s["cls_codes"].to(torch.float32) * s["s_embed"]
               + s["pos_codes"][:, :1, :] * s["s_pos"])
    cls_xc = torch.clamp(torch.round(cls_val / sq1), *_I8).to(torch.int8)
    qkv0 = s["blocks"][0]["qkv"]
    s1 = sq1.min()
    osc = torch.clamp(torch.broadcast_to((qkv0["s_act"] * qkv0["cs"]).to(torch.float32), (c,)),
                      min=1e-30)
    return dict(
        patch_requant=s["s_input"] * p["sw"] / p["s_out"],
        patch_bias=p["bias"] / p["s_out"],
        embed_requant=p["s_out"] / s["s_embed"],
        s_embed=s["s_embed"],
        pos_val=s["pos_codes"][0, 1:, :] * s["s_pos"],
        cls_xc=cls_xc.reshape(1, c),
        s_qact1=sq1,
        ln_mask=torch.round(sq1 / s1),
        ln_s1=s1,
        ln_w_os=s["blocks"][0]["norm1_w"].to(torch.float32) / osc,
        ln_b_os=s["blocks"][0]["norm1_b"].to(torch.float32) / osc,
    )


def _int_ln_codes(c_in, s_in, w, b, out_scale, ratio, use_kernels=True):
    """Integer LN on codes (..., C) at the producer's scale ``s_in`` → codes
    of the consumer node through ``int_ln_requant`` (or its plain version)."""
    c = c_in.shape[-1]
    s_in_v = torch.broadcast_to(torch.as_tensor(s_in, dtype=torch.float32, device=c_in.device), (c,))
    s1 = s_in_v.min()
    fn = intln.int_ln_requant if use_kernels else intln.int_ln_requant_plain
    out = fn(c_in.reshape(-1, c).contiguous(), torch.round(s_in_v / s1), s1, w, b, out_scale, ratio)
    return out.reshape(c_in.shape)


def embed_codes(s, cfg: ViTConfig, x, use_kernels: bool = True, fuse_embed: bool = True,
                u8_affine: bool = False):
    """The serving prologue: image → (h, xc), block 0's LN1 codes and the
    qact1 residual codes. Quantizes BEFORE extracting patches (the two
    commute), so the patch reorder moves int8 codes.

    ``fuse_embed``: the whole prologue in ``fused_patch_embed``; False runs
    it staged (patch GEMM, [CLS] and position add, block 0's LN1), bit for
    bit the same codes. ``x``: float32, or uint8 after ``attach_u8_ingest``."""
    patches = extract_patches(_input_codes(s, x, u8_affine), cfg.patch_size).contiguous()
    if fuse_embed:
        fn = embed_fused.fused_patch_embed if use_kernels else embed_fused.fused_patch_embed_plain
        xc, h = fn(patches, s["patch"]["w_q"], **_embed_fused_consts(s, cfg))
        return h, xc
    mm = matmul_int8.int8_matmul_requant if use_kernels else matmul_int8.int8_matmul_requant_plain
    b = x.shape[0]
    c = cfg.embed_dim
    p = s["patch"]
    c1 = mm(patches.reshape(-1, patches.shape[-1]), p["w_q"], s["s_input"] * p["sw"] / p["s_out"],
            p["bias"] / p["s_out"]).reshape(b, -1, c)
    # [cls; patches] at the embed scale, + positional codes → qact1 codes
    c1 = torch.clamp(torch.round(c1.to(torch.float32) * (p["s_out"] / s["s_embed"])), *_I8)
    c_cls = s["cls_codes"].to(torch.float32).expand(b, 1, c)
    val = torch.cat([c_cls, c1], dim=1) * s["s_embed"] + s["pos_codes"] * s["s_pos"]
    xc = torch.clamp(torch.round(val / s["s_qact1"]), *_I8).to(torch.int8)
    qkv0 = s["blocks"][0]["qkv"]
    h = _int_ln_codes(xc, s["s_qact1"], s["blocks"][0]["norm1_w"], s["blocks"][0]["norm1_b"],
                      qkv0["s_act"] * qkv0["cs"], 1.0, use_kernels)
    return h, xc


def head_logits(s, h, use_kernels: bool = True):
    """The serving epilogue: final-norm codes (h[:, 0]) → head → f32 logits."""
    mm = matmul_int8.int8_matmul_requant if use_kernels else matmul_int8.int8_matmul_requant_plain
    hd = s["head"]
    logits_c = mm(h[:, 0].contiguous(), hd["w_q"], s["s_qact2"] * hd["sw"] / s["s_out"],
                  hd["bias"] / s["s_out"])
    return logits_c.to(torch.float32) * s["s_out"]


def layer_consts(s, cfg: ViTConfig, bi: int) -> tuple:
    """The 29 constants of encoder layer ``bi`` in ``stack_layer_consts``'s
    order, unbroadcast, as the four-kernel pipeline forms them: the qkv
    weight and epilogue and the attention's three scalars; the proj weight
    and epilogue, the junction's s_mid, s_res_prev and s_res1, and LN2's w,
    b, out-scale and ratio; the fc1 weight, epilogue and 1/s_mq1; the fc2
    weight and epilogue, s_mid2, s_res2, and the LN fused after fc2 (the
    next block's LN1, or the final norm after the last block)."""
    blocks = s["blocks"]
    sb = blocks[bi]
    qkv, pr, fc1, fc2 = sb["qkv"], sb["proj"], sb["mlp_fc1"], sb["fc2"]
    s_prev = s["s_qact1"] if bi == 0 else blocks[bi - 1]["s_res2"]
    if bi + 1 < len(blocks):
        nb = blocks[bi + 1]
        lnn = (nb["norm1_w"], nb["norm1_b"], nb["qkv"]["s_act"] * nb["qkv"]["cs"], 1.0)
    else:
        lnn = (s["norm_w"], s["norm_b"], s["s_qact2"], 1.0)
    return (
        qkv["w_q"], qkv["s_act"] * qkv["sw"] / sb["s_qact1"], qkv["bias"] / sb["s_qact1"],
        sb["s_qact1"] ** 2 * cfg.attn_scale / sb["s_attn1"], sb["s_attn1"],
        sb["s_qact1"] / sb["s_qact2a"],
        pr["w_q"], sb["s_qact2a"] * pr["sw"] / sb["s_qact3"], pr["bias"] / sb["s_qact3"],
        sb["s_qact3"], s_prev, sb["s_res1"],
        sb["norm2_w"], sb["norm2_b"], fc1["s_act"] * sb["norm2_cs"], sb["norm2_ratio"],
        fc1["w_q"], fc1["s_act"] * fc1["sw"], fc1["bias"], 1.0 / sb["s_mq1"],
        fc2["w_q"], sb["s_mq1"] * fc2["sw"] / sb["s_mq2"], fc2["bias"] / sb["s_mq2"],
        sb["s_mq2"], sb["s_res2"], *lnn,
    )


def stack_layer_consts(s, cfg: ViTConfig) -> tuple:
    """Every per-layer constant of the fused-layer kernel stacked along a
    leading depth axis, in ``apply_fused_layer``'s order (the JAX package's
    29-tuple): the three int8 weights as they are, the rest float32
    broadcast to (3C,), (C,), (hid,) or ()."""
    c = cfg.embed_dim
    hid = s["blocks"][0]["mlp_fc1"]["w_q"].shape[0]
    dev = s["blocks"][0]["qkv"]["w_q"].device
    shapes = (None, (3 * c,), (3 * c,), (), (), (), None, *[(c,)] * 9, None, (hid,), (hid,), (),
              None, *[(c,)] * 8)
    per = [layer_consts(s, cfg, bi) for bi in range(len(s["blocks"]))]

    def entry(v, shape):
        if shape is None:
            return v
        return torch.broadcast_to(torch.as_tensor(v, dtype=torch.float32, device=dev), shape)

    return tuple(torch.stack([entry(layer[i], shape) for layer in per]) for i, shape in enumerate(shapes))


def apply_unfused_layer(cfg: ViTConfig, layer, h, xc, lis=True, fuse_qkv=True, use_kernels=True):
    """ONE encoder layer on (B, N, C) codes from ``layer_consts`` (or a
    ``stack_layer_consts`` slice) through the four-kernel pipeline: the
    attention (qkv-fused, or the qkv GEMM then the attention over the qkv
    codes), the proj junction with LN2, fc1 + GELU, and the fc2 junction with
    the next LN. Returns (h', xc')."""
    (w_qkv, qr, qb, srq, sat, oro, w_proj, prr, prb, smid, sprev, sres1, ln2w, ln2b, ln2o, ln2r,
     w_fc1, f1r, f1b, f1inv, w_fc2, f2r, f2b, smid2, sres2, lnnw, lnnb, lnno, lnnr) = layer
    if use_kernels:
        res_ln, mm = matmul_ln.int8_matmul_res_ln, matmul_int8.int8_matmul_requant
    else:
        res_ln, mm = matmul_ln.int8_matmul_res_ln_plain, matmul_int8.int8_matmul_requant_plain
    b, n_tok, c = h.shape
    if fuse_qkv:
        attn_qkv = (attention_lis.lis_attention_qkv_fused if use_kernels
                    else attention_lis.lis_attention_qkv_fused_plain)
        h = attn_qkv(h, w_qkv, qr, qb, cfg.num_heads, srq, sat, oro, lis=lis)
    else:
        attn = attention_lis.lis_attention_fused if use_kernels else attention_lis.lis_attention_fused_plain
        h = mm(h.reshape(-1, c), w_qkv, qr, qb).reshape(b, n_tok, 3 * c)
        h = attn(h, cfg.num_heads, srq, sat, oro, lis=lis)
    # proj + residual junction + int-LN2: the qact2 residual carrier and
    # the mlp's qact0 input codes
    xc2, h = res_ln(h.reshape(-1, c), w_proj, prr, prb, xc.reshape(-1, c), smid, sprev, sres1,
                    ln2w, ln2b, ln2o, ln2r)
    h = mm(h, w_fc1, f1r, f1b, out_inv=f1inv, gelu=True)
    # fc2 + residual + the NEXT LayerNorm
    xc2, h = res_ln(h, w_fc2, f2r, f2b, xc2, smid2, sres1, sres2, lnnw, lnnb, lnno, lnnr)
    return h.reshape(b, n_tok, c), xc2.reshape(b, n_tok, c)


def apply_fused_layer(cfg: ViTConfig, layer, h, xc, lis=True, use_kernels=True):
    """ONE encoder layer on (B, N, C) codes from ``layer_consts`` (or a
    ``stack_layer_consts`` slice) in one ``fused_vit_layer`` launch (its
    plain version with ``use_kernels=False``). Returns (h', xc')."""
    fn = layer_fused.fused_vit_layer if use_kernels else layer_fused.fused_vit_layer_plain
    return fn(h, xc, *layer[:3], cfg.num_heads, *layer[3:], lis=lis)


@torch.no_grad()
def serving_forward(s, cfg: ViTConfig, x, use_kernels: bool = True, lis: bool = True,
                    fuse_embed: bool = True, fuse_qkv: bool = True, fuse_layer: bool = False,
                    u8_affine: bool = False):
    """Run the int8 pipeline on an image batch (B, 3, H, W), float32
    normalized or raw uint8 after ``attach_u8_ingest``; returns float32
    logits (B, num_classes).

    ``use_kernels``: the kernel wrappers (CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors). False calls the plain versions
    directly on any device: the reference the kernels are held against.
    ``lis``: Log-Int-Softmax on (the reference default) or the LIS-off fp32
    softmax over the dequantized attention codes, in the kernels as in the
    plain versions. ``fuse_embed`` / ``fuse_qkv``: the fused prologue and the
    qkv-fused attention (default), or their staged forms (module docstring).
    ``fuse_layer``: each encoder layer in one ``fused_vit_layer`` launch,
    bit for bit the four-kernel path; takes precedence over ``fuse_qkv``.
    On the card it raises ValueError for a model the kernel does not fit
    (``layer_fused.check_fits``).
    ``u8_affine``: ingest uint8 through the fused affine; prove it first with
    ``u8_ingest_exact(s, affine=True)``.
    """
    if fuse_layer and use_kernels and x.device.type != "cpu":
        layer_fused.check_fits(cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.hidden_dim)
    h, xc = embed_codes(s, cfg, x, use_kernels, fuse_embed, u8_affine)
    for bi in range(len(s["blocks"])):
        layer = layer_consts(s, cfg, bi)
        if fuse_layer:
            h, xc = apply_fused_layer(cfg, layer, h, xc, lis, use_kernels)
        else:
            h, xc = apply_unfused_layer(cfg, layer, h, xc, lis, fuse_qkv, use_kernels)
    return head_logits(s, h, use_kernels)


def launches_per_forward(cfg: ViTConfig, fuse_embed: bool = True, fuse_qkv: bool = True,
                         fuse_layer: bool = False) -> dict:
    """Kernel launches of one ``serving_forward`` at these flags: the
    prologue (one fused kernel, or the patch GEMM and LN1), per block either
    one fused layer or the attention (with its qkv GEMM when staged), two
    junctions and fc1, and the head."""
    depth = cfg.depth
    staged_embed = 0 if fuse_embed else 1
    if fuse_layer:
        counts = {"fused_vit_layer": depth, "int8_matmul_requant": 1 + staged_embed}
    else:
        counts = {"int8_matmul_res_ln": 2 * depth,
                  "int8_matmul_requant": depth + 1 + staged_embed + (0 if fuse_qkv else depth),
                  "lis_attention_qkv_fused" if fuse_qkv else "lis_attention_fused": depth}
    counts["fused_patch_embed" if fuse_embed else "int_ln_requant"] = 1
    return counts

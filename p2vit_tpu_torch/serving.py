"""Int8 serving pipeline (counterpart of ``p2vit_tpu/serving.py``).

``convert`` specializes (params, QuantState, bit_config) into a serving
state of int8 weight codes and requant constants; ``serving_forward`` runs
the network on int8 codes through four kernels:

  * ``ops/embed_fused.fused_patch_embed``: image codes → block-0 inputs,
  * ``ops/attention_lis.lis_attention_qkv_fused``: qkv + LIS attention,
  * ``ops/matmul_ln.int8_matmul_res_ln``: proj / fc2 + residual + next LN,
  * ``ops/matmul_int8.int8_matmul_requant``: fc1 + GELU, and the head.

This is the JAX package's default path (``fuse_embed=True, fuse_qkv=True,
fuse_layer=False``, unrolled). Not ported yet: uint8 ingest,
``weight_only_params``, the fused-layer kernel, and the TPU-only arms
(``scan_layers``, the ``resln`` and ``lis="bypass"`` timing probes).

Numerics: every requant scale the PoT search produces is a power of two,
so the requant multiplies are exact; serving is compared with the
simulation statistically, and with the JAX serving path code for code.
"""

from __future__ import annotations

import torch

from .config import QuantPolicy
from .models.common import ViTConfig, extract_patches
from .ops import attention_lis, embed_fused, matmul_int8, matmul_ln

_I8 = (-128, 127)


def _wcodes(w, scale, qmin, qmax):
    """Weight → int8 codes under a per-out-channel PoT scale."""
    return torch.clamp(torch.round(w / scale[:, None]), qmin, qmax).to(torch.int8)


def _bit_bounds(bit):
    return (-8, 7) if bit == 4 else (-128, 127)


def _input_codes(s, x):
    """float32 normalized image batch → qact_input int8 codes."""
    if x.dtype != torch.float32:
        raise TypeError(f"serving takes float32 images; {x.dtype} ingest is not ported yet")
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


def embed_codes(s, cfg: ViTConfig, x, use_kernels: bool = True):
    """The serving prologue: image → (h, xc), block 0's LN1 codes and the
    qact1 residual codes. Quantizes BEFORE extracting patches (the two
    commute), so the patch reorder moves int8 codes."""
    fn = embed_fused.fused_patch_embed if use_kernels else embed_fused.fused_patch_embed_plain
    patches = extract_patches(_input_codes(s, x), cfg.patch_size).contiguous()
    xc, h = fn(patches, s["patch"]["w_q"], **_embed_fused_consts(s, cfg))
    return h, xc


def head_logits(s, h, use_kernels: bool = True):
    """The serving epilogue: final-norm codes (h[:, 0]) → head → f32 logits."""
    mm = matmul_int8.int8_matmul_requant if use_kernels else matmul_int8.int8_matmul_requant_plain
    hd = s["head"]
    logits_c = mm(h[:, 0].contiguous(), hd["w_q"], s["s_qact2"] * hd["sw"] / s["s_out"],
                  hd["bias"] / s["s_out"])
    return logits_c.to(torch.float32) * s["s_out"]


@torch.no_grad()
def serving_forward(s, cfg: ViTConfig, x, use_kernels: bool = True, lis: bool = True):
    """Run the int8 pipeline on a float32 image batch (B, 3, H, W); returns
    float32 logits (B, num_classes).

    ``use_kernels``: the four kernel wrappers (CUDA kernels on CUDA tensors,
    their plain versions on CPU tensors). False calls the plain versions
    directly on any device: the reference the kernels are held against.
    ``lis``: Log-Int-Softmax on (the reference default); off runs the fp
    softmax, which only the plain attention implements so far.
    """
    if use_kernels:
        attn = attention_lis.lis_attention_qkv_fused
        res_ln = matmul_ln.int8_matmul_res_ln
        mm = matmul_int8.int8_matmul_requant
    else:
        attn = attention_lis.lis_attention_qkv_fused_plain
        res_ln = matmul_ln.int8_matmul_res_ln_plain
        mm = matmul_int8.int8_matmul_requant_plain

    b = x.shape[0]
    c = cfg.embed_dim
    n_tok = cfg.seq_len
    h, xc = embed_codes(s, cfg, x, use_kernels)
    s_prev = s["s_qact1"]
    n_blocks = len(s["blocks"])
    for bi, sb in enumerate(s["blocks"]):
        qkv = sb["qkv"]
        h = attn(
            h, qkv["w_q"],
            qkv["s_act"] * qkv["sw"] / sb["s_qact1"],
            qkv["bias"] / sb["s_qact1"],
            cfg.num_heads,
            sb["s_qact1"] ** 2 * cfg.attn_scale / sb["s_attn1"],
            sb["s_attn1"],
            sb["s_qact1"] / sb["s_qact2a"],
            lis=lis,
        )
        pr = sb["proj"]
        fc1 = sb["mlp_fc1"]
        # proj + residual junction + int-LN2: the qact2 residual carrier and
        # the mlp's qact0 input codes
        xc2, h = res_ln(
            h.reshape(-1, c), pr["w_q"],
            sb["s_qact2a"] * pr["sw"] / sb["s_qact3"],
            pr["bias"] / sb["s_qact3"],
            xc.reshape(-1, c),
            sb["s_qact3"], s_prev, sb["s_res1"],
            sb["norm2_w"], sb["norm2_b"],
            fc1["s_act"] * sb["norm2_cs"], sb["norm2_ratio"],
        )
        h = mm(h, fc1["w_q"], fc1["s_act"] * fc1["sw"], fc1["bias"],
               out_inv=1.0 / sb["s_mq1"], gelu=True)
        # fc2 + residual + the NEXT LayerNorm (next block's LN1, or the
        # final encoder norm after the last block)
        if bi + 1 < n_blocks:
            nb = s["blocks"][bi + 1]
            ln_w, ln_b = nb["norm1_w"], nb["norm1_b"]
            ln_out = nb["qkv"]["s_act"] * nb["qkv"]["cs"]
        else:
            ln_w, ln_b = s["norm_w"], s["norm_b"]
            ln_out = s["s_qact2"]
        fc2 = sb["fc2"]
        xc2, h = res_ln(
            h, fc2["w_q"],
            sb["s_mq1"] * fc2["sw"] / sb["s_mq2"],
            fc2["bias"] / sb["s_mq2"],
            xc2,
            sb["s_mq2"], sb["s_res1"], sb["s_res2"],
            ln_w, ln_b, ln_out, 1.0,
        )
        xc = xc2.reshape(b, n_tok, c)
        h = h.reshape(b, n_tok, c)
        s_prev = sb["s_res2"]
    return head_logits(s, h, use_kernels)

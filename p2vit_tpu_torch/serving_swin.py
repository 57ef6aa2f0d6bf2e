"""Int8 serving pipeline for Swin (counterpart of ``p2vit_tpu/serving_swin.py``).

``convert`` freezes (params, QuantState, bit_config) into int8 weight codes
and the constants the forward needs; ``serving_forward`` runs the network on
int8 codes. At the JAX package's defaults (``pallas_attn=True,
fuse_res=True``, the three stem and window flags off) an fp patch stem (a
float32 ``torch.matmul`` against the dequantized weight codes, as the JAX
package leaves it to XLA) feeds five kernels:

  * ``ops/intln.int_ln_requant``: patch norm, each stage's first norm1 and
    the PatchMerging norms (4C, the previous scale tiled ×4);
  * ``ops/attention_lis.swin_lis_attention``: windowed LIS attention;
  * ``ops/intln.int_res_ln_requant``: the attention-side residual junction
    after ``window_reverse`` and norm2;
  * ``ops/matmul_ln.int8_matmul_res_ln``: fc2 + residual + the next norm1
    (or the final norm);
  * ``ops/matmul_int8.int8_matmul_requant``: qkv, proj, fc1+GELU, the fc2
    before a PatchMerging, the reductions and the head.

The JAX package's serving flags, with its defaults and precedence:
``fuse_stem`` runs the stem in ``ops/swin_stem.fused_swin_stem``;
``int_stem`` (wins over ``fuse_stem``) runs it as an int8 GEMM on the input
codes; ``fold_windows`` runs the attention of every stage with more than
one window in ``ops/attention_lis.swin_lis_attention_folded`` on raster
qkv rows; ``fuse_res=False`` runs the residual junctions elementwise and
every LN in ``int_ln_requant``. The XLA window-attention twin
``_window_attention_codes{,_vals}`` is the plain version of the attention
kernel (``swin_lis_attention_plain``), so ``pallas_attn=False`` and
``use_pallas=False`` are ``use_kernels=False`` here. ``lis=False`` runs the
attention kernels' fp32 softmax arm; ``attach_u8_ingest`` lets the forward
take raw uint8 images. ``weight_only_params`` dequantizes the serving
codes into float32 params for a bf16 ``fp_forward``. Not ported
(ROADMAP.md): the timing probes ``reorder="bypass"`` and ``lis="bypass"``.
"""

from __future__ import annotations

import torch

from .config import QuantPolicy
from .models.swin import (
    SwinConfig,
    _merge_patches,
    _patches,
    _roll,
    relative_position_index,
    shift_mask_tensor,
    window_partition,
    window_reverse,
)
from .ops import attention_lis, intln, matmul_int8, matmul_ln, swin_stem
from .serving import _int_ln_codes, _u8_normalize, u8_ingest_consts

_I8 = (-128, 127)
_ROW = {4: 2, 8: 3}  # weight-scale row of each eval bit
_BOUNDS = {4: (-8, 7), 8: (-128, 127)}


def _bias_values(table, table_scale, ws: int, heads: int):
    """Dequantized rel-pos-bias values (heads, N, N): the table
    fake-quantized at qact_table, gathered per position."""
    table_q = torch.clamp(torch.round(table / table_scale), *_I8)
    idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).to(table.device)
    n = ws * ws
    return (table_q[idx] * table_scale).reshape(n, n, heads).permute(2, 0, 1).contiguous()


def convert(params, qstate, cfg: SwinConfig, policy: QuantPolicy, bit_config=8) -> dict:
    """Freeze int8 weight codes and the serving constants for a bit config:
    one int (uniform weight bit) or a per-layer list of ``cfg.num_matmuls``
    in the calibration-walk slot order ([patch] + per stage (per block [qkv,
    proj, fc1, fc2]) + [reduction] + [head]).

    Beyond the JAX package's state, each block carries its bias values and
    its shift mask divided by s2, which the JAX package re-forms inside its
    compiled forward; the state records the smallest s2 as a host number
    (``min_s2``), so that the forward checks the LIS scale bound without
    reading the card."""
    if not policy.int_norm:
        raise ValueError("Swin serving requires the PTF integer-LN pipeline")
    if "qact_input" not in qstate:
        raise KeyError("qstate has no 'qact_input': a Swin quant state saved before the input "
                       "fake-quant node existed; recalibrate")
    if isinstance(bit_config, int):
        bits = [bit_config] * cfg.num_matmuls
    else:
        bits = [int(b) for b in bit_config]
        if len(bits) != cfg.num_matmuls:
            raise ValueError(f"bit_config has {len(bits)} entries; {cfg.num_matmuls} expected")

    def wq(w, dic, bit):
        sw = dic[_ROW[bit]]
        w_q = torch.clamp(torch.round(w / sw[:, None]), *_BOUNDS[bit]).to(torch.int8)
        return {"w_q": w_q, "sw": sw}

    s: dict = {
        "s_input": qstate["qact_input"]["scale"],
        "zp_input": qstate["qact_input"]["zp"],
        "patch": wq(params["patch_embed"]["w"], qstate["patch_wscale"], bits[0]),
        "patch_b": params["patch_embed"]["b"],
        "head": wq(params["head"]["w"], qstate["head_wscale"], bits[-1]),
        "head_b": params["head"]["b"],
        "stages": [],
    }
    slot = 1
    for i, stage in enumerate(params["stages"]):
        sq = qstate["stages"][i]
        st = {"blocks": []}
        for j, blk in enumerate(stage["blocks"]):
            aq = sq["blocks"][j]["attn"]
            mask = shift_mask_tensor(cfg, i, cfg.shift(i, j), blk["bias_table"].device)
            st["blocks"].append({
                "qkv": wq(blk["qkv"]["w"], aq["qkv_wscale"], bits[slot]),
                "qkv_b": blk["qkv"]["b"],
                "proj": wq(blk["proj"]["w"], aq["proj_wscale"], bits[slot + 1]),
                "proj_b": blk["proj"]["b"],
                "fc1": wq(blk["fc1"]["w"], sq["blocks"][j]["fc1_wscale"], bits[slot + 2]),
                "fc1_b": blk["fc1"]["b"],
                "fc2": wq(blk["fc2"]["w"], sq["blocks"][j]["fc2_wscale"], bits[slot + 3]),
                "fc2_b": blk["fc2"]["b"],
                "norm1": blk["norm1"],
                "norm2": blk["norm2"],
                "bias_val": _bias_values(blk["bias_table"], aq["qact_table"]["scale"],
                                         cfg.window(i), cfg.num_heads[i]),
                "mask_s2": None if mask is None else mask / aq["qact2"]["scale"],
            })
            slot += 4
        if "downsample" in stage:
            ds = stage["downsample"]
            st["downsample"] = {"red": wq(ds["reduction"]["w"], sq["downsample"]["red_wscale"],
                                          bits[slot]),
                                "norm": ds["norm"]}
            slot += 1
        s["stages"].append(st)
    s["min_s2"] = min(float(bq["attn"]["qact2"]["scale"]) for sq in qstate["stages"]
                      for bq in sq["blocks"])
    s["patch_norm"] = params["patch_norm"]
    s["norm"] = params["norm"]
    return s


def weight_only_params(params, qstate, cfg: SwinConfig, policy: QuantPolicy, bit_config=8) -> dict:
    """Weight-only quantized Swin serving: ``convert``'s exact weight codes
    dequantized back into a copy of ``params`` (float32, on the params'
    device) for ``swin.fp_forward``. Swin's serving weights carry no
    SmoothQuant fold, so every effective weight, the PatchMerging reductions
    included, is w_q·sw. Inherits ``convert``'s preconditions
    (``policy.int_norm``, a qstate with ``qact_input``)."""
    s = convert(params, qstate, cfg, policy, bit_config)

    def eff(layer):
        return layer["w_q"].to(torch.float32) * layer["sw"][:, None]

    new = dict(params)
    new["patch_embed"] = {**params["patch_embed"], "w": eff(s["patch"])}
    new["head"] = {**params["head"], "w": eff(s["head"])}
    stages = []
    for stage, st in zip(params["stages"], s["stages"]):
        ns = dict(stage)
        ns["blocks"] = [
            {**blk, **{key: {**blk[key], "w": eff(sb[key])} for key in ("qkv", "proj", "fc1", "fc2")}}
            for blk, sb in zip(stage["blocks"], st["blocks"])
        ]
        if "downsample" in stage:
            ds = stage["downsample"]
            ns["downsample"] = {**ds, "reduction": {**ds["reduction"], "w": eff(st["downsample"]["red"])}}
        stages.append(ns)
    new["stages"] = stages
    return new


def launches_per_forward(cfg: SwinConfig, fuse_stem: bool = False, int_stem: bool = False,
                         fold_windows: bool = False, fuse_res: bool = True) -> dict:
    """Kernel launches of one ``serving_forward`` with these flags (kernels
    launched 0 times left out).

    The stem: ``int_stem`` one requant GEMM and its LN, ``fuse_stem`` one
    ``fused_swin_stem``, else the fp matmul and its LN. One attention per
    block, folded where the stage has more than one window. ``fuse_res``:
    one residual junction per block, an fc2 junction per block but the one
    before each PatchMerging (which runs a plain fc2), and an LN for each
    stage's first norm1; without it, a plain fc2 per block and an LN for
    every norm1, every norm2 and the final norm. Every block's qkv, proj and
    fc1, each PatchMerging's LN and reduction, and the head."""
    blocks, merges = sum(cfg.depths), cfg.num_layers - 1
    folded = sum(d for i, d in enumerate(cfg.depths)
                 if cfg.stage_res(i) > cfg.window(i)) if fold_windows else 0
    fused_stem = fuse_stem and not int_stem
    ln = (0 if fused_stem else 1) + merges + (cfg.num_layers if fuse_res else 2 * blocks + 1)
    plain_fc2 = merges if fuse_res else blocks
    counts = {"int_ln_requant": ln, "swin_lis_attention": blocks - folded,
              "swin_lis_attention_folded": folded,
              "int_res_ln_requant": blocks if fuse_res else 0,
              "int8_matmul_res_ln": blocks - merges if fuse_res else 0,
              "int8_matmul_requant": 3 * blocks + plain_fc2 + merges + 1 + int(int_stem),
              "fused_swin_stem": int(fused_stem)}
    return {k: v for k, v in counts.items() if v}


def _iln(codes, s_in, lnp, out_scale, expand=1, use_kernels=True):
    """Integer LN on codes; ``expand`` tiles the input scale over a
    PatchMerging concat of ``expand`` copies."""
    s_in_v = torch.broadcast_to(torch.as_tensor(s_in, dtype=torch.float32, device=codes.device),
                                (codes.shape[-1] // expand,)).repeat(expand)
    return _int_ln_codes(codes, s_in_v, lnp["w"], lnp["b"], out_scale, 1.0, use_kernels)


def attach_u8_ingest(s, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
    """Enable raw uint8 image ingestion on a converted Swin serving state (in
    place): the forward replays the host normalize ``(u/255 − mean)/std`` in
    the host's float32 op order, bit for bit the host-normalized batch; the
    qact_input fake-quant then applies as for float32 images."""
    s["u8"] = u8_ingest_consts(mean, std, device=s["s_input"].device)
    return s


def _u8_dequant(s, x):
    if "u8" not in s:
        raise ValueError("uint8 batch but no ingestion constants: call "
                         "serving_swin.attach_u8_ingest(s, mean, std) after convert()")
    return _u8_normalize(x, s["u8"])


def _input_codes(s, x):
    """Image (float32 normalized, or raw uint8 after ``attach_u8_ingest``) →
    its qact_input codes clip(round(x/s + zp)) as float32 (the simulation's
    formula)."""
    if x.dtype == torch.uint8:
        x = _u8_dequant(s, x)
    elif x.dtype != torch.float32:
        raise TypeError(f"Swin serving takes float32 or uint8 images, got {x.dtype}")
    return torch.clamp(torch.round(x / s["s_input"] + s["zp_input"]), *_I8)


def _mean_codes(codes, s_in, s_out):
    """Token mean of (B, L, C) codes at scale ``s_in`` → (B, C) int8 codes at
    ``s_out``. The float32 sum of codes is exact in any order. XLA forms
    ``jnp.mean`` as sum·fl(1/L), not the quotient; the two give the same
    codes: they part by an ulp only off the rounding ties, and at a tie the
    quotient is an exact integer that sum·fl(1/L) also hits (all L = 49
    multiples checked in tests/test_torch_swin_serving.py)."""
    return torch.clamp(torch.round(codes.to(torch.float32).mean(dim=1) * s_in / s_out),
                       *_I8).to(torch.int8)


def stem_codes(s, qstate, cfg: SwinConfig, x, use_kernels: bool = True, fuse_stem: bool = False,
               int_stem: bool = False):
    """The serving stem: image → patch-norm codes (B, L, C).

    Default: the fp patch matmul (float32, TF32 off) on the fake-quantized
    image against the dequantized weight codes → patch_qact_bn codes → int
    LN onto patch_qact codes. ``fuse_stem``: the same function in
    ``fused_swin_stem``. ``int_stem`` (wins over ``fuse_stem``): the int8
    GEMM of the input codes against the weight codes, requantized onto
    patch_qact_bn codes, then the int LN; the input zero point folds into
    the bias: (q0 − zp)·Wᵀ·s·sw = q0·Wᵀ·s·sw − zp·s·sw·Σ_k W[:, k]."""
    b = x.shape[0]
    q0 = _input_codes(s, x)
    sq_bn = qstate["patch_qact_bn"]["scale"]
    pn, s_pq = s["patch_norm"], qstate["patch_qact"]["scale"]
    w_q, sw = s["patch"]["w_q"], s["patch"]["sw"]
    if int_stem:
        mm = matmul_int8.int8_matmul_requant if use_kernels else matmul_int8.int8_matmul_requant_plain
        pc = _patches(q0.to(torch.int8), cfg.patch_size)
        zp_b = s["zp_input"] * s["s_input"] * sw * w_q.to(torch.float32).sum(dim=1)
        xc = mm(pc.reshape(-1, pc.shape[-1]), w_q, s["s_input"] * sw / sq_bn,
                (s["patch_b"] - zp_b) / sq_bn)
        return _iln(xc, sq_bn, pn, s_pq, use_kernels=use_kernels).reshape(b, pc.shape[1], -1)
    pw = w_q.to(torch.float32) * sw[:, None]
    px = _patches((q0 - s["zp_input"]) * s["s_input"], cfg.patch_size)
    if fuse_stem:
        fn = swin_stem.fused_swin_stem if use_kernels else swin_stem.fused_swin_stem_plain
        xc = fn(px.reshape(-1, px.shape[-1]), pw, s["patch_b"], sq_bn, pn["w"], pn["b"], s_pq)
        return xc.reshape(b, px.shape[1], -1)
    h = px @ pw.T + s["patch_b"]
    xc = torch.clamp(torch.round(h / sq_bn), *_I8).to(torch.int8)
    return _iln(xc, sq_bn, pn, s_pq, use_kernels=use_kernels).reshape(b, px.shape[1], -1)


def _residual_codes(a, s_a, b, s_b, s_out):
    """The unfused residual junction: clip(round((a·s_a + b·s_b)/s_out))
    as int8, each product and the sum rounded on its own."""
    val = a.to(torch.float32) * s_a + b.to(torch.float32) * s_b
    return torch.clamp(torch.round(val / s_out), *_I8).to(torch.int8)


@torch.no_grad()
def serving_forward(s, qstate, cfg: SwinConfig, policy: QuantPolicy, x, use_kernels: bool = True,
                    lis: bool | None = None, fuse_stem: bool = False, int_stem: bool = False,
                    fold_windows: bool = False, fuse_res: bool = True):
    """Run the Swin int8 pipeline on an image batch (B, 3, H, W), float32
    normalized or raw uint8 after ``attach_u8_ingest``; returns float32
    logits (B, num_classes).

    ``use_kernels``: the kernel wrappers (CUDA kernels on CUDA tensors, their
    plain versions on CPU tensors). False calls the plain versions directly
    on any device, under every flag: the reference the kernels are held
    against. ``lis``: override the policy's Log-Int-Softmax switch; off runs
    the LIS-off fp32 softmax, in the kernels as in the plain versions.
    ``fuse_stem``, ``int_stem``: the stem (``stem_codes``).
    ``fold_windows``: qkv and proj run on raster rows, the cyclic shift
    rolls the (B, res, res, 3C) qkv codes, and the attention windows them in
    its loads and stores (``swin_lis_attention_folded``); a stage that is one
    window (Swin-T's last, res 7 = ws) keeps the two-step attention. The
    logits equal the default path's bit for bit.
    ``fuse_res=False``: both residual junctions elementwise (each product
    and the sum rounded on its own), then every norm1, norm2 and the final
    norm in ``int_ln_requant``.
    """
    if use_kernels:
        attn = attention_lis.swin_lis_attention
        attn_fold = attention_lis.swin_lis_attention_folded
        res_ln = intln.int_res_ln_requant
        mm_res_ln = matmul_ln.int8_matmul_res_ln
        mm = matmul_int8.int8_matmul_requant
    else:
        attn = attention_lis.swin_lis_attention_plain
        attn_fold = attention_lis.swin_lis_attention_folded_plain
        res_ln = intln.int_res_ln_requant_plain
        mm_res_ln = matmul_ln.int8_matmul_res_ln_plain
        mm = matmul_int8.int8_matmul_requant_plain
    lis = bool(policy.int_softmax) if lis is None else bool(lis)
    if lis:
        attention_lis.check_lis_scale(s["min_s2"])

    b = x.shape[0]
    xc = stem_codes(s, qstate, cfg, x, use_kernels, fuse_stem=fuse_stem, int_stem=int_stem)
    s_prev = qstate["patch_qact"]["scale"]
    final_ln = None
    for i, st in enumerate(s["stages"]):
        res, ws = cfg.stage_res(i), cfg.window(i)
        heads = cfg.num_heads[i]
        sqs = qstate["stages"][i]
        nblk = len(st["blocks"])
        last_stage = i == len(s["stages"]) - 1
        h_ln = None  # norm1 codes carried out of the fc2 junction
        for j, sb in enumerate(st["blocks"]):
            bq = sqs["blocks"][j]
            aq = bq["attn"]
            shift = cfg.shift(i, j)
            bs, l, c = xc.shape
            hd = c // heads
            shortcut = xc
            h = _iln(xc, s_prev, sb["norm1"], bq["qact1"]["scale"], use_kernels=use_kernels) \
                if h_ln is None else h_ln
            qkv = (sb["qkv"]["w_q"], bq["qact1"]["scale"] * sb["qkv"]["sw"] / aq["qact1"]["scale"],
                   sb["qkv_b"] / aq["qact1"]["scale"])
            scales = (aq["qact1"]["scale"] ** 2 * hd**-0.5 / aq["qact_attn1"]["scale"],
                      aq["qact_attn1"]["scale"], aq["qact2"]["scale"],
                      aq["qact1"]["scale"] / aq["qact3"]["scale"])
            proj = (sb["proj"]["w_q"], aq["qact3"]["scale"] * sb["proj"]["sw"] / aq["qact4"]["scale"],
                    sb["proj_b"] / aq["qact4"]["scale"])
            if fold_windows and res > ws:
                hq = _roll(mm(h.reshape(-1, c), *qkv).reshape(bs, res, res, 3 * c), -shift)
                hw = attn_fold(hq, sb["bias_val"], sb["mask_s2"], heads, ws, *scales, lis=lis)
                h = mm(_roll(hw, shift).reshape(-1, c), *proj)
            else:
                hw = window_partition(_roll(h.reshape(bs, res, res, c), -shift), ws)
                hw = mm(hw.reshape(-1, c), *qkv).reshape(-1, ws * ws, 3 * c)
                hw = attn(hw, sb["bias_val"], sb["mask_s2"], heads, (res // ws) ** 2, *scales,
                          lis=lis)
                hw = mm(hw.reshape(-1, c), *proj)
                h = _roll(window_reverse(hw.reshape(-1, ws * ws, c), ws, res, res), shift)
            # residual requant-add → block qact2 codes, and their norm2 codes
            if fuse_res:
                xc, h = res_ln(shortcut.reshape(-1, c), s_prev, h.reshape(-1, c).contiguous(),
                               aq["qact4"]["scale"], bq["qact2"]["scale"], sb["norm2"]["w"],
                               sb["norm2"]["b"], bq["qact3"]["scale"], 1.0)
            else:
                xc = _residual_codes(shortcut, s_prev, h.reshape(bs, l, c), aq["qact4"]["scale"],
                                     bq["qact2"]["scale"])
                h = _iln(xc, bq["qact2"]["scale"], sb["norm2"], bq["qact3"]["scale"],
                         use_kernels=use_kernels).reshape(-1, c)
            h = mm(h, sb["fc1"]["w_q"], bq["qact3"]["scale"] * sb["fc1"]["sw"], sb["fc1_b"],
                   out_inv=1.0 / bq["mlp_qact1"]["scale"], gelu=True)
            fc2 = sb["fc2"]
            r_fc2 = bq["mlp_qact1"]["scale"] * fc2["sw"] / bq["mlp_qact2"]["scale"]
            b_fc2 = sb["fc2_b"] / bq["mlp_qact2"]["scale"]
            if fuse_res and (j + 1 < nblk or last_stage):
                # fc2 + residual + the LN that follows in the same token
                # layout: the next block's norm1, or the final norm
                if j + 1 < nblk:
                    ln_p = st["blocks"][j + 1]["norm1"]
                    ln_out = sqs["blocks"][j + 1]["qact1"]["scale"]
                else:
                    ln_p, ln_out = s["norm"], qstate["qact2"]["scale"]
                xc, h_f = mm_res_ln(h, fc2["w_q"], r_fc2, b_fc2, xc.reshape(-1, c),
                                    bq["mlp_qact2"]["scale"], bq["qact2"]["scale"],
                                    bq["qact4"]["scale"], ln_p["w"], ln_p["b"], ln_out, 1.0)
                if j + 1 < nblk:
                    h_ln = h_f.reshape(bs, l, c)
                else:
                    final_ln = h_f.reshape(bs, l, c)
            else:
                # plain fc2, then the residual requant-add (fuse_res: the
                # block before a PatchMerging)
                h = mm(h, fc2["w_q"], r_fc2, b_fc2)
                xc = _residual_codes(xc.reshape(-1, c), bq["qact2"]["scale"], h,
                                     bq["mlp_qact2"]["scale"], bq["qact4"]["scale"])
                h_ln = None
            xc = xc.reshape(bs, l, c)
            s_prev = bq["qact4"]["scale"]
        if "downsample" in st:
            dq = sqs["downsample"]
            red = st["downsample"]["red"]
            xc = _iln(_merge_patches(xc, res), s_prev, st["downsample"]["norm"], dq["qact1"]["scale"],
                      expand=4, use_kernels=use_kernels)
            c2 = xc.shape[-1]
            xc = mm(xc.reshape(-1, c2), red["w_q"], dq["qact1"]["scale"] * red["sw"] / dq["qact2"]["scale"],
                    0.0).reshape(b, -1, c2 // 2)
            s_prev = dq["qact2"]["scale"]

    if final_ln is None:
        final_ln = _iln(xc, s_prev, s["norm"], qstate["qact2"]["scale"], use_kernels=use_kernels)
    c3 = _mean_codes(final_ln, qstate["qact2"]["scale"], qstate["qact3"]["scale"])
    logits_c = mm(c3, s["head"]["w_q"],
                  qstate["qact3"]["scale"] * s["head"]["sw"] / qstate["act_out"]["scale"],
                  s["head_b"] / qstate["act_out"]["scale"])
    return logits_c.to(torch.float32) * qstate["act_out"]["scale"]

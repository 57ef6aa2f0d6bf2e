"""Fully-quantized ViT/DeiT (counterpart of ``p2vit_tpu/models/vit.py``).

Plain functions over a parameter dict with the JAX package's structure:

  * ``fp_forward(params, cfg, x)``: the float forward.
  * ``collect_stats(params, cfg, policy, x, prev=None)``: the statistics
    pass over one calibration batch (running activation ranges only).
  * ``calibrate(params, cfg, policy, x, stats=None)``: the solve over the
    last calibration batch, with the ranges of earlier batches in
    ``stats``, giving the ``QuantState`` dict (scales, PoT exponents, PTF
    masks, per-bit SmoothQuant caches) and the mixed-precision artifacts.
  * ``quant_forward(params, qstate, cfg, policy, x, bit_idx)``: the
    fake-quant simulation. ``bit_idx`` is an index tensor, so one code path
    serves every mixed-precision config.

The quantization nodes sit where the JAX package puts them (its module
docstring lists the chain). ``policy.smoothquant=False`` calibrates qkv and
fc1 on the unsmoothed input, with unit channel scales.
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import QuantPolicy
from ..quant.bit_type import BIT_TYPE_DICT, EVAL_BIT_POOL
from ..quant.fake_quant import fake_quant, fake_quant_dyn, lp_loss
from ..quant.intops import int_layernorm, log_int_softmax
from ..quant.smoothquant import ATTN_ALPHA_POOL, MLP_ALPHA_POOL, pot_smooth_channel_scale
from ..quant.solve import accumulate_act_stats, solve_act, solve_weight_all_bits
from .common import (
    ViTConfig,
    extract_patches,
    gelu,
    layer_norm,
    linear,
    merge_heads,
    split_qkv,
    target_device,
    trunc_normal,
    vit_flops,
)

INT8 = BIT_TYPE_DICT["int8"]

# eval bit index (0 → int4, 1 → int8) → clamp bounds; weight-scale row 2 + j
EVAL_QMIN = (-8.0, -128.0)
EVAL_QMAX = (7.0, 127.0)
N_EVAL_BITS = len(EVAL_BIT_POOL)


def bits_to_idx(bit_config) -> torch.Tensor:
    """Reference-style bit_config list (e.g. [4]*50) → int64 index tensor."""
    lut = {b: i for i, b in enumerate(EVAL_BIT_POOL)}
    bad = sorted({int(b) for b in bit_config} - set(lut))
    if bad:
        raise ValueError(
            f"unsupported bit widths {bad}: the calibrated per-bit caches "
            f"cover {sorted(lut)} only"
        )
    return torch.tensor([lut[int(b)] for b in bit_config], dtype=torch.int64)


# ---------------------------------------------------------------------------
# Parameters and the float forward
# ---------------------------------------------------------------------------


def init_params(seed: int, cfg: ViTConfig, device="cuda") -> dict:
    """Random init from a seeded ``torch.Generator`` (trunc normal σ=0.02,
    zero biases, unit LN weights), on the card unless ``device`` says
    otherwise. The numbers differ from the JAX package's init for the same
    seed; tests hand both packages the same numpy params through
    ``interop.params_from_numpy``."""
    device = target_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    c, h, p = cfg.embed_dim, cfg.hidden_dim, cfg.patch_size

    def tn(shape):
        return trunc_normal(gen, shape).to(device)

    def lin(o, i):
        return {"w": tn((o, i)), "b": torch.zeros(o, device=device)}

    def ln():
        return {"w": torch.ones(c, device=device), "b": torch.zeros(c, device=device)}

    blocks = [
        {
            "norm1": ln(),
            "qkv": lin(3 * c, c),
            "proj": lin(c, c),
            "norm2": ln(),
            "fc1": lin(h, c),
            "fc2": lin(c, h),
        }
        for _ in range(cfg.depth)
    ]
    return {
        "cls_token": tn((1, 1, c)),
        "pos_embed": tn((1, cfg.seq_len, c)),
        "patch_embed": lin(c, cfg.in_chans * p * p),
        "blocks": blocks,
        "norm": ln(),
        "head": lin(cfg.num_classes, c),
    }


def fp_forward(params, cfg: ViTConfig, x):
    """Float ViT forward in the dtype of ``x`` and ``params``."""
    eps = cfg.ln_eps
    b = x.shape[0]
    x = extract_patches(x, cfg.patch_size)
    x = linear(x, params["patch_embed"]["w"], params["patch_embed"]["b"])
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1) + params["pos_embed"]
    for blk in params["blocks"]:
        h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
        h = linear(h, blk["qkv"]["w"], blk["qkv"]["b"])
        q, k, v = split_qkv(h, cfg.num_heads)
        attn = (q @ k.transpose(-1, -2)) * cfg.attn_scale
        attn = torch.softmax(attn, dim=-1)
        h = merge_heads(attn @ v)
        h = linear(h, blk["proj"]["w"], blk["proj"]["b"])
        x = x + h
        h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
        h = linear(h, blk["fc1"]["w"], blk["fc1"]["b"])
        h = gelu(h)
        h = linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
        x = x + h
    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps)[:, 0]
    return linear(x, params["head"]["w"], params["head"]["b"])


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CalibResult:
    qstate: dict
    flops: list  # length num_matmuls; the mixed-precision size proxy
    global_distance: torch.Tensor  # (num_matmuls - 1, 4) per-bit L2 errors


def _qact(method, x, bit_type=INT8, prev=None):
    """Solve one activation node → its qstate entry. ``prev``: the running
    stats of earlier batches; the solve uses the merged range and searches
    on this (the last) batch."""
    out = solve_act(method, x, bit_type, stats=accumulate_act_stats(method, x, prev))
    if len(out) == 3:
        scale, zp, mask = out
        return {"scale": scale, "zp": zp, "mask": mask}
    scale, zp = out
    return {"scale": scale, "zp": zp}


def _smooth_calibrate(x, w, bias, alpha_pool, policy, distances, prev_q0=None):
    """qkv/fc1 PoT-SmoothQuant calibration: per α, smooth, solve qact0 and the
    per-bit weight scales, then per eval bit keep the α with the least
    fp-vs-quant output loss. Returns (state, gt), gt being the smoothed fp
    output of the last α, which flows on through calibration.

    ``prev_q0``: qact0's running stats over earlier batches, each smoothed
    by its own channel scale; the observer accumulates across the α pool
    too. The weight observers see only this batch."""
    c = x.shape[-1]
    cs_pool, act_s, act_zp, wsc_pool, losses = [], [], [], [], []
    gt = None
    dist_last = None
    running_q0 = prev_q0
    for alpha in alpha_pool:
        cs = pot_smooth_channel_scale(x, w, alpha)
        x_sm = x / cs
        w_sm = w * cs[None, :]
        gt = linear(x_sm, w_sm, bias)
        running_q0 = accumulate_act_stats(policy.observer_a, x_sm, running_q0)
        scale, zp = solve_act(policy.observer_a, x_sm, INT8, stats=running_q0)
        wscale, dist = solve_weight_all_bits(w_sm, x_sm.reshape(-1, c))
        dist_last = dist
        cs_pool.append(cs)
        act_s.append(scale)
        act_zp.append(zp)
        wsc_pool.append(wscale)
        xq = fake_quant(x_sm, scale, zp, INT8)
        per_bit = []
        for j in range(N_EVAL_BITS):
            wq = fake_quant_dyn(w_sm, wscale[2 + j][:, None], 0.0,
                                torch.tensor(EVAL_QMIN[j], device=x.device),
                                torch.tensor(EVAL_QMAX[j], device=x.device))
            per_bit.append(lp_loss(gt, linear(xq, wq, bias)))
        losses.append(torch.stack(per_bit))
    distances.append(dist_last)
    best = torch.argmin(torch.stack(losses), dim=0)  # [n_bits]
    state = {
        "channel_scale": torch.stack(cs_pool)[best],
        "qact0_scale": torch.stack(act_s)[best],
        "qact0_zp": torch.stack(act_zp)[best],
        "wscale": torch.stack(wsc_pool)[best],
    }
    return state, gt


def _plain_calibrate(x, w, bias, method, distances, prev_q0=None):
    """qkv/fc1 calibration without SmoothQuant: qact0 on the raw input, one
    weight solve, the caches repeated per eval bit with unit channel
    scales. Returns (state, the layer's fp output)."""
    c = x.shape[-1]
    q0 = _qact(method, x, prev=prev_q0)
    wscale, dist = solve_weight_all_bits(w, x.reshape(-1, c))
    distances.append(dist)
    state = {
        "channel_scale": torch.ones((N_EVAL_BITS, c), device=x.device),
        "qact0_scale": torch.stack([q0["scale"]] * N_EVAL_BITS),
        "qact0_zp": torch.stack([q0["zp"]] * N_EVAL_BITS),
        "wscale": torch.stack([wscale] * N_EVAL_BITS),
    }
    return state, linear(x, w, bias)


def _sget(stats, *path):
    """Navigate the stats tree; None stays None (single-batch mode)."""
    if stats is None:
        return None
    for p in path:
        stats = stats[p]
    return stats


@torch.no_grad()
def calibrate(params, cfg: ViTConfig, policy: QuantPolicy, x, stats=None) -> CalibResult:
    """Calibration pass (stats and parameter solve, quant off), node for node
    as the JAX twin. ``stats``: the running activation statistics of earlier
    batches from ``collect_stats``; None calibrates on this batch alone."""
    a, a_ln = policy.observer_a, policy.observer_a_ln
    eps = cfg.ln_eps
    dists: list = []
    qs: dict = {}

    def smooth_or_plain(h, lin, alpha_pool, prev_q0):
        if policy.smoothquant:
            return _smooth_calibrate(h, lin["w"], lin["b"], alpha_pool, policy, dists, prev_q0=prev_q0)
        return _plain_calibrate(h, lin["w"], lin["b"], a, dists, prev_q0=prev_q0)

    qs["qact_input"] = _qact(a, x, prev=_sget(stats, "qact_input"))
    patches = extract_patches(x, cfg.patch_size)
    pw, pb = params["patch_embed"]["w"], params["patch_embed"]["b"]
    patch_wscale, _ = solve_weight_all_bits(pw, patches.reshape(-1, patches.shape[-1]))
    x = linear(patches, pw, pb)
    qs["patch"] = {"wscale": patch_wscale, "qact": _qact(a, x, prev=_sget(stats, "patch", "qact"))}

    b = x.shape[0]
    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    qs["qact_embed"] = _qact(a, x, prev=_sget(stats, "qact_embed"))
    qs["qact_pos"] = _qact(a, params["pos_embed"], prev=_sget(stats, "qact_pos"))
    x = x + params["pos_embed"]
    qs["qact1"] = _qact(a_ln, x, prev=_sget(stats, "qact1"))

    qs["blocks"] = []
    for i, blk in enumerate(params["blocks"]):
        sb = _sget(stats, "blocks", i)
        bq: dict = {}
        h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
        attn_state, h = smooth_or_plain(h, blk["qkv"], ATTN_ALPHA_POOL, _sget(sb, "attn", "qact0"))
        attn_state["qact1"] = _qact(a, h, prev=_sget(sb, "attn", "qact1"))
        q, k, v = split_qkv(h, cfg.num_heads)
        attn = (q @ k.transpose(-1, -2)) * cfg.attn_scale
        attn_state["qact_attn1"] = _qact(a, attn, prev=_sget(sb, "attn", "qact_attn1"))
        if policy.int_softmax:
            attn = log_int_softmax(attn, attn_state["qact_attn1"]["scale"], policy.bit_type_s)
        else:
            attn = torch.softmax(attn, dim=-1)
        h = merge_heads(attn @ v)
        attn_state["qact2"] = _qact(a, h, prev=_sget(sb, "attn", "qact2"))
        proj_wscale, dist = solve_weight_all_bits(blk["proj"]["w"], h.reshape(-1, cfg.embed_dim))
        dists.append(dist)
        attn_state["proj_wscale"] = proj_wscale
        h = linear(h, blk["proj"]["w"], blk["proj"]["b"])
        attn_state["qact3"] = _qact(a_ln, h, prev=_sget(sb, "attn", "qact3"))
        bq["attn"] = attn_state
        x = x + h
        bq["qact2"] = _qact(a_ln, x, prev=_sget(sb, "qact2"))

        h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
        mlp_state, h = smooth_or_plain(h, blk["fc1"], MLP_ALPHA_POOL, _sget(sb, "mlp", "qact0"))
        h = gelu(h)
        mlp_state["qact1"] = _qact(a, h, prev=_sget(sb, "mlp", "qact1"))
        fc2_wscale, dist = solve_weight_all_bits(blk["fc2"]["w"], h.reshape(-1, cfg.hidden_dim))
        dists.append(dist)
        mlp_state["fc2_wscale"] = fc2_wscale
        h = linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
        mlp_state["qact2"] = _qact(a_ln, h, prev=_sget(sb, "mlp", "qact2"))
        bq["mlp"] = mlp_state
        x = x + h
        bq["qact4"] = _qact(a_ln, x, prev=_sget(sb, "qact4"))
        qs["blocks"].append(bq)

    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps)[:, 0]
    qs["qact2"] = _qact(a, x, prev=_sget(stats, "qact2"))
    head_wscale, dist = solve_weight_all_bits(params["head"]["w"], x)
    dists.append(dist)
    qs["head_wscale"] = head_wscale
    x = linear(x, params["head"]["w"], params["head"]["b"])
    qs["act_out"] = _qact(a, x, prev=_sget(stats, "act_out"))
    return CalibResult(qstate=qs, flops=vit_flops(cfg), global_distance=torch.stack(dists))


@torch.no_grad()
def collect_stats(params, cfg: ViTConfig, policy: QuantPolicy, x, prev=None) -> dict:
    """Observe one calibration batch: the multi-batch statistics pass. Every
    activation node merges its range into ``prev`` (keys as the qstate's);
    nothing is solved, so the attention takes the float softmax (no LIS
    scale yet). SmoothQuant nodes observe the batch smoothed by its own
    channel scale. Feed the last result to ``calibrate(..., stats=)``::

        stats = None
        for b in batches[:-1]:
            stats = collect_stats(params, cfg, policy, b, stats)
        calib = calibrate(params, cfg, policy, batches[-1], stats=stats)
    """
    a, a_ln = policy.observer_a, policy.observer_a_ln
    eps = cfg.ln_eps
    st: dict = {}

    def acc(method, v, *path):
        return accumulate_act_stats(method, v, _sget(prev, *path))

    def smooth_collect(h, lin, alpha_pool, *path):
        if not policy.smoothquant:
            return acc(a, h, *path), linear(h, lin["w"], lin["b"])
        running, gt = _sget(prev, *path), None
        for alpha in alpha_pool:
            cs = pot_smooth_channel_scale(h, lin["w"], alpha)
            x_sm = h / cs
            gt = linear(x_sm, lin["w"] * cs[None, :], lin["b"])
            running = accumulate_act_stats(a, x_sm, running)
        return running, gt

    st["qact_input"] = acc(a, x, "qact_input")
    x = linear(extract_patches(x, cfg.patch_size), params["patch_embed"]["w"], params["patch_embed"]["b"])
    st["patch"] = {"qact": acc(a, x, "patch", "qact")}
    b = x.shape[0]
    x = torch.cat([params["cls_token"].expand(b, 1, cfg.embed_dim), x], dim=1)
    st["qact_embed"] = acc(a, x, "qact_embed")
    st["qact_pos"] = acc(a, params["pos_embed"], "qact_pos")
    x = x + params["pos_embed"]
    st["qact1"] = acc(a_ln, x, "qact1")

    st["blocks"] = []
    for i, blk in enumerate(params["blocks"]):
        P = ("blocks", i)
        bs: dict = {"attn": {}, "mlp": {}}
        h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
        bs["attn"]["qact0"], h = smooth_collect(h, blk["qkv"], ATTN_ALPHA_POOL, *P, "attn", "qact0")
        bs["attn"]["qact1"] = acc(a, h, *P, "attn", "qact1")
        q, k, v = split_qkv(h, cfg.num_heads)
        attn = (q @ k.transpose(-1, -2)) * cfg.attn_scale
        bs["attn"]["qact_attn1"] = acc(a, attn, *P, "attn", "qact_attn1")
        h = merge_heads(torch.softmax(attn, dim=-1) @ v)
        bs["attn"]["qact2"] = acc(a, h, *P, "attn", "qact2")
        h = linear(h, blk["proj"]["w"], blk["proj"]["b"])
        bs["attn"]["qact3"] = acc(a_ln, h, *P, "attn", "qact3")
        x = x + h
        bs["qact2"] = acc(a_ln, x, *P, "qact2")
        h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
        bs["mlp"]["qact0"], h = smooth_collect(h, blk["fc1"], MLP_ALPHA_POOL, *P, "mlp", "qact0")
        h = gelu(h)
        bs["mlp"]["qact1"] = acc(a, h, *P, "mlp", "qact1")
        h = linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
        bs["mlp"]["qact2"] = acc(a_ln, h, *P, "mlp", "qact2")
        x = x + h
        bs["qact4"] = acc(a_ln, x, *P, "qact4")
        st["blocks"].append(bs)

    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps)[:, 0]
    st["qact2"] = acc(a, x, "qact2")
    x = linear(x, params["head"]["w"], params["head"]["b"])
    st["act_out"] = acc(a, x, "act_out")
    return st


# ---------------------------------------------------------------------------
# Quantized forward (simulation)
# ---------------------------------------------------------------------------


def _fq(x, q):
    """Fake-quant an activation with a solved node (scalar or PTF [C] scale)."""
    return fake_quant(x, q["scale"], q["zp"], INT8)


def _fq_weight(w, wscale_dic, bit):
    """Weight fake-quant for eval bit index ``bit`` (0-d tensor): dic row
    2 + bit and its clamp bounds."""
    qmin = torch.tensor(EVAL_QMIN, device=w.device)[bit]
    qmax = torch.tensor(EVAL_QMAX, device=w.device)[bit]
    return fake_quant_dyn(w, wscale_dic[2 + bit][:, None], 0.0, qmin, qmax)


def _intln_or_ln(x, ln_params, policy, in_q, out_scale, eps):
    if policy.int_norm:
        return int_layernorm(x, ln_params["w"], ln_params["b"], in_q["scale"], out_scale)
    return layer_norm(x, ln_params["w"], ln_params["b"], eps)


@torch.no_grad()
def quant_forward(params, qstate, cfg: ViTConfig, policy: QuantPolicy, x, bit_idx):
    """Fully-quantized simulation forward; ``bit_idx`` from ``bits_to_idx``."""
    eps = cfg.ln_eps
    b = x.shape[0]
    bit_idx = bit_idx.to(x.device)
    x = _fq(x, qstate["qact_input"])

    patches = extract_patches(x, cfg.patch_size)
    pw = _fq_weight(params["patch_embed"]["w"], qstate["patch"]["wscale"], bit_idx[0])
    x = linear(patches, pw, params["patch_embed"]["b"])
    x = _fq(x, qstate["patch"]["qact"])

    cls = params["cls_token"].expand(b, 1, cfg.embed_dim)
    x = torch.cat([cls, x], dim=1)
    x = _fq(x, qstate["qact_embed"])
    x = x + _fq(params["pos_embed"], qstate["qact_pos"])
    x = _fq(x, qstate["qact1"])

    last_q = qstate["qact1"]
    for i, blk in enumerate(params["blocks"]):
        bq = qstate["blocks"][i]
        aq, mq = bq["attn"], bq["mlp"]
        bit_qkv, bit_proj, bit_fc1, bit_fc2 = bit_idx[1 + 4 * i: 5 + 4 * i]

        cs = aq["channel_scale"][bit_qkv]
        q0_scale = aq["qact0_scale"][bit_qkv]
        # int-LN1 folds the smoothing division into its output requant
        h = _intln_or_ln(x, blk["norm1"], policy, last_q, q0_scale * cs, eps)
        if policy.smoothquant:
            h = h / cs
        h = fake_quant(h, q0_scale, aq["qact0_zp"][bit_qkv], INT8)
        w_sm = blk["qkv"]["w"] * cs[None, :] if policy.smoothquant else blk["qkv"]["w"]
        h = linear(h, _fq_weight(w_sm, aq["wscale"][bit_qkv], bit_qkv), blk["qkv"]["b"])
        h = _fq(h, aq["qact1"])
        q, k, v = split_qkv(h, cfg.num_heads)
        attn = (q @ k.transpose(-1, -2)) * cfg.attn_scale
        attn = _fq(attn, aq["qact_attn1"])
        if policy.int_softmax:
            attn = log_int_softmax(attn, aq["qact_attn1"]["scale"], policy.bit_type_s)
        else:
            attn = torch.softmax(attn, dim=-1)
        h = merge_heads(attn @ v)
        h = _fq(h, aq["qact2"])
        h = linear(h, _fq_weight(blk["proj"]["w"], aq["proj_wscale"], bit_proj), blk["proj"]["b"])
        h = _fq(h, aq["qact3"])
        x = x + h
        x = _fq(x, bq["qact2"])

        cs_m = mq["channel_scale"][bit_fc1]
        q0m_scale = mq["qact0_scale"][bit_fc1]
        norm2_cs = cs if policy.norm2_attn_channel_scale_compat else cs_m
        h = _intln_or_ln(x, blk["norm2"], policy, bq["qact2"], q0m_scale * norm2_cs, eps)
        if policy.smoothquant:
            h = h / cs_m
        h = fake_quant(h, q0m_scale, mq["qact0_zp"][bit_fc1], INT8)
        w_sm = blk["fc1"]["w"] * cs_m[None, :] if policy.smoothquant else blk["fc1"]["w"]
        h = linear(h, _fq_weight(w_sm, mq["wscale"][bit_fc1], bit_fc1), blk["fc1"]["b"])
        h = gelu(h)
        h = _fq(h, mq["qact1"])
        h = linear(h, _fq_weight(blk["fc2"]["w"], mq["fc2_wscale"], bit_fc2), blk["fc2"]["b"])
        h = _fq(h, mq["qact2"])
        x = x + h
        x = _fq(x, bq["qact4"])
        last_q = bq["qact4"]

    x = _intln_or_ln(x, params["norm"], policy, last_q, qstate["qact2"]["scale"], eps)[:, 0]
    x = _fq(x, qstate["qact2"])
    x = linear(x, _fq_weight(params["head"]["w"], qstate["head_wscale"], bit_idx[-1]),
               params["head"]["b"])
    return _fq(x, qstate["act_out"])

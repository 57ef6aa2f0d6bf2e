"""Tensor-parallel int8 Swin serving: the megatron splits of
``parallel/tensor.py`` on the windowed family (counterpart of
``p2vit_tpu/parallel/tensor_swin.py``).

Per block, on each rank of a model group of tp ranks:

  * **qkv, column-parallel and head-aligned** per stage: the (3C_k, C_k)
    weight rows permuted head-major (``_qkv_tp_perm`` at the stage's head
    count), so each rank's block is a valid fused-qkv weight at
    heads_k/tp heads;
  * **window attention, head-parallel**: windows and heads are
    independent, so each rank runs the unmodified kernel
    (``swin_lis_attention``) on its heads with their rows of the rel-pos
    bias values; the shift masks do not depend on the head and stay whole;
  * **proj and fc2, row-parallel**: exact int32 partials over the
    in-feature block, summed over the group, then the kernels' own
    epilogues, ``requant_epilogue_plain`` for proj and
    ``res_ln_epilogue_plain`` for the fc2 junction with the next norm;
  * **fc1, column-parallel** with the fused GELU epilogue;
  * the stem, the attention-side residual junction, the int LNs, the
    PatchMerging reductions and the head run on every rank of the group.

No sequence parallelism, as in JAX: Swin's token count shrinks 4× a stage.
tp must divide every stage's head count and MLP width (``check_tp``):
heads (3, 6, 12, 24) admit tp ∈ {1, 3}; (4, 8, 16, 32) tp ∈ {1, 2, 4}.
The logits equal one process's ``serving_swin.serving_forward`` at its
default flags bit for bit.
"""

from __future__ import annotations

import torch

from .. import serving_swin
from ..models.swin import SwinConfig, _merge_patches, _roll, window_partition, window_reverse
from ..ops import attention_lis, intln, matmul_int8
from ..ops._lib import f32_vec
from ..ops.matmul_int8 import int_matmul_nt, requant_epilogue_plain
from ..ops.matmul_ln import res_ln_consts, res_ln_epilogue_plain
from ..serving_swin import _iln, _mean_codes, _residual_codes
from . import dist as pdist
from . import mesh as mesh_mod
from .tensor import _qkv_tp_perm


def check_tp(cfg: SwinConfig, tp: int) -> None:
    """Raise unless tp divides every stage's heads and mlp hidden width."""
    for k, heads in enumerate(cfg.num_heads):
        if heads % tp:
            raise ValueError(
                f"stage {k} heads={heads} not divisible by model axis "
                f"{tp} (Swin TP needs tp | heads at EVERY stage; "
                f"tiny/small admit tp=3, base tp in {{2,4}})"
            )
        if int(cfg.embed_dim * 2**k * cfg.mlp_ratio) % tp:
            raise ValueError(f"stage {k} mlp hidden not divisible by {tp}")


def _build_tp_state(s, qstate, cfg: SwinConfig, tp: int, m: int) -> dict:
    """Model shard ``m`` of ``tp``: per block the head-permuted qkv rows,
    this shard's heads of the bias values, the whole shift mask (over s2),
    the proj and fc2 in-feature columns, the fc1 rows, and every requant
    constant and epilogue vector formed once; the stem, merges and head
    whole. Each block's cyclic shift is a Python int (``shift``)."""
    def part(t, dim):  # a fresh tensor: a view at an offset may break the kernels' 16-byte alignment
        return t.chunk(tp, dim=dim)[m].clone(memory_format=torch.contiguous_format)

    stages = []
    s_prev = qstate["patch_qact"]["scale"]
    for i, st in enumerate(s["stages"]):
        heads, c = cfg.num_heads[i], cfg.stage_dim(i)
        hd = c // heads
        sqs = qstate["stages"][i]
        last_stage = i == len(s["stages"]) - 1
        nblk = len(st["blocks"])
        dev = st["blocks"][0]["qkv"]["w_q"].device
        perm = torch.from_numpy(_qkv_tp_perm(c, heads, tp)).to(dev)
        blocks = []
        for j, sb in enumerate(st["blocks"]):
            bq = sqs["blocks"][j]
            aq = bq["attn"]
            r_qkv = bq["qact1"]["scale"] * sb["qkv"]["sw"] / aq["qact1"]["scale"]
            b_qkv = sb["qkv_b"] / aq["qact1"]["scale"]
            r_fc2 = bq["mlp_qact1"]["scale"] * sb["fc2"]["sw"] / bq["mlp_qact2"]["scale"]
            b_fc2 = sb["fc2_b"] / bq["mlp_qact2"]["scale"]
            hid = sb["fc1"]["w_q"].shape[0]
            blk = {
                "shift": cfg.shift(i, j), "s_prev": s_prev, "norm1": sb["norm1"],
                "s_qact1": bq["qact1"]["scale"],
                "w_qkv": part(sb["qkv"]["w_q"][perm], 0),
                "r_qkv": part(f32_vec(r_qkv, 3 * c, dev)[perm], 0),
                "b_qkv": part(f32_vec(b_qkv, 3 * c, dev)[perm], 0),
                "bias_val": part(sb["bias_val"], 0), "mask_s2": sb["mask_s2"],
                "scales": (aq["qact1"]["scale"] ** 2 * hd**-0.5 / aq["qact_attn1"]["scale"],
                           aq["qact_attn1"]["scale"], aq["qact2"]["scale"],
                           aq["qact1"]["scale"] / aq["qact3"]["scale"]),
                "w_proj": part(sb["proj"]["w_q"], 1),
                "r_proj": f32_vec(aq["qact3"]["scale"] * sb["proj"]["sw"] / aq["qact4"]["scale"], c, dev),
                "b_proj": f32_vec(sb["proj_b"] / aq["qact4"]["scale"], c, dev),
                "s_qact4_attn": aq["qact4"]["scale"], "norm2": sb["norm2"],
                "s_blk_q2": bq["qact2"]["scale"], "s_qact3": bq["qact3"]["scale"],
                "w_fc1": part(sb["fc1"]["w_q"], 0),
                "r_fc1": part(f32_vec(bq["qact3"]["scale"] * sb["fc1"]["sw"], hid, dev), 0),
                "b_fc1": part(f32_vec(sb["fc1_b"], hid, dev), 0),
                "f1inv": 1.0 / bq["mlp_qact1"]["scale"],
                "w_fc2": part(sb["fc2"]["w_q"], 1),
                "s_mlp_q2": bq["mlp_qact2"]["scale"], "s_blk_q4": bq["qact4"]["scale"],
            }
            # the fc2 junction fuses the next norm1 (or the final norm), as
            # serving_forward's fuse_res path; before a PatchMerging a plain fc2
            if j + 1 < nblk or last_stage:
                if j + 1 < nblk:
                    ln_p, ln_out = st["blocks"][j + 1]["norm1"], sqs["blocks"][j + 1]["qact1"]["scale"]
                else:
                    ln_p, ln_out = s["norm"], qstate["qact2"]["scale"]
                blk["fc2_junction"] = res_ln_consts(c, dev, r_fc2, b_fc2, bq["mlp_qact2"]["scale"],
                                                    bq["qact2"]["scale"], bq["qact4"]["scale"],
                                                    ln_p["w"], ln_p["b"], ln_out, 1.0)
            else:
                blk["fc2_junction"] = None
                blk["r_fc2"], blk["b_fc2"] = f32_vec(r_fc2, c, dev), f32_vec(b_fc2, c, dev)
            blocks.append(blk)
            s_prev = bq["qact4"]["scale"]
        stage = {"blocks": blocks}
        if "downsample" in st:
            dq = sqs["downsample"]
            red = st["downsample"]["red"]
            stage["downsample"] = {"s_prev": s_prev, "norm": st["downsample"]["norm"],
                                   "s_q1": dq["qact1"]["scale"], "w_red": red["w_q"],
                                   "r_red": dq["qact1"]["scale"] * red["sw"] / dq["qact2"]["scale"]}
            s_prev = dq["qact2"]["scale"]
        stages.append(stage)
    stem = {k: s[k] for k in ("s_input", "zp_input", "patch", "patch_b", "patch_norm") if k in s}
    if "u8" in s:
        stem["u8"] = s["u8"]
    return {"stages": stages, "stem": stem, "final_s_prev": s_prev, "norm": s["norm"],
            "s_q2": qstate["qact2"]["scale"], "s_q3": qstate["qact3"]["scale"], "head": s["head"],
            "head_b": s["head_b"], "s_out": qstate["act_out"]["scale"], "min_s2": s["min_s2"]}


def _tp_block(blk, xc, h_ln, group, *, res, ws, heads_local, lis):
    """One Swin block on codes, on one model shard. ``xc``: (B, L, C)
    residual codes, the same on every rank of the group; ``h_ln``: the
    norm1 codes carried out of the previous block's fc2 junction, or None.
    Returns (xc', h_ln')."""
    mm, attn, res_ln = matmul_int8.int8_matmul_requant, attention_lis.swin_lis_attention, intln.int_res_ln_requant
    bs, l, c = xc.shape
    shift = blk["shift"]
    c_local = blk["w_qkv"].shape[0] // 3
    h = _iln(xc, blk["s_prev"], blk["norm1"], blk["s_qact1"]) if h_ln is None else h_ln
    hw = window_partition(_roll(h.reshape(bs, res, res, c), -shift), ws)
    hw = mm(hw.reshape(-1, c), blk["w_qkv"], blk["r_qkv"], blk["b_qkv"]).reshape(-1, ws * ws, 3 * c_local)
    hw = attn(hw, blk["bias_val"], blk["mask_s2"], heads_local, (res // ws) ** 2, *blk["scales"], lis=lis)
    # proj (row-parallel): this shard's attention channels are the w_proj
    # shard's in-features (head-aligned permutation) → exact sum → requant
    acc = pdist.all_reduce(int_matmul_nt(hw.reshape(-1, c_local), blk["w_proj"]), "sum", group)
    hw = requant_epilogue_plain(acc, blk["r_proj"], blk["b_proj"])
    h = _roll(window_reverse(hw.reshape(-1, ws * ws, c), ws, res, res), shift)
    # the attention-side junction and norm2, on every rank
    xc_f, h2 = res_ln(xc.reshape(-1, c), blk["s_prev"], h.reshape(-1, c).contiguous(), blk["s_qact4_attn"],
                      blk["s_blk_q2"], blk["norm2"]["w"], blk["norm2"]["b"], blk["s_qact3"], 1.0)
    # fc1 (column-parallel, fused GELU) → fc2 (row-parallel)
    hm = mm(h2, blk["w_fc1"], blk["r_fc1"], blk["b_fc1"], out_inv=blk["f1inv"], gelu=True)
    acc2 = pdist.all_reduce(int_matmul_nt(hm, blk["w_fc2"]), "sum", group)
    if blk["fc2_junction"] is not None:
        xc_n, h_n = res_ln_epilogue_plain(acc2, xc_f, *blk["fc2_junction"])
        return xc_n.reshape(bs, l, c), h_n.reshape(bs, l, c)
    h3 = requant_epilogue_plain(acc2, blk["r_fc2"], blk["b_fc2"])
    xc_n = _residual_codes(xc_f, blk["s_blk_q2"], h3, blk["s_mlp_q2"], blk["s_blk_q4"])
    return xc_n.reshape(bs, l, c), None


def tp_serving_fn(s, qstate, cfg: SwinConfig, mesh: mesh_mod.Mesh, *, lis: bool = True):
    """Per-batch callable on each rank of ``mesh``: DP×TP int8 Swin serving.

    Returns float32 logits of the whole batch on every rank, bit for bit
    ``serving_swin.serving_forward`` of one process at its default flags
    (module docstring). The shard is formed here, once per state; the batch
    is padded to a multiple of the data axis."""
    tp = mesh.shape["model"]
    check_tp(cfg, tp)
    lis = bool(lis)
    if lis:
        attention_lis.check_lis_scale(s["min_s2"])
    tps = _build_tp_state(s, qstate, cfg, tp, mesh.index("model"))
    group = mesh.group("model")
    nd = mesh.shape["data"]

    mm = matmul_int8.int8_matmul_requant

    @torch.no_grad()
    def fn(x):
        b = x.shape[0]
        xs = mesh_mod.shard_batch(mesh, mesh_mod.pad_batch(x, nd))
        bl = xs.shape[0]
        xc = serving_swin.stem_codes(tps["stem"], qstate, cfg, xs)
        final_ln = None
        for i, stage in enumerate(tps["stages"]):
            res, ws = cfg.stage_res(i), cfg.window(i)
            h_ln = None
            for blk in stage["blocks"]:
                xc, h_ln = _tp_block(blk, xc, h_ln, group, res=res, ws=ws, heads_local=cfg.num_heads[i] // tp,
                                     lis=lis)
            if "downsample" in stage:
                ds = stage["downsample"]
                xm = _iln(_merge_patches(xc, res), ds["s_prev"], ds["norm"], ds["s_q1"], expand=4)
                c2 = xm.shape[-1]
                xc = mm(xm.reshape(-1, c2), ds["w_red"], ds["r_red"], 0.0).reshape(bl, -1, c2 // 2)
            elif h_ln is not None:
                final_ln = h_ln
        if final_ln is None:
            final_ln = _iln(xc, tps["final_s_prev"], tps["norm"], tps["s_q2"])
        c3 = _mean_codes(final_ln, tps["s_q2"], tps["s_q3"])
        logits_c = mm(c3, tps["head"]["w_q"], tps["s_q3"] * tps["head"]["sw"] / tps["s_out"],
                      tps["head_b"] / tps["s_out"])
        return mesh_mod.gather_batch(mesh, logits_c.to(torch.float32) * tps["s_out"])[:b]

    return fn

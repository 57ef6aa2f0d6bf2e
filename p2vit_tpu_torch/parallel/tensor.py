"""Tensor-parallel int8 ViT serving: megatron-style TP over the mesh's
"model" axis (counterpart of ``p2vit_tpu/parallel/tensor.py``).

Per encoder layer, on each rank of a model group of tp ranks:

  * **qkv, column-parallel and head-aligned.** The (3C, C) weight rows are
    permuted head-major (``_qkv_tp_perm``), so a rank's contiguous block of
    3C/tp rows is ``[q; k; v]`` of its heads/tp heads: a valid fused-qkv
    weight that the unmodified kernels take. The requant epilogue is per
    output channel, so each channel is computed as the full matmul does.
  * **attention, head-parallel**, on the rank's heads.
  * **proj and fc2, row-parallel, reduced exactly.** Each rank contracts its
    block of in-features to a partial int32 accumulator
    (``int_matmul_nt``, exact); the group sums the int32 partials (integer
    addition: exact in any order) BEFORE the requant, and the residual +
    int-LN epilogue (``res_ln_epilogue_plain``, the junction kernel's own
    post-matmul chain) runs on the full accumulator. A requant before the
    sum would compute mid-node codes from partial sums.
  * **fc1, column-parallel**, with the fused GELU epilogue.
  * The embed prologue and the head run on every rank of the model group.

With ``seq_parallel`` the two junctions reduce-scatter the accumulator over
token rows instead: each rank runs the epilogue on its 1/tp of the rows and
an ``all_gather`` of the int8 codes rebuilds full rows; the residual codes
stay row-sharded across the depth.

Every sharded step computes whole output channels with the kernels or sums
exact integers before the shared epilogue, so the logits equal one
process's ``serving.serving_forward`` bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import serving
from ..models.common import ViTConfig
from ..ops import attention_lis, matmul_int8
from ..ops.matmul_int8 import int_matmul_nt
from ..ops.matmul_ln import res_ln_consts, res_ln_epilogue_plain
from . import dist as pdist
from . import mesh as mesh_mod


def _qkv_tp_perm(c: int, num_heads: int, tp: int) -> np.ndarray:
    """Row permutation of the (3C, C) qkv weight for head-aligned TP.

    Global rows are [q(all heads); k(all); v(all)]; the permuted order is,
    per model shard d, [q(heads of d); k(heads of d); v(heads of d)], so a
    contiguous split over "model" hands each rank a valid local fused-qkv
    weight at heads/tp heads (heads in global ascending order inside the
    shard, matching the columns of the proj weight's in-feature shard)."""
    hd = c // num_heads
    idx = np.arange(3 * c).reshape(3, num_heads // tp * tp, hd)
    idx = idx.reshape(3, tp, num_heads // tp, hd)
    return idx.transpose(1, 0, 2, 3).reshape(-1)


# The split axis (after the depth axis) of each entry of
# serving.stack_layer_consts's 29-tuple: 0 rows, 1 columns, None replicated.
_LAYER_SPECS = (
    0,     # w_qkv   (L, 3C, C)  column-parallel (permuted)
    0,     # qr      (L, 3C)
    0,     # qb      (L, 3C)
    None,  # srq
    None,  # sat
    None,  # oro
    1,     # w_proj  (L, C, C)   row-parallel (in-features)
    None, None, None, None, None, None, None, None, None,  # prr … ln2r: after the reduction
    0,     # w_fc1   (L, hid, C) column-parallel
    0,     # f1r     (L, hid)
    0,     # f1b     (L, hid)
    None,  # f1inv
    1,     # w_fc2   (L, C, hid) row-parallel
    None, None, None, None, None, None, None, None,  # f2r … lnnr: after the reduction
)


def _embed_head_state(s) -> dict:
    """The small slice of the serving state that the embed prologue and the
    head read; everything else lives in the sharded layer constants."""
    b0 = s["blocks"][0]
    es = {k: s[k] for k in ("s_input", "patch", "cls_codes", "s_embed", "pos_codes", "s_pos", "s_qact1",
                            "norm_w", "norm_b", "s_qact2", "head", "s_out")}
    es["blocks"] = [{"norm1_w": b0["norm1_w"], "norm1_b": b0["norm1_b"],
                     "qkv": {"s_act": b0["qkv"]["s_act"], "cs": b0["qkv"]["cs"]}}]
    if "u8" in s:  # raw-uint8 ingestion constants (serving.attach_u8_ingest)
        es["u8"] = s["u8"]
    return es


def shard_layers(s, cfg: ViTConfig, tp: int, m: int) -> list:
    """Model shard ``m`` of ``tp`` of every layer's constants: the qkv rows
    head-permuted, each entry split along its ``_LAYER_SPECS`` axis, and the
    two junctions' epilogue vectors formed once (``res_ln_consts``).
    Returns one (local 29-tuple, proj epilogue, fc2 epilogue) per layer."""
    consts = list(serving.stack_layer_consts(s, cfg))
    perm = torch.from_numpy(_qkv_tp_perm(cfg.embed_dim, cfg.num_heads, tp)).to(consts[0].device)
    for i in (0, 1, 2):
        consts[i] = consts[i][:, perm]
    local = []
    for c_, ax in zip(consts, _LAYER_SPECS):
        if ax is not None:
            c_ = c_.chunk(tp, dim=1 + ax)[m]
        local.append(c_)
    c = cfg.embed_dim
    layers = []
    for li in range(len(s["blocks"])):
        # fresh tensors: a view at an offset may break the kernels' 16-byte alignment
        lay = tuple(t[li].clone(memory_format=torch.contiguous_format) for t in local)
        proj_ep = res_ln_consts(c, lay[0].device, *lay[7:16])
        fc2_ep = res_ln_consts(c, lay[0].device, *lay[21:24], lay[11], *lay[24:29])
        layers.append((lay, proj_ep, fc2_ep))
    return layers


def _tp_layer(heads_local: int, layer, h, xc, group, *, lis, sp=False, fuse_qkv=True):
    """One encoder layer on codes, on one model shard. ``h``: (B, N, C)
    full-width codes, the same on every rank of the model group; ``xc``:
    the residual codes, (B, N, C), or with ``sp`` this rank's block of the
    B·N rows."""
    lay, (pr_vecs, pr_s1), (f2_vecs, f2_s1) = layer
    (w_qkv, qr, qb, srq, sat, oro, w_proj, *_, w_fc1, f1r, f1b, f1inv, w_fc2) = lay[:21]
    mm = matmul_int8.int8_matmul_requant
    attn_qkv, attn = attention_lis.lis_attention_qkv_fused, attention_lis.lis_attention_fused
    b, n_tok, c = h.shape
    c3l = w_qkv.shape[0]
    c_local = c3l // 3

    def reduce(acc):
        if sp:
            return pdist.reduce_scatter_rows(acc, group)
        return pdist.all_reduce(acc, "sum", group)

    def rows(codes):
        return pdist.all_gather_rows(codes, group) if sp else codes

    # qkv (column-parallel, whole channels) → attention on the local heads
    if fuse_qkv:
        a = attn_qkv(h, w_qkv, qr, qb, heads_local, srq, sat, oro, lis=lis)
    else:
        a = attn(mm(h.reshape(-1, c), w_qkv, qr, qb).reshape(b, n_tok, c3l), heads_local, srq, sat, oro,
                 lis=lis)
    # proj (row-parallel): partial int32 → exact sum → residual + LN2 epilogue
    acc = int_matmul_nt(a.reshape(-1, c_local), w_proj)
    res1 = xc if sp else xc.reshape(-1, c)
    xc2, h1 = res_ln_epilogue_plain(reduce(acc), res1, pr_vecs, pr_s1)
    # fc1 (column-parallel, fused GELU) → fc2 (row-parallel)
    hm = mm(rows(h1), w_fc1, f1r, f1b, out_inv=f1inv, gelu=True)
    acc2 = int_matmul_nt(hm, w_fc2)
    xc3, h3 = res_ln_epilogue_plain(reduce(acc2), xc2, f2_vecs, f2_s1)
    h3 = rows(h3).reshape(b, n_tok, c)
    return h3, (xc3 if sp else xc3.reshape(b, n_tok, c))


def check_tp(cfg: ViTConfig, hidden: int, tp: int) -> None:
    """Raise unless tp divides the heads and the MLP hidden width."""
    if cfg.num_heads % tp:
        raise ValueError(f"num_heads={cfg.num_heads} not divisible by model axis {tp}")
    if hidden % tp:
        raise ValueError(f"mlp hidden {hidden} not divisible by {tp}")


def tp_serving_fn(s, cfg: ViTConfig, mesh: mesh_mod.Mesh, *, lis: bool = True, fuse_qkv: bool = True,
                  seq_parallel: bool = False):
    """Per-batch callable on each rank of ``mesh``: DP×TP int8 serving.

    Returns float32 logits of the whole batch on every rank, bit for bit
    ``serving.serving_forward`` of one process. ``fuse_qkv`` runs the
    qkv-fused attention kernel on each shard (the default, as in one
    process), else the qkv GEMM and the attention over its codes.
    ``seq_parallel`` row-shards the two epilogues per layer (module
    docstring). The layer constants are sharded here, once per state.
    Pads the batch to a multiple of the data axis (times tp under
    ``seq_parallel``, so each shard's B·N rows split into tp blocks)."""
    tp = mesh.shape["model"]
    hidden = s["blocks"][0]["mlp_fc1"]["w_q"].shape[0]
    check_tp(cfg, hidden, tp)
    heads_local = cfg.num_heads // tp
    layers = shard_layers(s, cfg, tp, mesh.index("model"))
    es = _embed_head_state(s)
    group = mesh.group("model")
    nd = mesh.shape["data"]
    quantum = nd * tp if seq_parallel else nd

    @torch.no_grad()
    def fn(x):
        b = x.shape[0]
        xs = mesh_mod.shard_batch(mesh, mesh_mod.pad_batch(x, quantum))
        h, xc = serving.embed_codes(es, cfg, xs)
        if seq_parallel:  # enter the row-sharded residual stream: rank i of the model group holds block i
            xcf = xc.reshape(-1, cfg.embed_dim)
            per = xcf.shape[0] // tp
            xc = xcf[mesh.index("model") * per:(mesh.index("model") + 1) * per].contiguous()
        for layer in layers:
            h, xc = _tp_layer(heads_local, layer, h, xc, group, lis=lis, sp=seq_parallel, fuse_qkv=fuse_qkv)
        logits = serving.head_logits(es, h)
        return mesh_mod.gather_batch(mesh, logits)[:b]

    return fn

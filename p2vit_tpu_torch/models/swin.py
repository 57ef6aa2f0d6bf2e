"""Fully-quantized Swin Transformer (counterpart of ``p2vit_tpu/models/swin.py``).

Plain functions over a parameter dict with the JAX package's structure
(``stages`` → ``blocks`` with a per-block ``bias_table``, a ``downsample``
PatchMerging after every stage but the last):

  * ``fp_forward(params, cfg, x)``: the float forward.
  * ``collect_stats(params, cfg, policy, x, prev=None)``: the statistics
    pass over one calibration batch; ``calibrate(params, cfg, policy, x,
    stats=None)``: the solve over the last batch, with the ranges of
    earlier batches in ``stats``, giving the QuantState dict.
  * ``quant_forward`` / ``quant_forward_mixed``: the fake-quant simulation
    with a uniform or per-layer weight bit width.

The quantization nodes sit where the JAX package puts them: input fake-quant,
windowed attention with a fake-quantized relative-position-bias table and
shifted-window masks, PatchMerging concat → integer LN with
``in_scale_expand=4`` → reduction, final int-LN → token mean → head. Swin
carries no SmoothQuant.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import QuantPolicy
from ..quant.bit_type import BIT_TYPE_DICT
from ..quant.fake_quant import fake_quant
from ..quant.intops import int_layernorm, log_int_softmax
from ..quant.solve import accumulate_act_stats, solve_act, solve_weight_all_bits
from .common import gelu, layer_norm, linear, target_device, trunc_normal
from .vit import _fq_weight, _sget, bits_to_idx

INT8 = BIT_TYPE_DICT["int8"]


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    """Static architecture description (one per model-zoo entry)."""

    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 96
    depths: tuple = (2, 2, 6, 2)
    num_heads: tuple = (3, 6, 12, 24)
    window_size: int = 7
    mlp_ratio: float = 4.0
    ln_eps: float = 1e-5

    @property
    def num_layers(self):
        return len(self.depths)

    @property
    def num_matmuls(self):
        """Weight-layer count: patch conv + 4/block + 1/downsample + head."""
        return 2 + 4 * sum(self.depths) + (self.num_layers - 1)

    @property
    def num_features(self):
        return int(self.embed_dim * 2 ** (self.num_layers - 1))

    @property
    def grid(self):
        return self.img_size // self.patch_size

    def stage_dim(self, i):
        return int(self.embed_dim * 2**i)

    def stage_res(self, i):
        return self.grid // (2**i)

    def window(self, i):
        """Window side at stage i (the window shrinks to a small stage's grid)."""
        return min(self.window_size, self.stage_res(i))

    def shift(self, i, j):
        """Cyclic shift of block j of stage i: odd blocks shift by half a
        window, unless the stage is a single window."""
        if j % 2 == 0 or self.stage_res(i) <= self.window_size:
            return 0
        return self.window(i) // 2


def swin_flops(cfg: SwinConfig) -> list:
    """Multiply count per bit_config slot, in the calibration-walk order:
    [patch] + per stage (per block [qkv, proj, fc1, fc2], then [reduction])
    + [head]."""
    flops = [cfg.in_chans * cfg.patch_size**2 * cfg.embed_dim * cfg.grid**2]
    for i, depth in enumerate(cfg.depths):
        c = cfg.stage_dim(i)
        h = int(c * cfg.mlp_ratio)
        n = cfg.stage_res(i) ** 2
        for _ in range(depth):
            flops += [n * c * 3 * c, n * c * c, n * c * h, n * h * c]
        if i < cfg.num_layers - 1:
            flops.append((n // 4) * 4 * c * 2 * c)
    flops.append(cfg.num_features * cfg.num_classes)
    return flops


def mixed_layout(cfg: SwinConfig):
    """(groups, pinned) bit-config layout for the mixed-precision sampler:
    qkv/proj and fc1/fc2 share a gene, each reduction and the head are
    their own, slot 0 (patch) is pinned to the largest bit."""
    groups = []
    slot = 1
    for i, depth in enumerate(cfg.depths):
        for _ in range(depth):
            groups.append([slot, slot + 1])
            groups.append([slot + 2, slot + 3])
            slot += 4
        if i < cfg.num_layers - 1:
            groups.append([slot])
            slot += 1
    groups.append([slot])
    return groups, {0: None}


# ---------------------------------------------------------------------------
# Window helpers
# ---------------------------------------------------------------------------


def window_partition(x, ws: int):
    """(B, H, W, C) -> (B·nW, ws·ws, C), windows in (b, row, column) order."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    """(B·nW, ws·ws, C) -> (B, H, W, C)."""
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def relative_position_index(ws: int) -> np.ndarray:
    """(ws², ws²) index into the (2ws-1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = (flat[:, :, None] - flat[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_attn_mask(h: int, w: int, ws: int, shift: int) -> np.ndarray:
    """(nW, ws², ws²) 0/-100 float32 mask for shifted windows."""
    img = np.zeros((h, w), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(h // ws, ws, w // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    mask = mw[:, None, :] - mw[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


def shift_mask_tensor(cfg: SwinConfig, i: int, shift: int, device):
    """Stage i's shift mask as a float32 tensor on ``device`` (None: no shift)."""
    if not shift:
        return None
    res = cfg.stage_res(i)
    return torch.from_numpy(shift_attn_mask(res, res, cfg.window(i), shift)).to(device)


def _merge_patches(x, res):
    """PatchMerging's 2×2 neighbourhood concat: (B, res², C) → (B, res²/4, 4C)."""
    b, _, c = x.shape
    x = x.reshape(b, res, res, c)
    x0 = x[:, 0::2, 0::2]
    x1 = x[:, 1::2, 0::2]
    x2 = x[:, 0::2, 1::2]
    x3 = x[:, 1::2, 1::2]
    return torch.cat([x0, x1, x2, x3], -1).reshape(b, -1, 4 * c)


def _patches(x, p):
    """(B, C, H, W) → (B, N, C·p·p), K ordered c·p·p + i·p + j."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // p, p, w // p, p).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // p) * (w // p), c * p * p)


def _gather_bias(table, ws: int):
    """(2ws-1)² × heads table → (heads, ws², ws²) bias."""
    idx = torch.from_numpy(relative_position_index(ws).reshape(-1)).to(table.device)
    n = ws * ws
    return table[idx].reshape(n, n, -1).permute(2, 0, 1)


def _roll(h, shift):
    """Cyclic shift of a (B, H, W, C) map by ``shift`` rows and columns."""
    return torch.roll(h, (shift, shift), dims=(1, 2)) if shift else h


# ---------------------------------------------------------------------------
# Parameters and the float forward
# ---------------------------------------------------------------------------


def init_params(seed: int, cfg: SwinConfig, device="cuda") -> dict:
    """Random init from a seeded ``torch.Generator`` (trunc normal σ=0.02 for
    weights and bias tables, zero biases, unit LN weights, no reduction
    bias), on the card unless ``device`` says otherwise. The numbers differ
    from the JAX package's init for the same seed; tests hand both packages
    the same numpy params."""
    device = target_device(device)
    gen = torch.Generator(device="cpu").manual_seed(seed)
    n_bias = (2 * cfg.window_size - 1) ** 2

    def tn(shape):
        return trunc_normal(gen, shape).to(device)

    def lin(o, i, bias=True):
        return {"w": tn((o, i)), "b": torch.zeros(o, device=device) if bias else None}

    def ln(c):
        return {"w": torch.ones(c, device=device), "b": torch.zeros(c, device=device)}

    stages = []
    for i, depth in enumerate(cfg.depths):
        c = cfg.stage_dim(i)
        h = int(c * cfg.mlp_ratio)
        blocks = [
            {
                "norm1": ln(c),
                "qkv": lin(3 * c, c),
                "proj": lin(c, c),
                "bias_table": tn((n_bias, cfg.num_heads[i])),
                "norm2": ln(c),
                "fc1": lin(h, c),
                "fc2": lin(c, h),
            }
            for _ in range(depth)
        ]
        stage = {"blocks": blocks}
        if i < cfg.num_layers - 1:
            stage["downsample"] = {"norm": ln(4 * c), "reduction": lin(2 * c, 4 * c, bias=False)}
        stages.append(stage)
    return {
        "patch_embed": lin(cfg.embed_dim, cfg.in_chans * cfg.patch_size**2),
        "patch_norm": ln(cfg.embed_dim),
        "stages": stages,
        "norm": ln(cfg.num_features),
        "head": lin(cfg.num_classes, cfg.num_features),
    }


def _split_heads(hw, heads):
    """(B·nW, N, 3C) → q, k, v each (B·nW, heads, N, d)."""
    b_, n, c3 = hw.shape
    qkv = hw.reshape(b_, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _add_mask(attn, mask):
    """Add the (nW, N, N) shift mask to (B·nW, heads, N, N) scores."""
    if mask is None:
        return attn
    b_, heads, n, _ = attn.shape
    nw = mask.shape[0]
    return (attn.reshape(b_ // nw, nw, heads, n, n) + mask[None, :, None]).reshape(b_, heads, n, n)


def _merge_heads(x):
    """(B·nW, heads, N, d) → (B·nW, N, C)."""
    b_, heads, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b_, n, heads * d)


def _window_attention_fp(blk, cfg, stage, xw, mask):
    """fp windowed attention on (B·nW, N, C) windows, through proj."""
    heads = cfg.num_heads[stage]
    hd = xw.shape[-1] // heads
    q, k, v = _split_heads(linear(xw, blk["qkv"]["w"], blk["qkv"]["b"]), heads)
    attn = (q * hd**-0.5) @ k.transpose(-1, -2) + _gather_bias(blk["bias_table"], cfg.window(stage))[None]
    attn = torch.softmax(_add_mask(attn, mask), dim=-1)
    return linear(_merge_heads(attn @ v), blk["proj"]["w"], blk["proj"]["b"])


def fp_forward(params, cfg: SwinConfig, x):
    """Float Swin forward in the dtype of ``x`` and ``params``."""
    eps = cfg.ln_eps
    x = linear(_patches(x, cfg.patch_size), params["patch_embed"]["w"], params["patch_embed"]["b"])
    x = layer_norm(x, params["patch_norm"]["w"], params["patch_norm"]["b"], eps)
    for i, stage in enumerate(params["stages"]):
        res, ws = cfg.stage_res(i), cfg.window(i)
        for j, blk in enumerate(stage["blocks"]):
            shift = cfg.shift(i, j)
            b, l, c = x.shape
            h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
            hw = window_partition(_roll(h.reshape(b, res, res, c), -shift), ws)
            mask = shift_mask_tensor(cfg, i, shift, x.device)
            if mask is not None:
                mask = mask.to(x.dtype)
            hw = _window_attention_fp(blk, cfg, i, hw, mask)
            x = x + _roll(window_reverse(hw, ws, res, res), shift).reshape(b, l, c)
            h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
            h = gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"]))
            x = x + linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
        if "downsample" in stage:
            ds = stage["downsample"]
            x = layer_norm(_merge_patches(x, res), ds["norm"]["w"], ds["norm"]["b"], eps)
            x = linear(x, ds["reduction"]["w"], None)
    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps).mean(dim=1)
    return linear(x, params["head"]["w"], params["head"]["b"])


# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SwinCalibResult:
    qstate: dict
    global_distance: torch.Tensor  # (n_weight_layers, 4) per-bit L2 errors
    flops: list = dataclasses.field(default_factory=list)


def _qact(method, x, bit_type=INT8, prev=None):
    """Solve one activation node → its qstate entry (``prev``: the running
    stats of earlier batches)."""
    out = solve_act(method, x, bit_type, stats=accumulate_act_stats(method, x, prev))
    if len(out) == 3:
        return {"scale": out[0], "zp": out[1], "mask": out[2]}
    return {"scale": out[0], "zp": out[1]}


@torch.no_grad()
def calibrate(params, cfg: SwinConfig, policy: QuantPolicy, x, stats=None) -> SwinCalibResult:
    """Calibration pass (stats and parameter solve, quant off), node for node
    as the JAX twin; ``stats`` from ``collect_stats`` over earlier batches,
    or None for this batch alone."""
    a, a_ln = policy.observer_a, policy.observer_a_ln
    eps = cfg.ln_eps
    dists: list = []
    qs: dict = {}

    def wsolve(w, xin):
        scale, dist = solve_weight_all_bits(w, xin.reshape(-1, xin.shape[-1]))
        dists.append(dist)
        return scale

    # the input quantizer observes the raw image; it only bites at eval
    qs["qact_input"] = _qact(a, x, prev=_sget(stats, "qact_input"))
    patches = _patches(x, cfg.patch_size)
    qs["patch_wscale"] = wsolve(params["patch_embed"]["w"], patches)
    x = linear(patches, params["patch_embed"]["w"], params["patch_embed"]["b"])
    qs["patch_qact_bn"] = _qact(a, x, prev=_sget(stats, "patch_qact_bn"))
    x = layer_norm(x, params["patch_norm"]["w"], params["patch_norm"]["b"], eps)
    qs["patch_qact"] = _qact(a, x, prev=_sget(stats, "patch_qact"))

    qs["stages"] = []
    for i, stage in enumerate(params["stages"]):
        res, ws = cfg.stage_res(i), cfg.window(i)
        heads = cfg.num_heads[i]
        sq: dict = {"blocks": []}
        for j, blk in enumerate(stage["blocks"]):
            pbq = _sget(stats, "stages", i, "blocks", j)
            shift = cfg.shift(i, j)
            b, l, c = x.shape
            hd = c // heads
            bq: dict = {}
            shortcut = x
            h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
            bq["qact1"] = _qact(a, h, prev=_sget(pbq, "qact1"))
            hw = window_partition(_roll(h.reshape(b, res, res, c), -shift), ws)
            aq: dict = {}
            aq["qkv_wscale"] = wsolve(blk["qkv"]["w"], hw)
            hw2 = linear(hw, blk["qkv"]["w"], blk["qkv"]["b"])
            aq["qact1"] = _qact(a, hw2, prev=_sget(pbq, "attn", "qact1"))
            q, k, v = _split_heads(hw2, heads)
            attn = (q * hd**-0.5) @ k.transpose(-1, -2)
            aq["qact_attn1"] = _qact(a, attn, prev=_sget(pbq, "attn", "qact_attn1"))
            aq["qact_table"] = _qact(a, blk["bias_table"], prev=_sget(pbq, "attn", "qact_table"))
            attn = attn + _gather_bias(blk["bias_table"], ws)[None]
            aq["qact2"] = _qact(a, attn, prev=_sget(pbq, "attn", "qact2"))
            attn = _add_mask(attn, shift_mask_tensor(cfg, i, shift, x.device))
            if policy.int_softmax:
                attn = log_int_softmax(attn, aq["qact2"]["scale"], policy.bit_type_s)
            else:
                attn = torch.softmax(attn, dim=-1)
            hw = _merge_heads(attn @ v)
            aq["qact3"] = _qact(a, hw, prev=_sget(pbq, "attn", "qact3"))
            aq["proj_wscale"] = wsolve(blk["proj"]["w"], hw)
            hw = linear(hw, blk["proj"]["w"], blk["proj"]["b"])
            aq["qact4"] = _qact(a, hw, prev=_sget(pbq, "attn", "qact4"))
            bq["attn"] = aq
            x = shortcut + _roll(window_reverse(hw, ws, res, res), shift).reshape(b, l, c)
            bq["qact2"] = _qact(a_ln, x, prev=_sget(pbq, "qact2"))
            h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
            bq["qact3"] = _qact(a, h, prev=_sget(pbq, "qact3"))
            bq["fc1_wscale"] = wsolve(blk["fc1"]["w"], h)
            h = gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"]))
            bq["mlp_qact1"] = _qact(a, h, prev=_sget(pbq, "mlp_qact1"))
            bq["fc2_wscale"] = wsolve(blk["fc2"]["w"], h)
            h = linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
            bq["mlp_qact2"] = _qact(a_ln, h, prev=_sget(pbq, "mlp_qact2"))
            x = x + h
            bq["qact4"] = _qact(a_ln, x, prev=_sget(pbq, "qact4"))
            sq["blocks"].append(bq)
        if "downsample" in stage:
            ds = stage["downsample"]
            x = layer_norm(_merge_patches(x, res), ds["norm"]["w"], ds["norm"]["b"], eps)
            pdq = _sget(stats, "stages", i, "downsample")
            dq = {"qact1": _qact(a, x, prev=_sget(pdq, "qact1")), "red_wscale": wsolve(ds["reduction"]["w"], x)}
            x = linear(x, ds["reduction"]["w"], None)
            dq["qact2"] = _qact(a_ln, x, prev=_sget(pdq, "qact2"))
            sq["downsample"] = dq
        qs["stages"].append(sq)

    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps)
    qs["qact2"] = _qact(a, x, prev=_sget(stats, "qact2"))
    x = x.mean(dim=1)
    qs["qact3"] = _qact(a, x, prev=_sget(stats, "qact3"))
    qs["head_wscale"] = wsolve(params["head"]["w"], x)
    x = linear(x, params["head"]["w"], params["head"]["b"])
    qs["act_out"] = _qact(a, x, prev=_sget(stats, "act_out"))
    return SwinCalibResult(qstate=qs, global_distance=torch.stack(dists), flops=swin_flops(cfg))


@torch.no_grad()
def collect_stats(params, cfg: SwinConfig, policy: QuantPolicy, x, prev=None) -> dict:
    """The statistics pass over one calibration batch: the float forward,
    every activation node merging its range into ``prev`` (keys as the
    qstate's); the attention takes the float softmax (no LIS scale yet)."""
    a, a_ln = policy.observer_a, policy.observer_a_ln
    eps = cfg.ln_eps
    st: dict = {}

    def acc(method, v, *path):
        return accumulate_act_stats(method, v, _sget(prev, *path))

    st["qact_input"] = acc(a, x, "qact_input")
    x = linear(_patches(x, cfg.patch_size), params["patch_embed"]["w"], params["patch_embed"]["b"])
    st["patch_qact_bn"] = acc(a, x, "patch_qact_bn")
    x = layer_norm(x, params["patch_norm"]["w"], params["patch_norm"]["b"], eps)
    st["patch_qact"] = acc(a, x, "patch_qact")

    st["stages"] = []
    for i, stage in enumerate(params["stages"]):
        res, ws = cfg.stage_res(i), cfg.window(i)
        heads = cfg.num_heads[i]
        ss: dict = {"blocks": []}
        for j, blk in enumerate(stage["blocks"]):
            P = ("stages", i, "blocks", j)
            shift = cfg.shift(i, j)
            b, l, c = x.shape
            hd = c // heads
            bs: dict = {"attn": {}}
            shortcut = x
            h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
            bs["qact1"] = acc(a, h, *P, "qact1")
            hw = window_partition(_roll(h.reshape(b, res, res, c), -shift), ws)
            hw2 = linear(hw, blk["qkv"]["w"], blk["qkv"]["b"])
            bs["attn"]["qact1"] = acc(a, hw2, *P, "attn", "qact1")
            q, k, v = _split_heads(hw2, heads)
            attn = (q * hd**-0.5) @ k.transpose(-1, -2)
            bs["attn"]["qact_attn1"] = acc(a, attn, *P, "attn", "qact_attn1")
            bs["attn"]["qact_table"] = acc(a, blk["bias_table"], *P, "attn", "qact_table")
            attn = attn + _gather_bias(blk["bias_table"], ws)[None]
            bs["attn"]["qact2"] = acc(a, attn, *P, "attn", "qact2")
            attn = torch.softmax(_add_mask(attn, shift_mask_tensor(cfg, i, shift, x.device)), dim=-1)
            hw = _merge_heads(attn @ v)
            bs["attn"]["qact3"] = acc(a, hw, *P, "attn", "qact3")
            hw = linear(hw, blk["proj"]["w"], blk["proj"]["b"])
            bs["attn"]["qact4"] = acc(a, hw, *P, "attn", "qact4")
            x = shortcut + _roll(window_reverse(hw, ws, res, res), shift).reshape(b, l, c)
            bs["qact2"] = acc(a_ln, x, *P, "qact2")
            h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
            bs["qact3"] = acc(a, h, *P, "qact3")
            h = gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"]))
            bs["mlp_qact1"] = acc(a, h, *P, "mlp_qact1")
            h = linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
            bs["mlp_qact2"] = acc(a_ln, h, *P, "mlp_qact2")
            x = x + h
            bs["qact4"] = acc(a_ln, x, *P, "qact4")
            ss["blocks"].append(bs)
        if "downsample" in stage:
            ds = stage["downsample"]
            x = layer_norm(_merge_patches(x, res), ds["norm"]["w"], ds["norm"]["b"], eps)
            dq = {"qact1": acc(a, x, "stages", i, "downsample", "qact1")}
            x = linear(x, ds["reduction"]["w"], None)
            dq["qact2"] = acc(a_ln, x, "stages", i, "downsample", "qact2")
            ss["downsample"] = dq
        st["stages"].append(ss)

    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps)
    st["qact2"] = acc(a, x, "qact2")
    x = x.mean(dim=1)
    st["qact3"] = acc(a, x, "qact3")
    x = linear(x, params["head"]["w"], params["head"]["b"])
    st["act_out"] = acc(a, x, "act_out")
    return st


# ---------------------------------------------------------------------------
# Quantized forward (simulation)
# ---------------------------------------------------------------------------


def _fq(x, q):
    return fake_quant(x, q["scale"], q["zp"], INT8)


def _intln(x, lnp, policy, in_q, out_scale, eps, expand=1):
    if policy.int_norm:
        return int_layernorm(x, lnp["w"], lnp["b"], in_q["scale"], out_scale, in_scale_expand=expand)
    return layer_norm(x, lnp["w"], lnp["b"], eps)


def quant_forward(params, qstate, cfg: SwinConfig, policy: QuantPolicy, x, w_bit: int = 8):
    """Fully-quantized Swin forward with a uniform weight bit width."""
    return quant_forward_mixed(params, qstate, cfg, policy, x, bits_to_idx([w_bit] * cfg.num_matmuls))


@torch.no_grad()
def quant_forward_mixed(params, qstate, cfg: SwinConfig, policy: QuantPolicy, x, bit_idx):
    """Fully-quantized Swin forward with per-layer weight bits; ``bit_idx``
    from ``bits_to_idx`` in the calibration-walk slot order."""
    eps = cfg.ln_eps
    bit_idx = bit_idx.to(x.device)
    slot = iter(range(cfg.num_matmuls))

    def fqw(w, wscale):
        return _fq_weight(w, wscale, bit_idx[next(slot)])

    x = _fq(x, qstate["qact_input"])
    patches = _patches(x, cfg.patch_size)
    x = linear(patches, fqw(params["patch_embed"]["w"], qstate["patch_wscale"]),
               params["patch_embed"]["b"])
    x = _fq(x, qstate["patch_qact_bn"])
    x = _intln(x, params["patch_norm"], policy, qstate["patch_qact_bn"],
               qstate["patch_qact"]["scale"], eps)
    x = _fq(x, qstate["patch_qact"])
    last_q = qstate["patch_qact"]

    for i, stage in enumerate(params["stages"]):
        res, ws = cfg.stage_res(i), cfg.window(i)
        heads = cfg.num_heads[i]
        sq = qstate["stages"][i]
        for j, blk in enumerate(stage["blocks"]):
            bq = sq["blocks"][j]
            aq = bq["attn"]
            shift = cfg.shift(i, j)
            b, l, c = x.shape
            hd = c // heads
            shortcut = x
            h = _intln(x, blk["norm1"], policy, last_q, bq["qact1"]["scale"], eps)
            h = _fq(h, bq["qact1"])
            hw = window_partition(_roll(h.reshape(b, res, res, c), -shift), ws)
            hw = linear(hw, fqw(blk["qkv"]["w"], aq["qkv_wscale"]), blk["qkv"]["b"])
            hw = _fq(hw, aq["qact1"])
            q, k, v = _split_heads(hw, heads)
            attn = _fq((q * hd**-0.5) @ k.transpose(-1, -2), aq["qact_attn1"])
            table_q = _fq(blk["bias_table"], aq["qact_table"])
            attn = _fq(attn + _gather_bias(table_q, ws)[None], aq["qact2"])
            attn = _add_mask(attn, shift_mask_tensor(cfg, i, shift, x.device))
            if policy.int_softmax:
                attn = log_int_softmax(attn, aq["qact2"]["scale"], policy.bit_type_s)
            else:
                attn = torch.softmax(attn, dim=-1)
            hw = _fq(_merge_heads(attn @ v), aq["qact3"])
            hw = linear(hw, fqw(blk["proj"]["w"], aq["proj_wscale"]), blk["proj"]["b"])
            hw = _fq(hw, aq["qact4"])
            x = shortcut + _roll(window_reverse(hw, ws, res, res), shift).reshape(b, l, c)
            x = _fq(x, bq["qact2"])
            h = _intln(x, blk["norm2"], policy, bq["qact2"], bq["qact3"]["scale"], eps)
            h = _fq(h, bq["qact3"])
            h = linear(h, fqw(blk["fc1"]["w"], bq["fc1_wscale"]), blk["fc1"]["b"])
            h = _fq(gelu(h), bq["mlp_qact1"])
            h = linear(h, fqw(blk["fc2"]["w"], bq["fc2_wscale"]), blk["fc2"]["b"])
            h = _fq(h, bq["mlp_qact2"])
            x = _fq(x + h, bq["qact4"])
            last_q = bq["qact4"]
        if "downsample" in stage:
            ds = stage["downsample"]
            dq = sq["downsample"]
            # in_scale_expand=4: the previous node's [C] scale tiles over the
            # 4C concat
            x = _intln(_merge_patches(x, res), ds["norm"], policy, last_q, dq["qact1"]["scale"],
                       eps, expand=4)
            x = _fq(x, dq["qact1"])
            x = _fq(linear(x, fqw(ds["reduction"]["w"], dq["red_wscale"]), None), dq["qact2"])
            last_q = dq["qact2"]

    x = _intln(x, params["norm"], policy, last_q, qstate["qact2"]["scale"], eps)
    x = _fq(x, qstate["qact2"])
    x = _fq(x.mean(dim=1), qstate["qact3"])
    x = linear(x, fqw(params["head"]["w"], qstate["head_wscale"]), params["head"]["b"])
    return _fq(x, qstate["act_out"])

"""Plain reference of the quantized Swin Transformer (Liu et al., arXiv
2103.14030) under P²-ViT's post-training quantization: calibration on one
batch, the freeze into weight codes and constants, uint8 ingest, and the
integer forward with shifted windows, the relative-position bias, the shift
masks and patch merging, all in plain PyTorch.

Each step is worked out here again from the weights and the calibration
images that the benchmark made; nothing of the program is imported.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import intops as io
from .quant import WEIGHT_ROW, gelu, layer_norm, linear, log_int_softmax, qact, weight_scales
from .vit import QMAX, QMIN, normalize_u8, patches


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    img_size: int
    patch_size: int
    in_chans: int
    num_classes: int
    embed_dim: int
    depths: tuple
    num_heads: tuple
    window_size: int
    mlp_ratio: float
    ln_eps: float

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    def stage_res(self, i: int) -> int:
        return self.grid // 2 ** i

    def window(self, i: int) -> int:
        return min(self.window_size, self.stage_res(i))

    def shift(self, i: int, j: int) -> int:
        """Odd blocks shift by half a window, unless the stage is one window."""
        if j % 2 == 0 or self.stage_res(i) <= self.window_size:
            return 0
        return self.window(i) // 2


def config(sizes: dict) -> SwinConfig:
    kw = {f.name: sizes[f.name] for f in dataclasses.fields(SwinConfig)}
    kw["depths"], kw["num_heads"] = tuple(kw["depths"]), tuple(kw["num_heads"])
    return SwinConfig(**kw)


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    x = x.reshape(b, h // ws, ws, w // ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, ws * ws, c)


def window_reverse(windows, ws: int, h: int, w: int):
    c = windows.shape[-1]
    b = windows.shape[0] // (h * w // ws // ws)
    x = windows.reshape(b, h // ws, w // ws, ws, ws, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, c)


def rel_index(ws: int) -> np.ndarray:
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)


def shift_mask(cfg: SwinConfig, i: int, shift: int, device):
    """(nW, N, N) 0/-100 mask of stage i's shifted windows (None: no shift)."""
    if not shift:
        return None
    res, ws = cfg.stage_res(i), cfg.window(i)
    img = np.zeros((res, res), dtype=np.float32)
    cnt = 0
    for hs in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for wsl in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[hs, wsl] = cnt
            cnt += 1
    mw = img.reshape(res // ws, ws, res // ws, ws).transpose(0, 2, 1, 3).reshape(-1, ws * ws)
    m = mw[:, None, :] - mw[:, :, None]
    return torch.from_numpy(np.where(m != 0, -100.0, 0.0).astype(np.float32)).to(device)


def merge_patches(x, res):
    b, _, c = x.shape
    x = x.reshape(b, res, res, c)
    return torch.cat([x[:, 0::2, 0::2], x[:, 1::2, 0::2], x[:, 0::2, 1::2], x[:, 1::2, 1::2]], -1).reshape(
        b, -1, 4 * c)


def roll(h, shift):
    return torch.roll(h, (shift, shift), dims=(1, 2)) if shift else h


def _heads(hw, heads):
    b_, n, c3 = hw.shape
    qkv = hw.reshape(b_, n, 3, heads, c3 // 3 // heads).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def _add_mask(attn, mask):
    if mask is None:
        return attn
    b_, heads, n, _ = attn.shape
    nw = mask.shape[0]
    return (attn.reshape(b_ // nw, nw, heads, n, n) + mask[None, :, None]).reshape(b_, heads, n, n)


# ---------------------------------------------------------------------------
# calibration
# ---------------------------------------------------------------------------


@torch.no_grad()
def calibrate(params, cfg: SwinConfig, x, a: str = "minmax", a_ln: str = "ptf") -> dict:
    """The quant state of one calibration batch ``x`` (float32, normalized)."""
    eps = cfg.ln_eps

    def wsolve(w, xin):
        return weight_scales(w, xin.reshape(-1, xin.shape[-1]))

    qs: dict = {"qact_input": qact(a, x)}
    pt = patches(x, cfg.patch_size)
    qs["patch_wscale"] = wsolve(params["patch_embed"]["w"], pt)
    x = linear(pt, params["patch_embed"]["w"], params["patch_embed"]["b"])
    qs["patch_qact_bn"] = qact(a, x)
    x = layer_norm(x, params["patch_norm"]["w"], params["patch_norm"]["b"], eps)
    qs["patch_qact"] = qact(a, x)
    qs["stages"] = []
    for i, stage in enumerate(params["stages"]):
        res, ws, heads = cfg.stage_res(i), cfg.window(i), cfg.num_heads[i]
        sq: dict = {"blocks": []}
        for j, blk in enumerate(stage["blocks"]):
            shift = cfg.shift(i, j)
            b, l, c = x.shape
            hd = c // heads
            bq: dict = {}
            shortcut = x
            h = layer_norm(x, blk["norm1"]["w"], blk["norm1"]["b"], eps)
            bq["qact1"] = qact(a, h)
            hw = window_partition(roll(h.reshape(b, res, res, c), -shift), ws)
            aq: dict = {"qkv_wscale": wsolve(blk["qkv"]["w"], hw)}
            hw2 = linear(hw, blk["qkv"]["w"], blk["qkv"]["b"])
            aq["qact1"] = qact(a, hw2)
            q, k, v = _heads(hw2, heads)
            attn = (q * hd ** -0.5) @ k.transpose(-1, -2)
            aq["qact_attn1"] = qact(a, attn)
            aq["qact_table"] = qact(a, blk["bias_table"])
            idx = torch.from_numpy(rel_index(ws).reshape(-1)).to(x.device)
            bias = blk["bias_table"][idx].reshape(ws * ws, ws * ws, -1).permute(2, 0, 1)
            attn = attn + bias[None]
            aq["qact2"] = qact(a, attn)
            attn = log_int_softmax(_add_mask(attn, shift_mask(cfg, i, shift, x.device)), aq["qact2"]["scale"])
            hw = (attn @ v).permute(0, 2, 1, 3).reshape(hw.shape[0], ws * ws, c)
            aq["qact3"] = qact(a, hw)
            aq["proj_wscale"] = wsolve(blk["proj"]["w"], hw)
            hw = linear(hw, blk["proj"]["w"], blk["proj"]["b"])
            aq["qact4"] = qact(a, hw)
            bq["attn"] = aq
            x = shortcut + roll(window_reverse(hw, ws, res, res), shift).reshape(b, l, c)
            bq["qact2"] = qact(a_ln, x)
            h = layer_norm(x, blk["norm2"]["w"], blk["norm2"]["b"], eps)
            bq["qact3"] = qact(a, h)
            bq["fc1_wscale"] = wsolve(blk["fc1"]["w"], h)
            h = gelu(linear(h, blk["fc1"]["w"], blk["fc1"]["b"]))
            bq["mlp_qact1"] = qact(a, h)
            bq["fc2_wscale"] = wsolve(blk["fc2"]["w"], h)
            h = linear(h, blk["fc2"]["w"], blk["fc2"]["b"])
            bq["mlp_qact2"] = qact(a_ln, h)
            x = x + h
            bq["qact4"] = qact(a_ln, x)
            sq["blocks"].append(bq)
        if "downsample" in stage:
            ds = stage["downsample"]
            x = layer_norm(merge_patches(x, res), ds["norm"]["w"], ds["norm"]["b"], eps)
            dq = {"qact1": qact(a, x), "red_wscale": wsolve(ds["reduction"]["w"], x)}
            x = linear(x, ds["reduction"]["w"], None)
            dq["qact2"] = qact(a_ln, x)
            sq["downsample"] = dq
        qs["stages"].append(sq)
    x = layer_norm(x, params["norm"]["w"], params["norm"]["b"], eps)
    qs["qact2"] = qact(a, x)
    x = x.mean(dim=1)
    qs["qact3"] = qact(a, x)
    qs["head_wscale"] = wsolve(params["head"]["w"], x)
    x = linear(x, params["head"]["w"], params["head"]["b"])
    qs["act_out"] = qact(a, x)
    return qs


# ---------------------------------------------------------------------------
# freeze
# ---------------------------------------------------------------------------


def freeze(params, qs, cfg: SwinConfig, bits: int, mean, std) -> dict:
    """Weight codes and constants at a uniform weight bit width, the bias
    values and shift masks each block's attention takes, and the ingest's
    normalization."""
    row = WEIGHT_ROW[bits]

    def wq(w, tab):
        sw = tab[row]
        return {"w_q": torch.clamp(torch.round(w / sw[:, None]), QMIN[bits], QMAX[bits]).to(torch.int8), "sw": sw}

    dev = qs["qact_input"]["scale"].device
    s: dict = {"qs": qs, "patch": wq(params["patch_embed"]["w"], qs["patch_wscale"]),
               "patch_b": params["patch_embed"]["b"],
               "head": wq(params["head"]["w"], qs["head_wscale"]), "head_b": params["head"]["b"],
               "patch_norm": params["patch_norm"], "norm": params["norm"], "stages": [],
               "mean": torch.from_numpy(np.asarray(mean, np.float32).reshape(3)).to(dev),
               "std": torch.from_numpy(np.asarray(std, np.float32).reshape(3)).to(dev)}
    for i, stage in enumerate(params["stages"]):
        sq = qs["stages"][i]
        ws, heads = cfg.window(i), cfg.num_heads[i]
        n = ws * ws
        st: dict = {"blocks": []}
        for j, blk in enumerate(stage["blocks"]):
            bq = sq["blocks"][j]
            aq = bq["attn"]
            ts = aq["qact_table"]["scale"]
            table_q = torch.clamp(torch.round(blk["bias_table"] / ts), *io.I8)
            idx = torch.from_numpy(rel_index(ws).reshape(-1)).to(dev)
            mask = shift_mask(cfg, i, cfg.shift(i, j), dev)
            st["blocks"].append({
                "qkv": wq(blk["qkv"]["w"], aq["qkv_wscale"]), "qkv_b": blk["qkv"]["b"],
                "proj": wq(blk["proj"]["w"], aq["proj_wscale"]), "proj_b": blk["proj"]["b"],
                "fc1": wq(blk["fc1"]["w"], bq["fc1_wscale"]), "fc1_b": blk["fc1"]["b"],
                "fc2": wq(blk["fc2"]["w"], bq["fc2_wscale"]), "fc2_b": blk["fc2"]["b"],
                "norm1": blk["norm1"], "norm2": blk["norm2"],
                "bias_val": (table_q[idx] * ts).reshape(n, n, heads).permute(2, 0, 1).contiguous(),
                "mask_s2": None if mask is None else mask / aq["qact2"]["scale"]})
        if "downsample" in stage:
            ds = stage["downsample"]
            st["downsample"] = {"red": wq(ds["reduction"]["w"], sq["downsample"]["red_wscale"]),
                                "norm": ds["norm"]}
        s["stages"].append(st)
    return s


# ---------------------------------------------------------------------------
# the integer forward
# ---------------------------------------------------------------------------


def _iln(codes, s_in, lnp, out_scale, expand=1):
    s_in_v = torch.broadcast_to(torch.as_tensor(s_in, dtype=torch.float32, device=codes.device),
                                (codes.shape[-1] // expand,)).repeat(expand)
    return io.int_ln(codes, s_in_v, lnp["w"], lnp["b"], out_scale)


def _residual(a, s_a, b, s_b, s_out):
    val = a.to(torch.float32) * s_a + b.to(torch.float32) * s_b
    return torch.clamp(torch.round(val / s_out), *io.I8).to(torch.int8)


def _windows(qkv_q, bias, mask, heads, n_windows, rq, attn_scale, s2, ro):
    """LIS attention over (W, N, 3C) window panels → (W, N, C) codes."""
    w, n, c3 = qkv_q.shape
    c = c3 // 3
    dev = qkv_q.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(())  # noqa: E731
    s2t = f32(s2)
    rq, s1, inv_s2, ro = f32(rq), f32(attn_scale), torch.ones_like(s2t) / s2t, f32(ro)
    qkv = qkv_q.reshape(w, n, 3, heads, c // heads).permute(2, 0, 3, 1, 4)
    attn_c = io.scores(qkv[0], qkv[1], rq)
    attn2 = torch.clamp(torch.round((attn_c * s1 + bias.to(torch.float32)[None]) * inv_s2), *io.I8)
    if mask is not None:
        attn2 = (attn2.reshape(w // n_windows, n_windows, heads, n, n)
                 + mask.to(torch.float32)[None, :, None]).reshape(w, heads, n, n)
    out = io.attend(attn2, qkv[2], s2t, ro)
    return out.permute(0, 2, 1, 3).reshape(w, n, c)


@torch.no_grad()
def forward(s, cfg: SwinConfig, x, act=io.codes8):
    """uint8 images (B, 3, H, W) → float32 logits (B, classes)."""
    qs = s["qs"]
    b = x.shape[0]
    s_in, zp = qs["qact_input"]["scale"], qs["qact_input"]["zp"]
    q0 = act(torch.clamp(torch.round(normalize_u8(x, s["mean"], s["std"]) / s_in + zp), *io.I8))
    sq_bn = qs["patch_qact_bn"]["scale"]
    pw = s["patch"]["w_q"].to(torch.float32) * s["patch"]["sw"][:, None]
    px = patches((q0 - zp) * s_in, cfg.patch_size)
    hp = px @ pw.T + s["patch_b"]
    xc = torch.clamp(torch.round(hp / sq_bn), *io.I8).to(torch.int8)
    xc = act(_iln(xc, sq_bn, s["patch_norm"], qs["patch_qact"]["scale"]).reshape(b, px.shape[1], -1))
    s_prev = qs["patch_qact"]["scale"]
    final_ln = None
    for i, st in enumerate(s["stages"]):
        res, ws, heads = cfg.stage_res(i), cfg.window(i), cfg.num_heads[i]
        sqs = qs["stages"][i]
        nblk = len(st["blocks"])
        last_stage = i == len(s["stages"]) - 1
        h_ln = None
        for j, sb in enumerate(st["blocks"]):
            bq = sqs["blocks"][j]
            aq = bq["attn"]
            shift = cfg.shift(i, j)
            bs, l, c = xc.shape
            hd = c // heads
            shortcut = xc
            h = act(_iln(xc, s_prev, sb["norm1"], bq["qact1"]["scale"])) if h_ln is None else h_ln
            s1q = aq["qact1"]["scale"]
            hw = window_partition(roll(h.reshape(bs, res, res, c), -shift), ws)
            hw = act(io.requant_mm(hw.reshape(-1, c), sb["qkv"]["w_q"], bq["qact1"]["scale"] * sb["qkv"]["sw"] / s1q,
                                   sb["qkv_b"] / s1q)).reshape(-1, ws * ws, 3 * c)
            hw = act(_windows(hw, sb["bias_val"], sb["mask_s2"], heads, (res // ws) ** 2,
                              s1q ** 2 * hd ** -0.5 / aq["qact_attn1"]["scale"], aq["qact_attn1"]["scale"],
                              aq["qact2"]["scale"], s1q / aq["qact3"]["scale"]))
            hw = act(io.requant_mm(hw.reshape(-1, c), sb["proj"]["w_q"],
                                   aq["qact3"]["scale"] * sb["proj"]["sw"] / aq["qact4"]["scale"],
                                   sb["proj_b"] / aq["qact4"]["scale"]))
            h = roll(window_reverse(hw.reshape(-1, ws * ws, c), ws, res, res), shift)
            xc, h = io.res_ln(shortcut.reshape(-1, c), s_prev, h.reshape(-1, c).contiguous(), aq["qact4"]["scale"],
                              bq["qact2"]["scale"], sb["norm2"]["w"], sb["norm2"]["b"], bq["qact3"]["scale"], 1.0)
            xc, h = act(xc), act(h)
            h = act(io.requant_mm(h, sb["fc1"]["w_q"], bq["qact3"]["scale"] * sb["fc1"]["sw"], sb["fc1_b"],
                                  out_inv=1.0 / bq["mlp_qact1"]["scale"], gelu=True))
            fc2 = sb["fc2"]
            r_fc2 = bq["mlp_qact1"]["scale"] * fc2["sw"] / bq["mlp_qact2"]["scale"]
            b_fc2 = sb["fc2_b"] / bq["mlp_qact2"]["scale"]
            if j + 1 < nblk or last_stage:
                if j + 1 < nblk:
                    ln_p, ln_out = st["blocks"][j + 1]["norm1"], sqs["blocks"][j + 1]["qact1"]["scale"]
                else:
                    ln_p, ln_out = s["norm"], qs["qact2"]["scale"]
                xc, h_f = io.mm_res_ln(h, fc2["w_q"], r_fc2, b_fc2, xc.reshape(-1, c), bq["mlp_qact2"]["scale"],
                                       bq["qact2"]["scale"], bq["qact4"]["scale"], ln_p["w"], ln_p["b"], ln_out, 1.0)
                if j + 1 < nblk:
                    h_ln = act(h_f).reshape(bs, l, c)
                else:
                    final_ln = act(h_f).reshape(bs, l, c)
            else:
                h = act(io.requant_mm(h, fc2["w_q"], r_fc2, b_fc2))
                xc = _residual(xc.reshape(-1, c), bq["qact2"]["scale"], h, bq["mlp_qact2"]["scale"],
                               bq["qact4"]["scale"])
                h_ln = None
            xc = act(xc).reshape(bs, l, c)
            s_prev = bq["qact4"]["scale"]
        if "downsample" in st:
            dq = sqs["downsample"]
            red = st["downsample"]["red"]
            xc = act(_iln(merge_patches(xc, res), s_prev, st["downsample"]["norm"], dq["qact1"]["scale"], expand=4))
            c2 = xc.shape[-1]
            xc = act(io.requant_mm(xc.reshape(-1, c2), red["w_q"], dq["qact1"]["scale"] * red["sw"] / dq["qact2"]["scale"],
                                   0.0)).reshape(b, -1, c2 // 2)
            s_prev = dq["qact2"]["scale"]
    c3 = act(torch.clamp(torch.round(final_ln.to(torch.float32).mean(dim=1) * qs["qact2"]["scale"]
                                     / qs["qact3"]["scale"]), *io.I8).to(torch.int8))
    logits = io.requant_mm(c3, s["head"]["w_q"], qs["qact3"]["scale"] * s["head"]["sw"] / qs["act_out"]["scale"],
                           s["head_b"] / qs["act_out"]["scale"])
    return logits.to(torch.float32) * qs["act_out"]["scale"]

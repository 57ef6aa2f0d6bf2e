"""Checkpoint ingestion and the quant-state file (counterpart of
``p2vit_tpu/checkpoints.py``).

Local files only, numpy in and numpy out: the loaders map a timm/DeiT or
Swin torch state dict, or a Google AugReg Flax ``.npz``, onto the params
tree of the JAX package's layout with numpy leaves, and
``interop.params_from_numpy`` moves that tree to the device. There are no
downloads: ``load_pretrained`` looks in an explicit path and the torch-hub
cache directory, and names the file it expected when it finds none.

The quantization state is an artifact of its own: ``save_quant_state``
writes a ``CalibResult`` or ``SwinCalibResult`` to one flat-key ``.npz``
(one array per leaf, keyed by its path in the tree, such as
``qstate/blocks/3/attn/qact1/scale``; ``flops``, ``global_distance`` and
``family`` beside them), which ``load_quant_state`` reads back onto the
device it is asked for. The JAX package's file holds a pickled jax treedef
instead, which cannot be read without jax.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from .models.common import ViTConfig, target_device

# ---------------------------------------------------------------------------
# Checkpoint-shape adaptation
# ---------------------------------------------------------------------------


def _cubic_kernel(x: np.ndarray) -> np.ndarray:
    """Cubic convolution kernel with A=-0.75, the one torch's
    F.interpolate(mode='bicubic') uses (not Keys' a=-0.5)."""
    A = -0.75
    x = np.abs(x)
    return np.where(
        x <= 1.0,
        ((A + 2.0) * x - (A + 3.0)) * x * x + 1.0,
        np.where(x < 2.0, ((A * x - 5.0 * A) * x + 8.0 * A) * x - 4.0 * A, 0.0),
    )


def _bicubic_matrix(dst: int, src: int) -> np.ndarray:
    """(dst, src) resampling matrix matching torch bicubic with
    align_corners=False: half-pixel centers, 4 taps around floor(center),
    border-clamped tap indices, no weight renormalization."""
    scale = src / dst
    centers = (np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5
    i0 = np.floor(centers).astype(np.int64)
    frac = centers - i0
    mat = np.zeros((dst, src), dtype=np.float64)
    for t in range(-1, 3):
        w = _cubic_kernel(frac - t)  # distance from center to tap i0+t
        idx = np.clip(i0 + t, 0, src - 1)
        np.add.at(mat, (np.arange(dst), idx), w)
    return mat


def resize_pos_embed(posemb: np.ndarray, gs_new, num_tokens: int = 1) -> np.ndarray:
    """Bicubically resample a (1, ntok_old, C) position embedding onto a new
    grid (torch F.interpolate bicubic, align_corners=False), keeping the
    first ``num_tokens`` special tokens (cls) untouched."""
    posemb = np.asarray(posemb, dtype=np.float32)
    gs_new = (int(gs_new[0]), int(gs_new[1])) if not isinstance(gs_new, int) \
        else (int(gs_new), int(gs_new))
    tok, grid = posemb[:, :num_tokens], posemb[0, num_tokens:]
    gs_old = int(round(math.sqrt(grid.shape[0])))
    if gs_old * gs_old != grid.shape[0]:
        raise ValueError(f"pos_embed grid of {grid.shape[0]} tokens is not square")
    c = grid.shape[-1]
    grid = grid.reshape(gs_old, gs_old, c).astype(np.float64)
    wy = _bicubic_matrix(gs_new[0], gs_old)
    wx = _bicubic_matrix(gs_new[1], gs_old)
    out = np.einsum("yi,ijc->yjc", wy, grid)
    out = np.einsum("xj,yjc->yxc", wx, out)
    out = out.reshape(1, gs_new[0] * gs_new[1], c).astype(np.float32)
    return np.concatenate([tok, out], axis=1)


def adapt_input_conv(in_chans: int, conv_weight: np.ndarray) -> np.ndarray:
    """Adapt a pretrained (O, I, kh, kw) patch-conv kernel to ``in_chans``
    input channels: grayscale sums the RGB taps (exact for gray inputs, the
    conv being linear); other counts tile the RGB kernel and rescale by
    3/in_chans to keep the response's magnitude."""
    conv_weight = np.asarray(conv_weight, dtype=np.float32)
    o, i, kh, kw = conv_weight.shape
    if in_chans == i:
        return conv_weight
    if in_chans == 1:
        if i > 3:
            if i % 3 != 0:
                raise ValueError(f"cannot reduce {i}-channel kernel to grayscale")
            conv_weight = conv_weight.reshape(o, i // 3, 3, kh, kw).sum(axis=2)
        else:
            conv_weight = conv_weight.sum(axis=1, keepdims=True)
    else:
        if i != 3:
            raise NotImplementedError(
                f"no conversion from {i}-channel kernel to in_chans={in_chans}"
            )
        repeat = int(math.ceil(in_chans / 3))
        conv_weight = np.tile(conv_weight, (1, repeat, 1, 1))[:, :in_chans]
        conv_weight = conv_weight * (3.0 / float(in_chans))
    return conv_weight


def _fit_vit_inputs(conv_oihw: np.ndarray, pos: np.ndarray, cfg: ViTConfig):
    """Both ViT loaders' shape adaptation: the patch conv to cfg.in_chans
    and the position embedding to cfg's grid."""
    conv_oihw = adapt_input_conv(cfg.in_chans, conv_oihw)
    pos = np.asarray(pos)
    if pos.shape[1] != cfg.seq_len:
        pos = resize_pos_embed(pos, (cfg.grid, cfg.grid), num_tokens=1)
    return conv_oihw, pos


# torch-hub file names of the 8 zoo entries
HUB_FILES = {
    "deit_tiny_patch16_224": "deit_tiny_patch16_224-a1311bcf.pth",
    "deit_small_patch16_224": "deit_small_patch16_224-cd65a155.pth",
    "deit_base_patch16_224": "deit_base_patch16_224-b5f2ef4d.pth",
    "vit_base_patch16_224": "B_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0--imagenet2012-steps_20k-lr_0.01-res_224.npz",
    "vit_large_patch16_224": "L_16-i21k-300ep-lr_0.001-aug_medium1-wd_0.1-do_0.0-sd_0.0--imagenet2012-steps_20k-lr_0.01-res_224.npz",
    "swin_tiny_patch4_window7_224": "swin_tiny_patch4_window7_224.pth",
    "swin_small_patch4_window7_224": "swin_small_patch4_window7_224.pth",
    "swin_base_patch4_window7_224": "swin_base_patch4_window7_224.pth",
}


def _leaf(a) -> np.ndarray:
    """A checkpoint array as a params leaf: float64 narrows to float32, as
    the JAX package's arrays do (64-bit types off)."""
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == np.float64 else a


def _torch_load_state_dict(path: str) -> dict:
    """A torch .pth checkpoint as a dict of numpy arrays (tensors only,
    ``weights_only``); a ``{"model": ...}`` wrapper (the facebook DeiT
    layout) is unwrapped."""
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]
    return {k: np.asarray(v.detach().numpy()) for k, v in obj.items()}


def from_torch_state_dict(sd: dict, cfg: ViTConfig) -> dict:
    """Map a timm/DeiT-style ViT state dict (patch_embed.proj, cls_token,
    pos_embed, blocks.N.{norm1, attn.qkv, attn.proj, norm2, mlp.fc1,
    mlp.fc2}, norm, head) onto the params tree."""

    def g(k):
        return _leaf(sd[k])

    conv, pos = _fit_vit_inputs(
        np.asarray(sd["patch_embed.proj.weight"]), np.asarray(sd["pos_embed"]), cfg,
    )
    params = {
        "cls_token": g("cls_token"),
        "pos_embed": _leaf(pos),
        "patch_embed": {
            # (C, in, p, p) conv kernel folds to (C, in·p·p), K ordered
            # c·p·p + i·p + j as extract_patches produces
            "w": _leaf(conv.reshape(cfg.embed_dim, -1)),
            "b": g("patch_embed.proj.bias"),
        },
        "blocks": [],
        "norm": {"w": g("norm.weight"), "b": g("norm.bias")},
        "head": {"w": g("head.weight"), "b": g("head.bias")},
    }
    for i in range(cfg.depth):
        p = f"blocks.{i}."
        params["blocks"].append(
            {
                "norm1": {"w": g(p + "norm1.weight"), "b": g(p + "norm1.bias")},
                "qkv": {"w": g(p + "attn.qkv.weight"), "b": g(p + "attn.qkv.bias")},
                "proj": {"w": g(p + "attn.proj.weight"), "b": g(p + "attn.proj.bias")},
                "norm2": {"w": g(p + "norm2.weight"), "b": g(p + "norm2.bias")},
                "fc1": {"w": g(p + "mlp.fc1.weight"), "b": g(p + "mlp.fc1.bias")},
                "fc2": {"w": g(p + "mlp.fc2.weight"), "b": g(p + "mlp.fc2.bias")},
            }
        )
    return params


def from_augreg_npz(npz, cfg: ViTConfig) -> dict:
    """Map a Google AugReg Flax .npz ViT checkpoint onto the params tree:
    the conv kernel HWIO → OI(hw), the per-block q/k/v kernels concatenated
    into the fused qkv, Flax (in, out) dense kernels transposed to (out, in)."""
    c = cfg.embed_dim

    def g(k):
        return np.asarray(npz[k])

    def dense(k):  # Flax (in, out) -> (out, in)
        return _leaf(g(k + "/kernel").T), _leaf(g(k + "/bias"))

    kern = g("embedding/kernel")  # (p, p, 3, C)
    conv, pos = _fit_vit_inputs(
        kern.transpose(3, 2, 0, 1), g("Transformer/posembed_input/pos_embedding"), cfg,
    )
    params = {
        "cls_token": _leaf(g("cls")),
        "pos_embed": _leaf(pos),
        "patch_embed": {"w": _leaf(conv.reshape(c, -1)), "b": _leaf(g("embedding/bias"))},
        "blocks": [],
        "norm": {
            "w": _leaf(g("Transformer/encoder_norm/scale")),
            "b": _leaf(g("Transformer/encoder_norm/bias")),
        },
        "head": {"w": _leaf(g("head/kernel").T), "b": _leaf(g("head/bias"))},
    }
    for i in range(cfg.depth):
        b = f"Transformer/encoderblock_{i}/"
        att = b + "MultiHeadDotProductAttention_1/"
        qkv_w = np.concatenate(
            [_leaf(g(att + f"{n}/kernel").reshape(c, c).T) for n in ("query", "key", "value")],
            axis=0,
        )  # (3C, C)
        qkv_b = np.concatenate(
            [_leaf(g(att + f"{n}/bias").reshape(c)) for n in ("query", "key", "value")]
        )
        fc1_w, fc1_b = dense(b + "MlpBlock_3/Dense_0")
        fc2_w, fc2_b = dense(b + "MlpBlock_3/Dense_1")
        params["blocks"].append(
            {
                "norm1": {"w": _leaf(g(b + "LayerNorm_0/scale")), "b": _leaf(g(b + "LayerNorm_0/bias"))},
                "qkv": {"w": qkv_w, "b": qkv_b},
                "proj": {"w": _leaf(g(att + "out/kernel").reshape(c, c).T),
                         "b": _leaf(g(att + "out/bias"))},
                "norm2": {"w": _leaf(g(b + "LayerNorm_2/scale")), "b": _leaf(g(b + "LayerNorm_2/bias"))},
                "fc1": {"w": fc1_w, "b": fc1_b},
                "fc2": {"w": fc2_w, "b": fc2_b},
            }
        )
    return params


def from_torch_state_dict_swin(sd: dict, cfg) -> dict:
    """Map the official Swin state dict (microsoft/Swin-Transformer layout)
    onto the Swin params tree. The ``attn_mask`` and
    ``relative_position_index`` buffers are not loaded: they are functions
    of the geometry, recomputed where needed."""

    def g(k):
        return _leaf(sd[k])

    params = {
        "patch_embed": {
            "w": g("patch_embed.proj.weight").reshape(cfg.embed_dim, -1),
            "b": g("patch_embed.proj.bias"),
        },
        "patch_norm": {"w": g("patch_embed.norm.weight"), "b": g("patch_embed.norm.bias")},
        "stages": [],
        "norm": {"w": g("norm.weight"), "b": g("norm.bias")},
        "head": {"w": g("head.weight"), "b": g("head.bias")},
    }
    for i, depth in enumerate(cfg.depths):
        blocks = []
        for j in range(depth):
            p = f"layers.{i}.blocks.{j}."
            blocks.append(
                {
                    "norm1": {"w": g(p + "norm1.weight"), "b": g(p + "norm1.bias")},
                    "qkv": {"w": g(p + "attn.qkv.weight"), "b": g(p + "attn.qkv.bias")},
                    "proj": {"w": g(p + "attn.proj.weight"), "b": g(p + "attn.proj.bias")},
                    "bias_table": g(p + "attn.relative_position_bias_table"),
                    "norm2": {"w": g(p + "norm2.weight"), "b": g(p + "norm2.bias")},
                    "fc1": {"w": g(p + "mlp.fc1.weight"), "b": g(p + "mlp.fc1.bias")},
                    "fc2": {"w": g(p + "mlp.fc2.weight"), "b": g(p + "mlp.fc2.bias")},
                }
            )
        stage = {"blocks": blocks}
        if i < cfg.num_layers - 1:
            d = f"layers.{i}.downsample."
            stage["downsample"] = {
                "norm": {"w": g(d + "norm.weight"), "b": g(d + "norm.bias")},
                "reduction": {"w": g(d + "reduction.weight"), "b": None},
            }
        params["stages"].append(stage)
    return params


def load_pretrained(model_name: str, cfg, path: str | None = None) -> dict:
    """Load a zoo model's pretrained weights from a local file, as a params
    tree of numpy leaves.

    Looks in (1) an explicit ``path``, (2) $TORCH_HOME/hub/checkpoints,
    (3) ~/.cache/torch/hub/checkpoints. Raises FileNotFoundError naming
    the expected file when none exists (nothing is downloaded).
    """
    fname = HUB_FILES.get(model_name)
    candidates = [path] if path else []
    if fname:
        hub = os.environ.get("TORCH_HOME", os.path.expanduser("~/.cache/torch"))
        candidates += [os.path.join(hub, "hub", "checkpoints", fname)]
    for cand in candidates:
        if cand and os.path.exists(cand):
            if cand.endswith(".npz"):
                with np.load(cand) as npz:
                    return from_augreg_npz(npz, cfg)
            sd = _torch_load_state_dict(cand)
            if model_name.startswith("swin") or "layers.0.blocks.0.norm1.weight" in sd:
                return from_torch_state_dict_swin(sd, cfg)
            return from_torch_state_dict(sd, cfg)
    raise FileNotFoundError(
        f"no local checkpoint for {model_name}; expected {fname!r} under "
        "$TORCH_HOME/hub/checkpoints or pass an explicit path"
    )


# ---------------------------------------------------------------------------
# QuantState serialization
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str, out: dict) -> None:
    if isinstance(tree, dict):
        for k, v in tree.items():
            if "/" in str(k) or str(k).isdigit():
                raise ValueError(f"quant-state key {k!r} cannot be stored flat")
            _flatten(v, f"{prefix}/{k}", out)
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            _flatten(v, f"{prefix}/{i}", out)
    else:
        out[prefix] = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)


def _unflatten(flat: dict, device):
    """Nested dicts from path keys; a node whose keys are all digits is a
    list in index order."""
    root: dict = {}
    for key, a in flat.items():
        node = root
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = torch.from_numpy(np.array(a, copy=True)).to(device)

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def save_quant_state(path: str, calib) -> None:
    """Write a ``CalibResult`` (ViT) or ``SwinCalibResult`` to one flat-key
    ``.npz``: every qstate leaf under ``qstate/<path>``, the mixed-precision
    artifacts ``flops`` and ``global_distance``, and ``family``."""
    from .models.swin import SwinCalibResult

    flat: dict = {}
    _flatten(calib.qstate, "qstate", flat)
    flat["flops"] = np.asarray(calib.flops, dtype=np.int64)
    flat["global_distance"] = calib.global_distance.detach().cpu().numpy()
    flat["family"] = np.asarray("swin" if isinstance(calib, SwinCalibResult) else "vit")
    np.savez(path, **flat)


def load_quant_state(path: str, device="cuda"):
    """Inverse of ``save_quant_state``: a ``CalibResult`` or
    ``SwinCalibResult`` (by the file's ``family``) with its tensors on
    ``device`` (the card unless the caller asks for the CPU)."""
    from .models.swin import SwinCalibResult
    from .models.vit import CalibResult

    dev = target_device(device)
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    family = str(flat.pop("family"))
    flops = [int(f) for f in flat.pop("flops")]
    dist = torch.from_numpy(np.array(flat.pop("global_distance"), copy=True)).to(dev)
    qstate = _unflatten({k[len("qstate/"):]: v for k, v in flat.items() if k.startswith("qstate/")}, dev)
    if family == "swin":
        return SwinCalibResult(qstate=qstate, global_distance=dist, flops=flops)
    if family != "vit":
        raise ValueError(f"{path}: unknown quant-state family {family!r}")
    return CalibResult(qstate=qstate, flops=flops, global_distance=dist)

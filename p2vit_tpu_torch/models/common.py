"""Shared model primitives (counterpart of ``p2vit_tpu/models/common.py``).

Layouts are the JAX package's: linear weights (out, in) with y = x @ Wᵀ + b,
the patch conv as a (embed_dim, C·p·p) matmul with K index c·p·p + i·p + j,
images NCHW, activations channel-last (B, N, C).
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ViTConfig:
    """Static architecture description (one per model-zoo entry)."""

    img_size: int = 224
    patch_size: int = 16
    in_chans: int = 3
    num_classes: int = 1000
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    ln_eps: float = 1e-6

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.num_heads

    @property
    def attn_scale(self) -> float:
        return self.head_dim ** -0.5

    @property
    def grid(self) -> int:
        return self.img_size // self.patch_size

    @property
    def num_patches(self) -> int:
        return self.grid * self.grid

    @property
    def seq_len(self) -> int:
        return self.num_patches + 1  # + cls token

    @property
    def hidden_dim(self) -> int:
        return int(self.embed_dim * self.mlp_ratio)

    @property
    def num_matmuls(self) -> int:
        """Length of the bit_config vector: patch + 4·depth + head."""
        return 2 + 4 * self.depth


def extract_patches(x: torch.Tensor, patch: int) -> torch.Tensor:
    """(B, C, H, W) → (B, N, C·p·p), K ordered c·p·p + i·p + j (a torch Conv2d
    weight (O, C, p, p) folded to (O, C·p·p))."""
    b, c, h, w = x.shape
    g_h, g_w = h // patch, w // patch
    x = x.reshape(b, c, g_h, patch, g_w, patch)
    x = x.permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, g_h * g_w, c * patch * patch)


def layer_norm(x, weight, bias, eps: float):
    """fp LayerNorm over the last axis, in the dtype of ``x``."""
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * weight + bias


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU, torch nn.GELU's default."""
    return torch.nn.functional.gelu(x, approximate="none")


def linear(x, w, b=None):
    """y = x @ Wᵀ + b with the (out, in) weight layout."""
    y = x @ w.T
    if b is not None:
        y = y + b
    return y


def split_qkv(x: torch.Tensor, num_heads: int):
    """(B, N, 3C) → (q, k, v), each (B, heads, N, head_dim)."""
    b, n, three_c = x.shape
    c = three_c // 3
    qkv = x.reshape(b, n, 3, num_heads, c // num_heads).permute(2, 0, 3, 1, 4)
    return qkv[0], qkv[1], qkv[2]


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """(B, heads, N, head_dim) → (B, N, C)."""
    b, h, n, d = x.shape
    return x.permute(0, 2, 1, 3).reshape(b, n, h * d)


def target_device(device) -> torch.device:
    """``device`` as a ``torch.device``. The entry points default to the card
    ("cuda"); without a CUDA device that default raises instead of running
    on the CPU, which callers ask for with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA device and none is available; "
                           f"pass device='cpu' to build on the CPU")
    return dev


def trunc_normal(gen: torch.Generator, shape, std=0.02, device=None):
    """Truncated normal (±2σ) from a ``torch.Generator``."""
    t = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(t, std=1.0, a=-2.0, b=2.0, generator=gen)
    return t * std


def to_2tuple(v):
    """Scalar → (v, v); tuples and lists pass through as tuples (the
    reference's timm-lineage helper)."""
    return tuple(v) if isinstance(v, (tuple, list)) else (v, v)


def drop_path(x: torch.Tensor, rate: float, training: bool = False,
              generator: torch.Generator | None = None) -> torch.Tensor:
    """Stochastic depth (the reference's DropPath): identity when not
    training or at rate 0, the only case PTQ and serving run; else each
    sample is kept with probability 1 − rate, drawn from ``generator``
    (on the CPU, so the draw is the same on any device), and scaled by
    1/(1 − rate), or zeroed."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = torch.rand((x.shape[0],), generator=generator) < keep
    mask = mask.to(x.device).reshape((x.shape[0],) + (1,) * (x.ndim - 1))
    return torch.where(mask, x / keep, torch.zeros_like(x))


def hybrid_embed(backbone_fn, x: torch.Tensor, proj_w: torch.Tensor, proj_b=None) -> torch.Tensor:
    """A CNN backbone's patch embedding (the reference's HybridEmbed):
    ``backbone_fn(x)``'s feature map (B, C_feat, H', W') flattened to
    (B, H'·W', C_feat) tokens, or its (B, N, C_feat) tokens as they are,
    then the 1×1-conv projection, a per-token linear. No zoo model uses it;
    ``backbone_fn`` is any callable, as in the JAX package."""
    feat = backbone_fn(x)
    if feat.ndim == 4:
        b, c, h, w = feat.shape
        feat = feat.reshape(b, c, h * w).transpose(1, 2)
    return linear(feat, proj_w, proj_b)


def vit_flops(cfg: ViTConfig) -> list:
    """Multiply count per bit_config slot: patch-embed, per block
    [qkv, proj, fc1, fc2], then head."""
    c, n, h = cfg.embed_dim, cfg.seq_len, cfg.hidden_dim
    flops = [cfg.in_chans * cfg.patch_size**2 * c * cfg.grid * cfg.grid]
    for _ in range(cfg.depth):
        flops += [n * c * 3 * c, n * c * c, n * c * h, n * h * c]
    flops.append(c * cfg.num_classes)
    return flops

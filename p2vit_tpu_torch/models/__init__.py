"""Model zoo (counterpart of ``p2vit_tpu/models/__init__.py``): the ViT/DeiT
and Swin constructors, ``MODEL_ZOO`` over both, and each family's
preprocessing (``PREPROCESS``)."""

from __future__ import annotations

from . import swin, vit
from .common import ViTConfig, vit_flops
from .swin import SwinConfig

VIT_ZOO = {
    "deit_tiny_patch16_224": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "deit_base_patch16_224": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch16_224": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16_224": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
}

SWIN_ZOO = {
    "swin_tiny_patch4_window7_224": SwinConfig(embed_dim=96, depths=(2, 2, 6, 2), num_heads=(3, 6, 12, 24)),
    "swin_small_patch4_window7_224": SwinConfig(embed_dim=96, depths=(2, 2, 18, 2), num_heads=(3, 6, 12, 24)),
    "swin_base_patch4_window7_224": SwinConfig(embed_dim=128, depths=(2, 2, 18, 2), num_heads=(4, 8, 16, 32)),
}

MODEL_ZOO = {**VIT_ZOO, **SWIN_ZOO}

# Per-family preprocessing: normalize mean/std and the resize crop_pct
PREPROCESS = {
    "deit": {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225), "crop_pct": 0.875},
    "vit": {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5), "crop_pct": 0.9},
    "swin": {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225), "crop_pct": 0.9},
}

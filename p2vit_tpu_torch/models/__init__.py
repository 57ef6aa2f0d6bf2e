"""ViT/DeiT model zoo (counterpart of ``p2vit_tpu/models/__init__.py``).

Only the ViT/DeiT constructors are ported; Swin comes later (ROADMAP.md).
"""

from __future__ import annotations

from . import vit
from .common import ViTConfig, vit_flops

VIT_ZOO = {
    "deit_tiny_patch16_224": ViTConfig(embed_dim=192, depth=12, num_heads=3),
    "deit_small_patch16_224": ViTConfig(embed_dim=384, depth=12, num_heads=6),
    "deit_base_patch16_224": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vit_base_patch16_224": ViTConfig(embed_dim=768, depth=12, num_heads=12),
    "vit_large_patch16_224": ViTConfig(embed_dim=1024, depth=24, num_heads=16),
}

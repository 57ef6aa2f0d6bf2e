"""Convert the JAX package's pytrees, as numpy leaves, into this package's
tensors.

``params_from_numpy`` takes the JAX parameter dict after ``np.asarray`` on
each leaf; ``qstate_from_numpy`` a ``QuantState`` the same way. Both walk
nested dicts, lists and tuples, so the ViT trees and the Swin trees
(``stages`` → ``blocks``, ``downsample``) convert alike; a ``None`` leaf
(Swin's bias-free reduction) stays ``None``. Layouts stay as in JAX:
weights (out, in), images NCHW, qkv (B, N, 3C). The tensors go to the card
unless the caller passes ``device="cpu"``. This module uses numpy and torch
only, so it works without JAX installed.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.common import target_device


def _tree_to_torch(tree, device):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _tree_to_torch(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_to_torch(v, device) for v in tree)
    return torch.from_numpy(np.array(tree, copy=True)).to(device)


def params_from_numpy(tree, device="cuda") -> dict:
    """JAX ViT or Swin params (numpy leaves) → the port's parameter dict."""
    return _tree_to_torch(tree, target_device(device))


def qstate_from_numpy(tree, device="cuda") -> dict:
    """JAX ViT or Swin ``QuantState`` (numpy leaves) → the port's qstate dict."""
    return _tree_to_torch(tree, target_device(device))

"""``models/common.py``'s helpers ``to_2tuple``, ``drop_path`` and
``hybrid_embed`` against the JAX package's, with the cases of JAX's own
``tests/test_vit_model.py`` (``test_hybrid_embed``,
``test_drop_path_and_to_2tuple``) on the same numpy inputs.

``drop_path`` draws its mask from a ``torch.Generator`` where JAX draws from
a PRNG key, so the two keep different samples: the cases compare the
identity arms bit for bit, and for the training arm each sample's scaling
(kept × 1/keep, or zeroed) and the draw's reproducibility from one seed.
``hybrid_embed`` on a 4-D and a 3-D backbone output: tolerance 1e-6, as
JAX's test states it against its manual token projection.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.models.common import drop_path as j_drop_path
from p2vit_tpu.models.common import hybrid_embed as j_hybrid_embed
from p2vit_tpu.models.common import to_2tuple as j_to_2tuple
from p2vit_tpu_torch.models.common import drop_path, hybrid_embed, to_2tuple


@pytest.mark.parametrize("v", [7, (2, 3), [4, 5], 0.5])
def test_to_2tuple_vs_jax(v):
    assert to_2tuple(v) == j_to_2tuple(v)
    assert isinstance(to_2tuple(v), tuple)


def _backbone4d(img):
    """JAX's stand-in CNN: a 4×4 average pool and a channel lift to 8."""
    pooled = img.reshape(2, 3, 8, 4, 8, 4).mean((3, 5))
    cat = torch.cat if isinstance(img, torch.Tensor) else jnp.concatenate
    return cat([pooled, pooled, pooled[:, :2]], 1)


def test_hybrid_embed_vs_jax():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 3, 32, 32).astype(np.float32)
    w = (rng.randn(16, 8) * 0.1).astype(np.float32)
    b = np.zeros(16, np.float32)
    out = hybrid_embed(_backbone4d, torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b))
    assert out.shape == (2, 64, 16)
    feat = _backbone4d(torch.from_numpy(x))
    manual = feat.reshape(2, 8, 64).transpose(1, 2) @ torch.from_numpy(w).T + torch.from_numpy(b)
    assert torch.allclose(out, manual, atol=1e-6)
    j = np.asarray(j_hybrid_embed(_backbone4d, jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
    np.testing.assert_allclose(out.numpy(), j, rtol=0, atol=1e-6)
    # a token-shaped backbone output passes through to the projection
    out3d = hybrid_embed(lambda img: torch.ones((2, 5, 8)), torch.from_numpy(x), torch.from_numpy(w),
                         torch.from_numpy(b))
    j3d = np.asarray(j_hybrid_embed(lambda img: jnp.ones((2, 5, 8)), jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(b)))
    assert out3d.shape == (2, 5, 16)
    np.testing.assert_allclose(out3d.numpy(), j3d, rtol=0, atol=1e-6)
    # no bias: the projection alone
    assert torch.equal(hybrid_embed(lambda img: torch.ones((2, 5, 8)), torch.from_numpy(x), torch.from_numpy(w)),
                       torch.ones((2, 5, 8)) @ torch.from_numpy(w).T)


@pytest.mark.parametrize("rate,training", [(0.0, True), (0.5, False), (0.0, False)])
def test_drop_path_identity_vs_jax(rate, training):
    """Eval, or rate 0: the identity, bit for bit, as JAX's."""
    x = np.random.RandomState(1).randn(8, 4, 4).astype(np.float32)
    t = drop_path(torch.from_numpy(x), rate, training, generator=torch.Generator().manual_seed(0))
    j = np.asarray(j_drop_path(jax.random.PRNGKey(0), jnp.asarray(x), rate, training))
    np.testing.assert_array_equal(t.numpy(), j)
    np.testing.assert_array_equal(t.numpy(), x)


@pytest.mark.parametrize("rate", [0.5, 0.25])
def test_drop_path_scaling_vs_jax(rate):
    """Training: every sample is zeroed or scaled by 1/keep, exactly as in
    JAX's output (ones → {0, 1/keep}); one seed draws one mask, on any
    device of x."""
    keep = 1.0 - rate
    x = torch.ones((64, 4, 4))
    y = drop_path(x, rate, True, generator=torch.Generator().manual_seed(1))
    j = np.asarray(j_drop_path(jax.random.PRNGKey(1), jnp.ones((64, 4, 4)), rate, True))
    for out in (y.numpy().reshape(64, -1), j.reshape(64, -1)):
        assert all(set(np.unique(r)) in ({0.0}, {np.float32(1.0 / keep)}) for r in out)
    kept = (y.reshape(64, -1)[:, 0] != 0).sum().item()
    assert 0 < kept < 64
    assert torch.equal(y, drop_path(x, rate, True, generator=torch.Generator().manual_seed(1)))
    xr = torch.from_numpy(np.random.RandomState(2).randn(64, 3).astype(np.float32))
    yr = drop_path(xr, rate, True, generator=torch.Generator().manual_seed(3))
    on = yr[:, 0] != 0
    assert torch.equal(yr[on], xr[on] / keep) and not yr[~on].any()

"""Swin windowed attention at head_dims below 32 (TINY Swin's 8 and 16).

The kernels take head_dim 32; ``swin_lis_attention`` and
``swin_lis_attention_folded`` zero-pad each head's q, k and v columns to 32
on the card (``swin_pad_heads``) and keep each head's first d output columns
(``swin_unpad_heads``). On the CPU:
* the plain versions equal the JAX kernel (``interpret=True``) bit for bit
  at d = 8 and 16, LIS on and off, with and without the shift mask;
* the padding argument itself: the plain version on the padded codes,
  unpadded, equals the plain version on the codes, at every d that divides
  32, both entries, LIS on and off.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, as the other parity tests)
import numpy as np
import pytest
import torch

from p2vit_tpu.models import swin
from p2vit_tpu.ops.attention_lis import swin_lis_attention as j_swin_attn
from p2vit_tpu.ops.attention_lis import swin_lis_attention_folded as j_folded
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.ops import attention_lis


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


def _inputs(seed, b, res, ws, heads, d, masked):
    """Raster qkv codes (B, res, res, 3·H·d), bias, the shift mask over s2
    (or None) and the node scales serving forms (rq carries d^-0.5)."""
    rng = np.random.RandomState(seed)
    n, c = ws * ws, heads * d
    qkv = rng.randint(-128, 128, (b, res, res, 3 * c)).astype(np.int8)
    bias = (rng.randn(heads, n, n) * 0.3).astype(np.float32)
    s2 = np.float32(2.0**-4)
    mask = (swin.shift_attn_mask(res, res, ws, ws // 2) / s2).astype(np.float32) if masked else None
    s_qkv, s_attn1, s3 = np.float32(2.0**-6), np.float32(2.0**-4), np.float32(2.0**-5)
    rq = s_qkv**2 * np.float32(d**-0.5) / s_attn1
    return qkv, bias, mask, heads, (rq, s_attn1, s2, s_qkv / s3)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("d", [8, 16])
def test_swin_attention_plain_vs_jax_small_head_dims(d, lis, masked):
    """TINY Swin's windows (4×4 on an 8×8 grid, 2 heads): the panel entry's
    plain version against the JAX kernel in interpret mode, 0 flips."""
    qkv, bias, mask, heads, scales = _inputs(d, 2, 8, 4, 2, d, masked)
    panels = np.asarray(swin.window_partition(jnp.asarray(qkv), 4))
    t = attention_lis.swin_lis_attention_plain(T(panels), T(bias), None if mask is None else T(mask),
                                               heads, 4, *scales, lis=lis)
    j = j_swin_attn(panels, bias, mask, heads, 4, *scales, lis=lis, interpret=True)
    assert t.shape == (8, 16, heads * d) and t.dtype == torch.int8
    assert len(np.unique(t.numpy())) > 10
    assert n_diff(j, t) == 0


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("d", [8, 16])
def test_swin_attention_folded_plain_vs_jax_small_head_dims(d, lis):
    """The folded entry at shift ws/2 against JAX's folded kernel (interpret)
    on the rolled grid, rolled back: 0 flips."""
    qkv, bias, mask, heads, scales = _inputs(d + 1, 2, 8, 4, 2, d, True)
    t = attention_lis.swin_lis_attention_folded_plain(T(qkv), T(bias), T(mask), heads, 4, *scales,
                                                      lis=lis, shift=2)
    rolled = np.roll(qkv, (-2, -2), (1, 2))
    j = np.roll(np.asarray(j_folded(rolled, bias, mask, heads, 4, *scales, lis=lis, interpret=True)),
                (2, 2), (1, 2))
    assert t.shape == (2, 8, 8, heads * d)
    assert n_diff(j, t) == 0


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("d", [1, 2, 4, 8, 16, 32])
def test_swin_head_padding_is_exact(d, lis):
    """What the wrappers launch on the card, replayed with the plain
    versions: pad each head to 32, attend, keep each head's first d columns.
    It equals the plain version on the unpadded codes, both entries."""
    heads = 3
    qkv, bias, mask, heads, scales = _inputs(40 + d, 2, 8, 4, heads, d, True)
    tm = T(mask)
    padded = attention_lis.swin_pad_heads(T(qkv), heads, d)
    assert padded.shape[-1] == 3 * heads * 32
    assert torch.equal(padded.reshape(2, 8, 8, 3 * heads, 32)[..., d:],
                       torch.zeros((2, 8, 8, 3 * heads, 32 - d), dtype=torch.int8))
    want = attention_lis.swin_lis_attention_folded_plain(T(qkv), T(bias), tm, heads, 4, *scales,
                                                         lis=lis, shift=2)
    got = attention_lis.swin_lis_attention_folded_plain(padded, T(bias), tm, heads, 4, *scales,
                                                        lis=lis, shift=2)
    assert torch.equal(attention_lis.swin_unpad_heads(got, heads, d), want)
    panels = tswin.window_partition(T(qkv), 4)
    want = attention_lis.swin_lis_attention_plain(panels, T(bias), tm, heads, 4, *scales, lis=lis)
    got = attention_lis.swin_lis_attention_plain(attention_lis.swin_pad_heads(panels, heads, d), T(bias),
                                                 tm, heads, 4, *scales, lis=lis)
    assert torch.equal(attention_lis.swin_unpad_heads(got, heads, d), want)

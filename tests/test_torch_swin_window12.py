"""Swin attention past 64 tokens a window (12×12 windows, N = 144): the
port's plain versions of ``swin_lis_attention`` and
``swin_lis_attention_folded`` against the JAX kernels in interpret mode
(which zero-pad N to 160), and the kernel's plan and shared memory there.
The card holds the kernels against these plain versions (``chip_smoke.py``,
the ``swin`` path's window-12 checks).

Tolerance 0: every comparison counts differing int8 codes and expects none.
"""

import numpy as np
import pytest
import torch

from p2vit_tpu.models import swin
from p2vit_tpu.ops.attention_lis import swin_lis_attention as j_swin_attn
from p2vit_tpu.ops.attention_lis import swin_lis_attention_folded as j_folded
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.ops import attention_lis as al

B, RES, WS, HEADS, C = 2, 24, 12, 2, 64  # 2 images of 2×2 windows of 144 tokens, 2 heads of 32
N = WS * WS
SCALES = (2.0**-9, 2.0**-4, np.float32(2.0**-4), 2.0**-2)  # score_requant, s_attn1, s2, out_requant


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def _inputs(masked, seed=0):
    rng = np.random.RandomState(seed)
    qkv4 = rng.randint(-128, 128, (B, RES, RES, 3 * C)).astype(np.int8)
    bias = (rng.randn(HEADS, N, N) * 0.3).astype(np.float32)
    mask = swin.shift_attn_mask(RES, RES, WS, WS // 2) / SCALES[2] if masked else None
    return qkv4, bias, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lis", [True, False])
def test_window12_folded_plain_vs_jax(lis, masked):
    """The folded plain version at N = 144 against JAX's folded kernel
    (interpret): 0 codes differ; and against window_reverse of the panel
    version on the partitioned windows."""
    qkv4, bias, mask = _inputs(masked)
    tmask = None if mask is None else T(mask)
    t = al.swin_lis_attention_folded_plain(T(qkv4), T(bias), tmask, HEADS, WS, *SCALES, lis=lis)
    j = np.asarray(j_folded(qkv4, bias, mask, HEADS, WS, *SCALES, lis=lis, interpret=True))
    assert t.shape == (B, RES, RES, C) and len(np.unique(t.numpy())) > 20
    assert int((t.numpy() != j).sum()) == 0
    panels = tswin.window_partition(T(qkv4), WS)
    two_step = al.swin_lis_attention_plain(panels, T(bias), tmask, HEADS, (RES // WS) ** 2, *SCALES, lis=lis)
    assert torch.equal(tswin.window_reverse(two_step, WS, RES, RES), t)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lis", [True, False])
def test_window12_panel_plain_vs_jax(lis, masked):
    """The panel plain version at N = 144 against JAX's panel kernel
    (interpret), on the windows of a shifted grid: 0 codes differ."""
    qkv4, bias, mask = _inputs(masked, seed=1)
    panels = tswin.window_partition(T(qkv4), WS)
    nw = (RES // WS) ** 2
    t = al.swin_lis_attention_plain(panels, T(bias), None if mask is None else T(mask), HEADS, nw, *SCALES,
                                    lis=lis)
    j = np.asarray(j_swin_attn(panels.numpy(), bias, mask, HEADS, nw, *SCALES, lis=lis, interpret=True))
    assert t.shape == (B * nw, N, C)
    assert int((t.numpy() != j).sum()) == 0


@pytest.mark.parametrize("lis", [True, False])
def test_window12_plan_fits(lis):
    """N = 144 takes the unstaged instance (NM = 160): its shared memory
    fits, LIS on with two CTAs an SM, LIS off with one; N = 49 keeps the
    staged instance's bytes."""
    assert al.swin_instance_n(49) == 64 and al.swin_instance_n(65) == al.swin_instance_n(144) == 160
    smem = al.swin_attention_smem(N, lis)
    assert smem == (104192 if lis else 155904)
    per_sm = 2 if lis else 1
    assert (al.MAX_SMEM + 1024) // (smem + 1024) >= per_sm
    plan = al.swin_attention_plan(B * 4, 4, HEADS, N, 132, per_sm, lis=lis)
    assert plan.smem_bytes == smem and plan.grid == B * 4 * HEADS
    assert al.swin_attention_smem(49, lis) == (53424 if lis else 71600)  # the staged layout, as before

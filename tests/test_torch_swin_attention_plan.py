"""The Hopper Swin attention kernel's plan and addressing, on the CPU.

``csrc/swin_attention.cu`` runs a persistent grid over (window, head)
items ordered head-major, then window; each CTA takes its items in turn
from a counter in device memory, staging bias[h] when the head changes and
each item's mask with its q/k/v rows. The
folded entry reads and writes raster pixels moved by the block's cyclic
shift, so ``serving_forward(fold_windows=True)`` runs no roll. The kernel
needs the card (``tests/test_torch_cuda_kernels.py``); here: the plan
(``swin_attention_plan``) at every zoo Swin stage, the kernel's item walk
and token addressing replayed in PyTorch against the plain versions, the
shifted folded plain version against the JAX kernel, and the fold path's
logits against the default path's. Every comparison is bit for bit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.models import swin
from p2vit_tpu.ops.attention_lis import swin_lis_attention_folded as j_folded
from p2vit_tpu_torch import serving_swin as tss
from p2vit_tpu_torch.config import make_policy
from p2vit_tpu_torch.models import SWIN_ZOO
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.ops import attention_lis as al

H100_SMS = 132
# the kernel's CTAs per SM at N = 49 on the H100 (swin_attention_info on the
# card): LIS on, and LIS off (its float64 rows and v take more shared memory)
CTAS_PER_SM = {True: 4, False: 3}


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


@pytest.mark.parametrize("batch", [1, 8, 64])
@pytest.mark.parametrize("model", sorted(SWIN_ZOO))
def test_plan_covers_every_window_and_head_once(model, batch):
    """At every stage of the zoo's Swins (windows 64/16/4/1 per image,
    heads 3–32), LIS on and off: the grid fills the card where there are
    items enough and holds no CTA without one, the counter's order takes
    every (window, head) once, head-major, and shared memory fits the CTAs
    per SM the plan assumes; a CTA's items rise through the heads, so it
    stages each head's bias once at most."""
    cfg = SWIN_ZOO[model]
    for i, heads in enumerate(cfg.num_heads):
        res, ws = cfg.stage_res(i), cfg.window(i)
        nw, n = (res // ws) ** 2, ws * ws
        for lis in (True, False):
            plan = al.swin_attention_plan(batch * nw, nw, heads, n, H100_SMS, CTAS_PER_SM[lis], lis=lis)
            items = batch * nw * heads
            assert plan.items == items and plan.grid == min(items, H100_SMS * CTAS_PER_SM[lis])
            assert plan.smem_bytes == al.swin_attention_smem(n, lis) <= al.MAX_SMEM
            assert (al.MAX_SMEM + 1024) // (plan.smem_bytes + 1024) >= CTAS_PER_SM[lis]
            seen = np.zeros((heads, batch * nw), np.int64)
            order = [(h, w) for _, h, w in plan.walk()]
            assert order == sorted(order)
            for h, w in order:
                seen[h, w] += 1
            assert (seen == 1).all()
            ctas = {c for c, _, _ in plan.walk()}
            assert ctas == set(range(plan.grid))
            per_cta = -(-items // plan.grid)
            assert plan.bias_stagings() <= min(heads, per_cta) * plan.grid


def _token_of(fold, geom, win, i):
    """``token_of`` of csrc/swin_attention.cu: the panel row, or the raster
    pixel of row i of window ``win`` moved by the cyclic shift."""
    if not fold:
        return win * geom["n"] + i
    res, ws, shift = geom["res"], geom["ws"], geom["shift"]
    g = res // ws
    b, wy, wx = win // (g * g), (win % (g * g)) // g, win % g
    y, x = (wy * ws + i // ws + shift) % res, (wx * ws + i % ws + shift) % res
    return (b * res + y) * res + x


def _replay(plan, fold, geom, qkv_tok, bias, mask, scales, lis):
    """The kernel's walk in PyTorch: per item of each CTA's run, its head's
    q/k/v rows gathered by token index, bias[h] and mask[p] of the item,
    one window through the plain attention, the output scattered back by
    the same token indices. Returns the (tokens, C) codes and how often
    each (token, head) was written."""
    n, heads, d = geom["n"], plan.heads, al.SWIN_HEAD_DIM
    c = heads * d
    out = torch.zeros((qkv_tok.shape[0], c), dtype=torch.int8)
    writes = torch.zeros((qkv_tok.shape[0], heads), dtype=torch.int64)
    for _, h, win in plan.walk():
        p = win % plan.n_windows
        tok = torch.tensor([_token_of(fold, geom, win, i) for i in range(n)])
        cols = torch.cat([torch.arange(j * c + h * d, j * c + (h + 1) * d) for j in range(3)])
        rows = qkv_tok[tok][:, cols].reshape(1, n, 3 * d)
        m = None if mask is None else mask[p:p + 1]
        o = al._swin_windows_plain(rows, bias[h:h + 1], m, 1, 1, *scales, 4, lis)
        out[tok, h * d:(h + 1) * d] = o[0]
        writes[tok, h] += 1
    return out, writes


def _inputs(seed, b, res, ws, heads, masked, shift):
    rng = np.random.RandomState(seed)
    c, n = 32 * heads, ws * ws
    qkv = T(rng.randint(-128, 128, (b, res, res, 3 * c)).astype(np.int8))
    bias = T((rng.randn(heads, n, n) * 0.3).astype(np.float32))
    s2 = 2.0**-4
    mask = (T((np.asarray(swin.shift_attn_mask(res, res, ws, shift or ws // 2)) / s2).astype(np.float32))
            if masked else None)
    return qkv, bias, mask, (2.0**-9, 2.0**-4, s2, 2.0**-2)


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("fold,shift,masked,grid", [
    (False, 0, True, 0), (False, 0, False, 0), (True, 0, False, 5), (True, 3, True, 0), (True, 3, True, 3),
])
def test_walk_replay_equals_plain(fold, shift, masked, grid, lis):
    """Two images of a 14×14 grid of 7×7 windows, two heads: the kernel's
    item order, mask index and token addressing (panels; the raster grid at
    shift 0 and 3), on the plan's grid and on forced grids of 5 and 3 CTAs
    (each CTA's items across heads and window positions), equal the plain
    version, each (token, head) written once."""
    b, res, ws, heads = 2, 14, 7, 2
    qkv, bias, mask, scales = _inputs(7 + shift, b, res, ws, heads, masked, shift)
    n, g2 = ws * ws, (res // ws) ** 2
    geom = dict(n=n, res=res, ws=ws, shift=shift)
    plan = al.swin_attention_plan(b * g2, g2 if masked or fold else 1, heads, n, H100_SMS, CTAS_PER_SM[lis],
                                  grid, lis)
    if fold:
        want = al.swin_lis_attention_folded_plain(qkv, bias, mask, heads, ws, *scales, lis=lis, shift=shift)
        qkv_tok = qkv.reshape(-1, qkv.shape[-1])
    else:
        panels = tswin.window_partition(qkv, ws).contiguous()
        want = al.swin_lis_attention_plain(panels, bias, mask, heads, g2, *scales, lis=lis)
        qkv_tok = panels.reshape(-1, panels.shape[-1])
    assert plan.grid == (grid or plan.items)
    got, writes = _replay(plan, fold, geom, qkv_tok, bias, mask, scales, lis)
    assert (writes == 1).all()
    assert torch.equal(got, want.reshape(got.shape))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("shift", [0, 3])
def test_shifted_folded_plain_vs_jax(shift, lis, masked):
    """The folded plain version with the cyclic shift against JAX's
    ``swin_lis_attention_folded`` (interpret mode) on the grid rolled by
    −shift, its output rolled back by +shift: 0 flips, LIS on and off, the
    shift mask of Swin-T's 7×7 windows or none."""
    qkv, bias, mask, scales = _inputs(11 + shift, 2, 14, 7, 2, masked, 3)
    t = al.swin_lis_attention_folded_plain(qkv, bias, mask, 2, 7, *scales, lis=lis, shift=shift)
    rolled = np.roll(qkv.numpy(), (-shift, -shift), (1, 2))
    j = j_folded(jnp.asarray(rolled), jnp.asarray(bias.numpy()), None if mask is None else jnp.asarray(mask.numpy()),
                 2, 7, *scales, lis=lis, interpret=True)
    j = np.roll(np.asarray(j), (shift, shift), (1, 2))
    assert len(np.unique(t.numpy())) > 20
    np.testing.assert_array_equal(t.numpy(), j)
    # the wrapper on CPU tensors is the plain version, shift included
    assert torch.equal(al.swin_lis_attention_folded(qkv, bias, mask, 2, 7, *scales, lis=lis, shift=shift), t)


@pytest.mark.parametrize("lis", [True, False])
def test_fold_path_rolls_nothing_and_equals_the_default_path(lis, monkeypatch):
    """A two-stage Swin of 7×7 windows (stage 0: 2×2 windows, shifted second
    block; stage 1 one window): ``fold_windows=True`` equals the default
    path's logits bit for bit, and the forward rolls no map itself (the
    shift goes to ``swin_lis_attention_folded``), where the default path
    rolls twice per shifted block. (On CPU tensors the folded wrapper is its
    plain version, which rolls in PyTorch as the reference.)"""
    cfg = tswin.SwinConfig(img_size=56, patch_size=4, num_classes=10, embed_dim=32, depths=(2, 2),
                           num_heads=(1, 2), window_size=7)
    params = tswin.init_params(5, cfg, device="cpu")
    x = T(np.random.RandomState(13).randn(2, 3, 56, 56).astype(np.float32))
    policy = make_policy(lis=lis)
    tq = tswin.calibrate(params, cfg, policy, x).qstate
    s = tss.convert(params, tq, cfg, policy, 4)
    assert cfg.shift(0, 1) == 3 and cfg.stage_res(1) == cfg.window(1)
    rolls, shifts = [], []
    roll = tss._roll
    monkeypatch.setattr(tss, "_roll", lambda h, k: (rolls.append(k) if k else None) or roll(h, k))
    fold_attn = al.swin_lis_attention_folded
    monkeypatch.setattr(al, "swin_lis_attention_folded",
                        lambda *a, **k: shifts.append(k.get("shift")) or fold_attn(*a, **k))
    fold = tss.serving_forward(s, tq, cfg, policy, x, lis=lis, fold_windows=True)
    assert rolls == [] and shifts == [0, 3]
    base = tss.serving_forward(s, tq, cfg, policy, x, lis=lis)
    assert rolls == [-3, 3]
    assert torch.equal(fold, base) and bool(torch.isfinite(fold).all())
    assert torch.equal(fold, tss.serving_forward(s, tq, cfg, policy, x, lis=lis, fold_windows=True,
                                                 use_kernels=False))


def test_plan_and_wrapper_refuse_what_the_kernel_does_not_take():
    """N > 256 and a forced grid past the items: the plan raises on the first
    and clips the second."""
    with pytest.raises(ValueError, match="N <= 256"):
        al.swin_attention_plan(1, 1, 1, 257)
    assert al.swin_attention_plan(4, 4, 3, 49, grid=100).grid == 12
    one = dataclasses.replace(al.swin_attention_plan(2, 1, 3, 16), grid=1)
    assert list(one.walk()) == [(0, h, w) for h in range(3) for w in range(2)] and one.bias_stagings() == 3

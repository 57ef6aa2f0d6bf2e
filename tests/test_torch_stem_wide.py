"""``fused_swin_stem`` past C = 256: the plan of the clusters that split C
(``stem_plan``: CS = ⌈C/256⌉ CTAs of 16·CC channels each, C ≤ 4096) and
the plain version against the JAX kernel in interpret mode at C = 384 and
512, K = 48.

Tolerances: on a calibrated state's kinds (int8 input codes times a PoT
scale, int4 weight codes times PoT per-channel scales, a PTF s_bn, a PoT
out scale) every partial sum of the dot is exact, so the codes agree bit
for bit (0 differ). On random-normal floats the port sums k in its fixed
order and XLA in its own, so h can move by an ulp at a rounding edge; the
counts of flipped codes at these seeds are stated (C = 384: 0 of
197,760; C = 512: 1 of 263,680), as ``tests/test_torch_swin_flags.py``
states them at C = 96.
"""

import numpy as np
import pytest
import torch

from p2vit_tpu.ops.swin_stem import fused_swin_stem as j_stem
from p2vit_tpu_torch.ops import swin_stem

H100_SMS = 132


def _inputs(m, c, case):
    """(patches, w, bias, s_bn, ln_w, ln_b, out_scale) as numpy float32."""
    rng = np.random.RandomState(c)
    bias = (rng.randn(c) * 0.05).astype(np.float32)
    ln_w, ln_b = rng.randn(c).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32)
    if case == "randn":
        return (rng.randn(m, 48).astype(np.float32), (rng.randn(c, 48) * 0.2).astype(np.float32),
                bias, np.float32(0.04), ln_w, ln_b, np.float32(0.03))
    sw = (2.0 ** rng.randint(-9, -6, c)).astype(np.float32)
    return ((rng.randint(-128, 128, (m, 48)) * 2.0**-5).astype(np.float32),
            (rng.randint(-8, 8, (c, 48)) * sw[:, None]).astype(np.float32), bias,
            (2.0**-3 * 2.0 ** rng.randint(0, 4, c)).astype(np.float32), ln_w, ln_b,
            np.float32(2.0**-4))


@pytest.mark.parametrize("c,case,flips", [(384, "pot", 0), (512, "pot", 0), (384, "randn", 0),
                                          (512, "randn", 1)])
def test_plain_stem_vs_jax_kernel_wide(c, case, flips):
    args = _inputs(515, c, case)
    t = swin_stem.fused_swin_stem_plain(*(torch.from_numpy(np.asarray(a)) for a in args))
    j = np.asarray(j_stem(*args, interpret=True))
    assert t.dtype == torch.int8 and t.shape == (515, c)
    assert len(np.unique(t.numpy())) > 50
    n = int((j.astype(np.int32) != t.numpy().astype(np.int32)).sum())
    assert n == flips


@pytest.mark.parametrize("c,cs,cc,c_pad", [(96, 1, 6, 96), (256, 1, 16, 256), (257, 2, 12, 384), (384, 2, 12, 384),
                                           (512, 2, 16, 512), (520, 3, 12, 576), (768, 3, 16, 768),
                                           (780, 4, 16, 1024), (1024, 4, 16, 1024)])
def test_stem_plan_clusters(c, cs, cc, c_pad):
    """CS = ⌈C/256⌉ CTAs a cluster, each 16·CC channels (CC the least that
    covers C), a persistent grid of whole clusters, the partial-sum buffers'
    2 KB in each CTA's shared memory only where there is a cluster."""
    m = 64 * 3136
    plan = swin_stem.stem_plan(m, 48, c, H100_SMS, 2)
    assert (plan.cs, plan.cc, plan.c_pad, plan.k_pad) == (cs, cc, c_pad, 48)
    assert plan.grid % cs == 0 and plan.grid == (H100_SMS * 2 // cs) * cs
    assert plan.smem_bytes == swin_stem.stem_smem(48, 16 * cc) + (2048 if cs > 1 else 0) <= swin_stem.MAX_STEM_SMEM
    assert swin_stem.stem_plan(m, 48, c, clusters=7).grid == 7 * cs


@pytest.mark.parametrize("c,k", [(4097, 48), (8192, 48), (512, 137)])
def test_stem_plan_refuses_past_its_clusters(c, k):
    """Past sixteen CTAs of 256 channels (the H100's largest cluster), or
    where a CTA's weight slice and row buffers overflow shared memory, the
    plan raises, naming C <= 4096."""
    with pytest.raises(ValueError, match="C <= 4096"):
        swin_stem.stem_plan(100, k, c)

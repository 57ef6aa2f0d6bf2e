"""The six shapes JAX serves that the CUDA wrappers once refused, on the card.

Each kernel at each held shape of ``p2vit_tpu_torch.tools.shape_faults``
(``fused_vit_layer`` at C = 32 and 96; N = 257, 300 and 577 in the three ViT
attention kernels and N = 257 and 300 in the fused layer; the qkv-fused
kernel at head_dims 32 and 128 and C_in = 200; head_dim 128 in the per-item
kernels and the fused layer; the Swin attention, panel and folded, at
head_dim 64 with N = 49 and at N = 256, with the shift mask; the stem at
C = 1536 and 4096), LIS on and off, bit for bit against its plain version,
with one counted launch; and the launch facts of the new instances against
the Python plans. Marked ``cuda``: they skip without a card (decided in the
fixture). This file imports no JAX; ``tests/test_torch_shape_faults.py``
holds the plain versions against JAX on the CPU. On the card:
``python -m pytest --noconftest tests/test_torch_cuda_shape_faults.py -q``.
"""

import pytest
import torch

from p2vit_tpu_torch.ops import KERNELS
from p2vit_tpu_torch.ops import attention_lis as al
from p2vit_tpu_torch.ops import layer_fused, swin_stem
from p2vit_tpu_torch.tools import shape_faults

pytestmark = pytest.mark.cuda

SPECS = shape_faults.held_specs()


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("spec", range(len(SPECS)), ids=[name for name, _ in SPECS])
def test_held_shape_kernel_vs_plain(dev, spec):
    made = SPECS[spec][1](dev)
    for case in made if isinstance(made, list) else [made]:
        kern = next(k for k in KERNELS if k.__name__ == case.kernel)
        before = kern.launches
        got = case.call()
        assert kern.launches == before + 1, case.name
        assert shape_faults.mismatches(got, case.plain()) == 0, case.name


@pytest.mark.parametrize("n,hd", [(257, 64), (577, 64), (300, 128), (197, 128)])
def test_new_qkv_instances_launch_facts(dev, n, hd):
    """The cluster kernel's runtime view at the new N and head_dim (a
    non-portable cluster of 10 CTAs at N = 577) equals its plan, and the
    card holds at least one cluster."""
    for lis in (True, False):
        plan = al.qkv_cluster_plan(n, 384, hd)
        info = al.qkv_kernel_info(n, lis, hd)
        assert info["cluster"] == plan.cluster and info["smem_bytes"] == plan.smem_bytes
        assert info["max_active_clusters"] >= 1


@pytest.mark.parametrize("n,hd", [(257, 64), (577, 64), (577, 32), (197, 128)])
def test_new_rows_instances_launch_facts(dev, n, hd):
    for lis in (True, False):
        plan = al.vit_attention_plan(n, hd, lis)
        info = al.vit_attention_info(n, hd, lis)
        assert (info["hdp"], info["gc"], info["smem_bytes"]) == (plan.hdp, plan.gc, plan.smem_bytes)
        assert info["ctas_per_sm"] >= 1


@pytest.mark.parametrize("n,hd", [(49, 64), (144, 64), (256, 32)])
def test_new_swin_instances_launch_facts(dev, n, hd):
    for lis in (True, False):
        info = al.swin_attention_info(n, lis, False, hd)
        assert info["smem_bytes"] == al.swin_attention_smem(n, lis, hd) and info["ctas_per_sm"] >= 1


@pytest.mark.parametrize("c", [1536, 4096])
def test_wide_stem_launch_facts(dev, c):
    m = 3136 + 77
    plan = swin_stem.stem_plan(m, 48, c)
    info = swin_stem.stem_kernel_info(m, 48, c)
    assert (info["cs"], info["cc"], info["c_pad"]) == (plan.cs, plan.cc, plan.c_pad) and info["clusters"] >= 1


@pytest.mark.parametrize("shape", [(2, 300, 384, 6, 1536), (1, 197, 384, 3, 1536), (2, 17, 32, 2, 128)])
def test_new_layer_shapes_launch_facts(dev, shape):
    b, n, c, heads, hid = shape
    for lis in (True, False):
        plan = layer_fused.layer_plan(b, n, c, heads, hid, lis)
        info = layer_fused.layer_kernel_info(b, n, c, heads, hid, lis)
        assert (info["grid"], info["smem_bytes"], info["gc"], info["hdp"]) == (plan.grid, plan.smem_bytes, plan.gc,
                                                                                plan.hdp)

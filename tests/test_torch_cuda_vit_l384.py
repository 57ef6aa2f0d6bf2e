"""ViT-L/16 at 384 (577 tokens) on the card: row 3 at its shape (N = 577,
C_in 1024, 16 heads of 64, one non-portable cluster of 10 CTAs per image
and head) against its plain version, and one ViT-L/384 forward at batch 2
through the default ``serving_forward`` against the plain path, with no
sync, no constant formed and the launch facts on each row-3 span. Marked
``cuda``: they skip without a card (decided in the fixture). This file
imports no JAX. On the card:
``python -m pytest --noconftest tests/test_torch_cuda_vit_l384.py -q``.
"""

import pytest
import torch

from p2vit_tpu_torch import profiling, serving
from p2vit_tpu_torch.config import make_policy
from p2vit_tpu_torch.models import VIT_ZOO, preprocess, vit
from p2vit_tpu_torch.ops import attention_lis as al
from p2vit_tpu_torch.tools import shape_faults

pytestmark = pytest.mark.cuda

NAME = "vit_large_patch16_384"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("lis", [True, False])
def test_row3_at_577_tokens_and_c_in_1024(card, lis):
    """Batch 2, bit for bit with the plain version, one launch; the card
    holds at least one 10-CTA cluster, as the launch facts read."""
    case = shape_faults._qkv_case(card, 0, 2, 577, 1024, 16, 1024, lis)
    before = al.lis_attention_qkv_fused.launches
    got = case.call()
    assert al.lis_attention_qkv_fused.launches == before + 1
    assert shape_faults.mismatches(got, case.plain()) == 0
    facts = al.qkv_launch_facts(577, 1024, 64, lis, True)
    assert facts["cluster"] == 10 and facts["resident_clusters"] >= 1
    assert al.qkv_kernel_info(577, lis)["max_active_clusters"] == facts["resident_clusters"]


def test_vit_l384_forward_at_batch_2(card):
    """Calibrated on 2 images, converted W4A8, uint8 ingest at the entry's
    preprocessing: a recorded default forward makes 0 syncs and forms 0
    constants, each of its 24 row-3 spans carries ``cluster`` 10 and
    ``resident_clusters``, and its logits equal the plain path's."""
    cfg = VIT_ZOO[NAME]
    pp = preprocess(NAME)
    u8 = torch.randint(0, 256, (2, 3, 384, 384), generator=torch.Generator().manual_seed(5),
                       dtype=torch.uint8).to(card)
    mean, std = (torch.tensor(v, device=card).view(1, 3, 1, 1) for v in (pp["mean"], pp["std"]))
    x = (u8.to(torch.float32) / 255.0 - mean) / std
    p = vit.init_params(0, cfg, device=card)
    s = serving.convert(p, vit.calibrate(p, cfg, make_policy(), x).qstate, cfg, make_policy(),
                        [4] * cfg.num_matmuls)
    serving.attach_u8_ingest(s, pp["mean"], pp["std"])
    serving.serving_forward(s, cfg, u8)  # the library's build
    torch.cuda.synchronize()
    with profiling.recording():
        got = serving.serving_forward(s, cfg, u8)
        torch.cuda.synchronize()
    recs = profiling.drain()
    fwd = [r for r in recs if r.name == profiling.FORWARD]
    assert len(fwd) == 1
    inside = [r for r in recs if r.forward_id == fwd[0].forward_id]
    assert sum(r.counts.get("syncs", 0) for r in inside) == 0, profiling.sync_sites()
    assert sum(r.counts.get("consts_formed", 0) for r in inside) == 0
    qkv = [r for r in inside if r.name == "op.lis_attention_qkv_fused"]
    resident = al.qkv_launch_facts(577, 1024, 64, True, True)["resident_clusters"]
    assert len(qkv) == cfg.depth and all(r.attrs == {"cluster": 10, "resident_clusters": resident} for r in qkv)
    assert torch.equal(got, serving.serving_forward(s, cfg, u8, use_kernels=False))

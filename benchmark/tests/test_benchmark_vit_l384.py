"""``test_benchmark_reference_parity.py``'s two rules for ``vit_l384`` on the
CPU, at its 577 tokens (384² images, patch 16) and a small width (C 64, one
head of 64, depth 2): the plain reference equals the port's plain path bit
for bit, and the control (4-bit activations) reads more than 3× the cell's
limit."""

import json

import pytest
import torch

from benchmark import harness
from benchmark import weights as W
from benchmark.reference import intops
from conftest import BENCH, SEED


def small_config() -> dict:
    cfg = json.loads((BENCH / "configs" / "vit_l384.json").read_text())
    cfg["sizes"].update(embed_dim=64, num_heads=1, depth=2, num_classes=10)
    cfg["quant"]["calib_batchsize"] = 8
    return cfg


def served_and_reference(seed: int):
    from p2vit_tpu_torch import serving

    cfg = small_config()
    dev = torch.device("cpu")
    gen, params, cal_x = harness.make_inputs(cfg, seed, dev)
    x = W.images(gen, 4, cfg["sizes"]["img_size"], dev)
    prog = harness.family(cfg).Program(cfg, params, cal_x)
    assert prog.cfg.seq_len == 577
    served = serving.serving_forward(prog.s, prog.cfg, x, use_kernels=False)
    _, params, cal_x = harness.make_inputs(cfg, seed, dev)
    return served, harness.family(cfg).reference(cfg, params, cal_x), x


@pytest.mark.parametrize("seed", [3, SEED])
def test_reference_equals_plain_path(seed):
    served, fwd, x = served_and_reference(seed)
    ref = fwd(x)
    assert torch.equal(served, ref)
    assert harness.logit_gap(served, ref) == 0.0


def test_control_reads_far_above_the_limit():
    _, fwd, x = served_and_reference(SEED)
    gap = harness.logit_gap(fwd(x, intops.codes4), fwd(x))
    limit = json.loads((BENCH / "limits" / "vit_l384.bulk64.json").read_text())["logit_gap"]
    assert gap > 3 * limit

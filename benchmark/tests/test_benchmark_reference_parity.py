"""The plain reference against the port's plain path (``use_kernels=False``)
on the CPU, at a tiny ViT and a tiny Swin: the same codes bit for bit."""

import pytest
import torch

from benchmark import harness
from benchmark import weights as W
from benchmark.reference import intops
from conftest import SEED, tiny_config


def served_and_reference(name: str, seed: int):
    cfg = tiny_config(name)
    dev = torch.device("cpu")
    gen, params, cal_x = harness.make_inputs(cfg, seed, dev)
    x = W.images(gen, 6, cfg["sizes"]["img_size"], dev)
    prog = harness.family(cfg).Program(cfg, params, cal_x)
    if cfg["family"] == "vit":
        from p2vit_tpu_torch import serving

        served = serving.serving_forward(prog.s, prog.cfg, x, use_kernels=False)
    else:
        from p2vit_tpu_torch import serving_swin

        served = serving_swin.serving_forward(prog.s, prog.qstate, prog.cfg, prog.policy, x, use_kernels=False)
    _, params, cal_x = harness.make_inputs(cfg, seed, dev)
    fwd = harness.family(cfg).reference(cfg, params, cal_x)
    return served, fwd, x


@pytest.mark.parametrize("name", ["deit_b", "swin_b"])
@pytest.mark.parametrize("seed", [3, SEED])
def test_reference_equals_plain_path(name, seed):
    served, fwd, x = served_and_reference(name, seed)
    ref = fwd(x)
    assert torch.equal(served, ref)
    assert harness.logit_gap(served, ref) == 0.0


@pytest.mark.parametrize("name", ["deit_b", "swin_b"])
def test_control_reads_far_above_every_limit(name):
    """The control (4-bit activations) fails each of the config's cells."""
    import json

    from conftest import BENCH

    served, fwd, x = served_and_reference(name, SEED)
    gap = harness.logit_gap(fwd(x, intops.codes4), fwd(x))
    paths = list((BENCH / "limits").glob(f"{name}.*.json"))
    assert paths
    for path in paths:
        assert gap > 3 * json.loads(path.read_text())["logit_gap"], path.name

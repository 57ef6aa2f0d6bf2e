"""On the card, at the cell's own batch: the program within the limit, the
control (the reference with 4-bit activations) beyond it."""

import pytest
import torch


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the cells' own sizes run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["deit_b.bulk", "swin_b.bulk"])
def test_control_fails_and_program_holds(card, workload):
    from benchmark import control, harness

    cell = harness.load_cell(workload)
    r = control.readings(cell, 7, card)
    assert r["program_gap"] <= cell.limits["logit_gap"] < r["control_gap"]

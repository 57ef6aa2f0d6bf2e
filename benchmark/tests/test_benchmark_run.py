"""A whole run of each cell on the CPU at tiny sizes (the harness skips
its look for a card): the result line's keys, and the checks that decide
``correct``, with the timed path sound and with it broken underneath."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark import harness
from conftest import ROOT, SEED, tiny_cell

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def run(cell, trace=False, seconds=1.0):
    import time

    return harness.run_cell(cell, SEED, seconds, trace, torch.device("cpu"), time.perf_counter())


def test_result_line_keys(workload):
    out = run(tiny_cell(*workload))
    assert list(out) == KEYS + ["checks"]  # the numbers compared come last
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] > 0
    names = {m["name"] for m in tiny_cell(*workload).end_to_end}
    assert set(out["metrics"]) == names and "setup_s" in names
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(out["checks"]) == {"logit_gap", "unanswered"}
    json.dumps(out)


def test_traced_result_line(workload):
    out = run(tiny_cell(*workload), trace=True, seconds=2.0)
    assert list(out) == KEYS + ["breakdown", "checks"]
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
    assert len(out["breakdown"]["idle_gaps"]) <= 10
    assert out["device"]["window_s"] > 0
    allowed = {m["name"] for m in tiny_cell(*workload).per_layer}
    assert set(out["metrics"]) <= allowed


def _broken(monkeypatch, cell, fault):
    fam = harness.family(cell.config)
    real = fam.Program.forward

    def forward(self, x):
        y = real(self, x).clone()
        if fault == "answer":  # one logit of one image altered where it is produced
            y[-1, 3] += y[-1].abs().max() * 0.5 + 1.0
        else:  # half of the batch left out: the rest repeat the first half's answers
            n, h = x.shape[0], (x.shape[0] + 1) // 2
            y = real(self, x[:h])[torch.arange(n) % h]
        return y

    monkeypatch.setattr(fam.Program, "forward", forward)


@pytest.mark.parametrize("fault", ["answer", "half_batch"])
def test_broken_path_is_not_correct(monkeypatch, workload, fault):
    cell = tiny_cell(*workload)
    _broken(monkeypatch, cell, fault)
    out = run(cell)
    assert out["correct"] is False
    assert out["checks"]["logit_gap"]["value"] > out["checks"]["logit_gap"]["limit"]


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: run.py runs")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "deit_b.bulk", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=ROOT)
    assert p.returncode != 0 and p.stdout.strip() == ""

"""Fixtures of the benchmark's CPU tests: tiny configurations and mixes
(the cells' own files, cut to CPU sizes), and cells built from them."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

BENCH = ROOT / "benchmark"
SEED = 2 ** 31 + 12345  # past 32 signed bits: run.py takes any seed up to 2**64


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH / "configs" / f"{name}.json").read_text())
    if cfg["family"] == "vit":
        cfg["sizes"].update(img_size=32, embed_dim=64, depth=2, num_heads=2, num_classes=10)
    else:
        cfg["sizes"].update(img_size=32, embed_dim=16, depths=[2, 2], num_heads=[2, 4], window_size=4,
                            num_classes=10)
    cfg["quant"]["calib_batchsize"] = 8
    return cfg


def tiny_mix(name: str) -> dict:
    mix = json.loads((BENCH / "traffic" / f"{name}.json").read_text())
    if mix["loop"] == "closed":
        mix.update(batch=4, ring_images=16, warmup_batches=[4])
    else:
        mix.update(max_batch=8, ring_images=32, warmup_batches=[8, 1], rate_per_s=150)
    return mix


# readers of an open-loop cell, for the mix that no cell of BENCHMARK.json runs yet
OPEN_METRICS = ([{"name": "request_p95_ms", "unit": "ms"}, {"name": "setup_s", "unit": "s"}],
                [{"name": "dispatch_ms.online", "unit": "ms"}, {"name": "idle_share.online", "unit": "%"}])


def tiny_cell(config: str, mix: str):
    """The cell (config, mix) at CPU sizes: its metrics and limit from
    BENCHMARK.json and limits/ where it is a cell there."""
    from benchmark import harness

    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    name = f"{config}.{mix}"
    if name in {w["name"] for w in spec["workloads"]}:
        e2e = [m for m in spec["end_to_end"] if harness._applies(m, name)]
        per_layer = [m for m in spec["per_layer"] if harness._applies(m, name)]
        limits = json.loads((BENCH / "limits" / f"{name}.json").read_text())
    else:
        e2e, per_layer = OPEN_METRICS
        limits = {"logit_gap": 0.05}
    return harness.Cell(name, tiny_config(config), tiny_mix(mix), e2e, per_layer, limits)


@pytest.fixture(params=[("deit_b", "bulk"), ("swin_b", "bulk"), ("deit_b", "online"), ("swin_b", "online")],
                ids=lambda p: ".".join(p))
def workload(request):
    return request.param

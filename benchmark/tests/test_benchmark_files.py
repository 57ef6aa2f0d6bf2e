"""``BENCHMARK.json`` against the contract's shape rules, and the harness
finding a configuration, a mix and a metric added as files, with no edit."""

import json
import re
import shutil

import pytest

from benchmark import harness, traffic
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"]
    assert 1 <= SPEC["run_seconds"] <= 51 and isinstance(SPEC["run_seconds"], int)
    names = [c["name"] for c in SPEC["configs"]] + [w["name"] for w in SPEC["workloads"]]
    names += [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in SPEC["workloads"]]:
        assert NAME.match(n), n
    for text in ([c["why"] for c in SPEC["configs"]] + [w["why"] for w in SPEC["workloads"]]
                 + [m["layer"] for m in SPEC["per_layer"]] + [c["source"] for c in SPEC["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text, text
    assert len(json.dumps(SPEC)) < 64 * 1024


def test_configs_cells_and_files():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert json.loads((ROOT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def test_metrics():
    e2e = {m["name"] for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    assert "setup_s" in e2e
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in e2e
        mv = next(e for e in SPEC["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(mv.get("workloads", cells))
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for w in cells:
        assert any(harness._applies(m, w) for m in SPEC["per_layer"])
        assert len([m for m in SPEC["end_to_end"] if harness._applies(m, w)]) >= 2


def test_new_files_are_found(tmp_path):
    """A later PR adds a configuration, a mix, a metric and a cell as files."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH / "configs", bench / "configs")
    (bench / "traffic").mkdir(parents=True)
    (bench / "limits").mkdir()
    (bench / "metrics").mkdir()
    cfg = json.loads((BENCH / "configs" / "deit_b.json").read_text())
    cfg["name"] = "deit_b_copy"
    (bench / "configs" / "deit_b_copy.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "burst.json").write_text(json.dumps({"loop": "open", "max_batch": 8, "in_flight": 2,
                                                               "rate_per_s": 10, "ring_images": 8}))
    (bench / "limits" / "deit_b_copy.burst.json").write_text(json.dumps({"logit_gap": 0.01}))
    (bench / "metrics" / "answered.py").write_text("def read(ctx):\n    return 42.0\n")
    spec = {"configs": [{"name": "deit_b_copy", "file": "benchmark/configs/deit_b_copy.json"}],
            "workloads": [{"name": "deit_b_copy.burst", "config": "deit_b_copy", "traffic": "burst"}],
            "end_to_end": [{"name": "answered", "unit": "1"}], "per_layer": []}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    cell = harness.load_cell("deit_b_copy.burst", root=tmp_path)
    assert cell.config["name"] == "deit_b_copy" and cell.mix["rate_per_s"] == 10
    assert traffic.load("burst", bench / "traffic")["loop"] == "open"
    assert cell.limits == {"logit_gap": 0.01}
    assert harness.reader("answered", cell.bench / "metrics")(None) == 42.0


def test_unknown_workload_is_refused():
    with pytest.raises(SystemExit):
        harness.load_cell("no_such.cell")

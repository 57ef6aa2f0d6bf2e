"""The port's serving planner (``p2vit_tpu_torch/plan.py``), cost model and
profiler trace (``p2vit_tpu_torch/profiling.py``).

* ``recommend``: with the port's table replaced by the JAX package's (its
  crossovers, its narrow-ViT rule, its fuse flags and LIS rule), the same
  ``path``, ``lis`` and fuse flags as JAX's ``recommend`` over the zoo ×
  batches {1, 4, 8, 64, 128, 256} × ``prefer_exact``: the same rule
  structure. Separate cases pin the port's own table, measured on the card
  (the module docstring cites the run).
* ``cost_model``: equal to JAX's for every zoo member (pure integers).
* ``trace``: a Chrome trace on the CPU that names an op.
"""

import dataclasses
import json
import os

import pytest
import torch

from p2vit_tpu import plan as jplan
from p2vit_tpu import profiling as jprofiling
from p2vit_tpu.models import SWIN_ZOO as J_SWIN_ZOO
from p2vit_tpu.models import VIT_ZOO as J_VIT_ZOO
from p2vit_tpu.models.common import ViTConfig as JViTConfig
from p2vit_tpu_torch import plan, profiling
from p2vit_tpu_torch.models import SWIN_ZOO, VIT_ZOO
from p2vit_tpu_torch.tools import latency_ab

ZOO = sorted(VIT_ZOO) + sorted(SWIN_ZOO)
JAX_FLAGS = dict(fuse_qkv=True, fuse_layer=False, fuse_embed=True)


def _port_cfg(name):
    return VIT_ZOO[name] if name in VIT_ZOO else SWIN_ZOO[name]


def _jax_cfg(name):
    """JAX's zoo entry, or, for a member the JAX package's zoo lacks (ViT-L
    at 384), JAX's ``ViTConfig`` at the port entry's sizes."""
    if name in J_VIT_ZOO or name in J_SWIN_ZOO:
        return J_VIT_ZOO[name] if name in J_VIT_ZOO else J_SWIN_ZOO[name]
    return JViTConfig(**dataclasses.asdict(VIT_ZOO[name]))


@pytest.fixture
def jax_table(monkeypatch):
    monkeypatch.setattr(plan, "INT8_MIN_BATCH", dict(jplan.INT8_MIN_BATCH))
    monkeypatch.setattr(plan, "CROSSOVER_MEASURED_ON", dict(jplan.CROSSOVER_MEASURED_ON))
    monkeypatch.setattr(plan, "VIT_MIN_EMBED_DIM", jplan.VIT_MIN_EMBED_DIM)
    monkeypatch.setattr(plan, "INT8_FLAGS", {"vit": dict(JAX_FLAGS), "swin": dict(JAX_FLAGS)})
    monkeypatch.setattr(plan, "FASTEST_LIS", {"vit": False, "swin": True})


@pytest.mark.parametrize("name", ZOO)
def test_recommend_under_jax_table_equals_jax(jax_table, name):
    for batch in (1, 4, 8, 64, 128, 256):
        for exact in (True, False):
            got = plan.recommend(_port_cfg(name), batch, prefer_exact=exact)
            want = jplan.recommend(_jax_cfg(name), batch, prefer_exact=exact)
            assert (got.path, got.lis, got.fuse_qkv, got.fuse_layer, got.fuse_embed) == (
                want.path, want.lis, want.fuse_qkv, want.fuse_layer, want.fuse_embed), (name, batch, exact)
            assert got.reason


def test_plan_api_and_input_checks():
    deit_s = VIT_ZOO["deit_small_patch16_224"]
    p = plan.recommend(deit_s, 256)
    assert p.path == "int8" and p.vit_kwargs() == {"lis": p.lis, "fuse_qkv": p.fuse_qkv,
                                                    "fuse_layer": p.fuse_layer, "fuse_embed": p.fuse_embed}
    assert dataclasses.fields(plan.ServingPlan) and [f.name for f in dataclasses.fields(plan.ServingPlan)] == [
        f.name for f in dataclasses.fields(jplan.ServingPlan)]
    with pytest.raises(ValueError):
        plan.recommend(deit_s, 0)
    with pytest.raises(TypeError):
        plan.recommend(object(), 8)
    with pytest.raises(ValueError):
        dataclasses.replace(p, path="bf16").vit_kwargs()


def test_port_table_is_the_cards():
    """The table's values are the measured ones the docstring cites; no
    reason names the TPU's matrix unit or BENCH.md."""
    assert plan.SWEPT_BATCHES == (1, 8, 32, 64, 128, 256)
    assert set(plan.INT8_MIN_BATCH) == {"vit", "swin"} and plan.CROSSOVER_MEASURED_ON == {
        "vit": "deit_small", "swin": "swin_tiny"}
    assert "H100" in plan.__doc__ and " W" in plan.__doc__
    for name in ZOO:
        for b in plan.SWEPT_BATCHES:
            for exact in (True, False):
                r = plan.recommend(_port_cfg(name), b, prefer_exact=exact).reason
                assert "MXU" not in r and "BENCH" not in r and "v5e" not in r and "TPU" not in r


@pytest.mark.parametrize("fam,name", [("vit", "deit_small_patch16_224"), ("swin", "swin_tiny_patch4_window7_224")])
def test_port_table_rules(fam, name):
    """Below the family's measured crossover the bf16 path (weight-only);
    from it on int8 with the measured-fastest arm's flags; LIS kept under
    ``prefer_exact``."""
    cfg = _port_cfg(name)
    lo = plan.INT8_MIN_BATCH[fam]
    for b in plan.SWEPT_BATCHES:
        p = plan.recommend(cfg, b)
        assert p.path == ("int8" if lo is not None and b >= lo else "bf16")
        if p.path == "int8":
            assert p.lis is True and latency_ab.arm_of(p).startswith("int8")
            flags = {k: getattr(p, k) for k in ("fuse_qkv", "fuse_layer", "fuse_embed")}
            assert flags == plan.INT8_FLAGS[fam]
            assert plan.recommend(cfg, b, prefer_exact=False).lis == plan.FASTEST_LIS[fam]
        else:
            assert latency_ab.arm_of(p) == "wonly" and "weight_only_params" in p.reason


def test_arm_of_names_each_arm():
    mk = lambda **k: plan.ServingPlan(**{**dict(path="int8", lis=True, reason="r"), **JAX_FLAGS, **k})  # noqa: E731
    assert latency_ab.arm_of(mk()) == "int8"
    assert latency_ab.arm_of(mk(lis=False)) == "int8_loff"
    assert latency_ab.arm_of(mk(fuse_qkv=False, fuse_embed=False)) == "int8_staged"
    assert latency_ab.arm_of(mk(fuse_layer=True, lis=False)) == "int8_fl_loff"
    assert latency_ab.arm_of(mk(path="bf16")) == "wonly"


@pytest.mark.parametrize("name", ZOO)
def test_cost_model_equals_jax(name):
    assert profiling.cost_model(_port_cfg(name)) == jprofiling.cost_model(_jax_cfg(name))


def test_cost_model_refuses_other_configs():
    with pytest.raises(TypeError):
        profiling.cost_model(object())


def test_trace_writes_a_chrome_trace(tmp_path):
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    a = torch.ones(8, 8, device=dev)
    with profiling.trace(str(tmp_path / "t")):
        with profiling.span("test.mm"):
            torch.mm(a, a)
        if dev == "cuda":
            torch.cuda.synchronize()
    path = tmp_path / "t" / "trace.json"
    assert os.path.exists(path)
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e.get("cat") == "program_span"]
    assert [e["name"] for e in spans] == ["test.mm"] and not profiling.drain()
    t0, t1 = spans[0]["ts"], spans[0]["ts"] + spans[0]["dur"]
    if dev == "cuda":  # the card's activity alone: the kernel starts after its span opened
        kernels = [e for e in events if e.get("cat") == "kernel"]
        assert kernels and not any(e.get("cat") == "cpu_op" for e in events)
        assert min(e["ts"] for e in kernels) > t0
    else:  # the host's op lies inside its span on the trace's clock
        mm = [e for e in events if e.get("name") == "aten::mm" and e.get("ph") == "X"]
        assert mm and t0 - 20 <= mm[0]["ts"] and mm[0]["ts"] + mm[0]["dur"] <= t1 + 20

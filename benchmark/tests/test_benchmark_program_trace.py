"""``program_trace.py``'s readings of the program's spans on a synthetic
trace whose answers are worked out by hand, and its traced run of a tiny
cell on the CPU, with the program's recorder and without it."""

import time

import pytest
import torch

from benchmark import harness, program_trace
from benchmark.program_trace import SpanTrace, innermost_segments, readings, recording_cost, run
from conftest import SEED, tiny_cell

REQUANT = "void p2v::wg::requant_kernel<64, 6, true, false>(CUtensorMap_st, int)"
RES_LN = "void p2v::wg::res_ln_kernel<256>(CUtensorMap_st, int)"


def _x(cat, name, t0_ms, t1_ms, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": t0_ms * 1e3, "dur": (t1_ms - t0_ms) * 1e3, "args": args}


def synthetic(runtime=True) -> SpanTrace:
    """A 10 ms window: one forward (1–5 ms) of one block whose two wrappers
    launch a requant GEMM (device 2.5–3.0 ms) and a junction (4.5–6.0 ms);
    the requant wrapper syncs once; the harness waits from 5.5 to 9.5 ms."""
    events = [_x("kernel", REQUANT, 2.5, 3.0, correlation=1), _x("kernel", RES_LN, 4.5, 6.0, correlation=2)]
    if runtime:
        events += [_x("cuda_runtime", "cudaLaunchKernelExC", 2.2, 2.25, correlation=1),
                   _x("cuda_runtime", "cudaLaunchKernelExC", 3.6, 3.65, correlation=2)]
    program = [("serving.forward", 1e-3, 5e-3, 1, {}, {"batch": 4}),
               ("vit.block", 1.5e-3, 4.5e-3, 1, {}, {"index": 0}),
               ("op.int8_matmul_requant", 2e-3, 3e-3, 1, {"launches": 1, "syncs": 1}, {}),
               ("op.int8_matmul_res_ln", 3.5e-3, 4e-3, 1, {"launches": 1}, {})]
    return SpanTrace(events, (0.0, 10e-3), [("bench.wait", 5.5e-3, 9.5e-3)], program)


def test_innermost_segments():
    spans = [("f", 0, 10), ("a", 1, 3), ("b", 3, 5), ("c", 3.5, 4), ("d", 7, 9)]
    _, segs = innermost_segments(spans)
    assert [(a, b, s[0]) for a, b, s in segs] == [(0, 1, "f"), (1, 3, "a"), (3, 3.5, "b"), (3.5, 4, "c"),
                                                 (4, 5, "b"), (5, 7, "f"), (7, 9, "d"), (9, 10, "f")]


def test_readings_on_a_synthetic_trace():
    r = readings(synthetic())
    assert r["host_syncs_per_forward"] == 1
    assert r["forward_idle_ms"] == pytest.approx(3.0)  # 1–2.5 and 3–4.5 ms
    assert r["wrapper_host_us"] == pytest.approx(500.0)  # the junction's wrapper: no sync


def test_breakdown_lists():
    tr = synthetic()
    b = tr.breakdown()
    assert set(b) == {"device_ops", "idle_gaps", "idle_by_span", "syncs_by_span", "device_ms_by_span"}
    assert b["idle_by_span"] == [["bench.wait", pytest.approx(4.0)], ["serving.forward", pytest.approx(2.5)],
                                 ["op.int8_matmul_res_ln", pytest.approx(1.5)]]
    assert b["syncs_by_span"] == [["op.int8_matmul_requant", 1]]
    assert b["device_ms_by_span"] == [["vit.block", pytest.approx(2.0)]]
    assert "device_ms_by_span" not in synthetic(runtime=False).breakdown()


def test_runtime_calls_and_wrapper_times():
    tr = synthetic()
    assert tr.runtime_ms_by_call() == [["op.int8_matmul_requant cudaLaunchKernelExC", pytest.approx(0.05)],
                                       ["op.int8_matmul_res_ln cudaLaunchKernelExC", pytest.approx(0.05)]]
    assert tr.wrapper_host_us_by_op() == {"op.int8_matmul_requant": [pytest.approx(1000.0), 1],
                                          "op.int8_matmul_res_ln": [pytest.approx(500.0), 1]}


def test_clock_check():
    c = synthetic().clock_check()
    assert c["port_launches"] == 2 and c["inside_op_span"] == 2 and c["share"] == 1.0
    assert c["median_us_after_span_start"] == pytest.approx(150.0)
    assert synthetic(runtime=False).clock_check() == {}


def test_no_program_spans_reads_none():
    tr = SpanTrace([], (0.0, 1.0), [], [])
    assert readings(tr) == {"host_syncs_per_forward": None, "forward_idle_ms": None, "wrapper_host_us": None}
    assert tr.clock_check() == {} and tr.breakdown()["idle_by_span"] == []


@pytest.mark.parametrize("record", [True, False], ids=["recorder", "no_recorder"])
def test_traced_run_on_the_cpu(monkeypatch, record):
    if not record:  # a program without the recorder, as before it had one
        monkeypatch.setattr(program_trace, "_recorder", lambda: None)
    cell = tiny_cell("deit_b", "bulk")
    out, tr = run(cell, SEED, 2.0, torch.device("cpu"), time.perf_counter())
    assert out["correct"] is True and harness.Tracer.__name__ == "Tracer"
    assert {"idle_by_span", "syncs_by_span"} <= set(out["breakdown"])
    assert tr.dispatch_ms_window() > 0
    r = readings(tr)
    if record:  # the recorder was on over the window alone; no card, no sync
        assert tr.forwards() and r["host_syncs_per_forward"] == 0 and r["wrapper_host_us"] > 0
        w0, w1 = tr.window
        assert all(w0 <= s[1] and s[2] <= w1 for s in tr.program)
    else:
        assert not tr.program and r["host_syncs_per_forward"] is None


def test_recording_cost_on_the_cpu():
    out = recording_cost(tiny_cell("swin_b", "bulk"), SEED, 1.0, torch.device("cpu"))
    assert out["forwards"] >= 3 and out["on_ms"] > 0 and out["off_ms"] > 0
    assert out["spans_per_forward"] > 1 and set(out["off_call_ns"]) == {"op_span", "span"}

"""The port's span recorder (``profiling.span``, ``op_span``, the sync and
launch counts) on the CPU at tiny sizes: off, it records nothing and the
wrappers keep their counters; on, one forward's spans mirror its layers and
kernel calls and leave the logits bit for bit as they were. The tests
marked ``cuda`` run on a card (``python -m pytest --noconftest
tests/test_torch_spans.py``) and skip here."""

import importlib
import json
import time
import warnings

import pytest
import torch

from p2vit_tpu_torch import ops, profiling, serving, serving_swin
from p2vit_tpu_torch.config import make_policy
from p2vit_tpu_torch.models import swin, vit
from p2vit_tpu_torch.models.common import ViTConfig

VIT = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
SWIN = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                       num_heads=(2, 2), window_size=4)


@pytest.fixture(autouse=True)
def _recorder_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


@pytest.fixture(scope="module")
def models():
    """(forward, x) per family: a calibrated, converted tiny model on the CPU."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 3, 32, 32, generator=g)
    pv = vit.init_params(0, VIT, device="cpu")
    sv = serving.convert(pv, vit.calibrate(pv, VIT, make_policy(), x).qstate, VIT, make_policy(),
                         [8] * VIT.num_matmuls)
    ps = swin.init_params(0, SWIN, device="cpu")
    qs = swin.calibrate(ps, SWIN, make_policy(), x).qstate
    ss = serving_swin.convert(ps, qs, SWIN, make_policy(), 8)
    return {"vit": (lambda t: serving.serving_forward(sv, VIT, t), x),
            "swin": (lambda t: serving_swin.serving_forward(ss, qs, SWIN, make_policy(), t), x)}


def test_recording_off_records_nothing(models):
    fwd, x = models["vit"]
    assert profiling.span("a") is profiling.span("b", index=1)
    with profiling.span("a"):
        profiling.count("syncs")
    fwd(x)
    assert profiling.drain() == []


@pytest.mark.parametrize("family", ["vit", "swin"])
def test_recording_leaves_logits_bitwise(models, family):
    fwd, x = models[family]
    off = fwd(x)
    with profiling.recording():
        on = fwd(x)
    assert torch.equal(off, on)
    assert profiling.drain()


def _one_forward(fwd, x):
    with profiling.recording():
        fwd(x)
    recs = profiling.drain()
    fwd_spans = [r for r in recs if r.name == profiling.FORWARD]
    assert len(fwd_spans) == 1 and fwd_spans[0].attrs == {"batch": x.shape[0]}
    fid = fwd_spans[0].forward_id
    assert fid is not None and all(r.forward_id == fid for r in recs)
    by_id = {r.span_id: r for r in recs}
    for r in recs:  # every span lies inside its parent
        if r.parent_id is not None:
            p = by_id[r.parent_id]
            assert p.t0_ns <= r.t0_ns <= r.t1_ns <= p.t1_ns
    ops_n = {}
    for r in recs:
        if r.name.startswith("op."):
            ops_n[r.name[3:]] = ops_n.get(r.name[3:], 0) + 1
    return recs, ops_n


def test_vit_forward_spans(models):
    recs, ops_n = _one_forward(*models["vit"])
    names = [r.name for r in recs]
    assert names.count("vit.embed") == 1 and names.count("vit.head") == 1
    assert [r.attrs["index"] for r in recs if r.name == "vit.block"] == list(range(VIT.depth))
    assert ops_n == serving.launches_per_forward(VIT)


def test_swin_forward_spans(models):
    recs, ops_n = _one_forward(*models["swin"])
    names = [r.name for r in recs]
    assert names.count("swin.stem") == 1 and names.count("swin.head") == 1
    assert names.count("swin.merge") == len(SWIN.depths) - 1
    blocks = [(r.attrs["stage"], r.attrs["block"]) for r in recs if r.name == "swin.block"]
    assert blocks == [(i, j) for i, d in enumerate(SWIN.depths) for j in range(d)]
    assert ops_n == serving_swin.launches_per_forward(SWIN)


def test_forward_ids_and_drain(models):
    fwd, x = models["vit"]
    with profiling.recording():
        with profiling.span("outside"):
            pass
        fwd(x)
        fwd(x)
    recs = profiling.drain()
    assert profiling.drain() == []
    assert [r.forward_id for r in recs if r.name == "outside"] == [None]
    fids = {r.forward_id for r in recs if r.name == profiling.FORWARD}
    assert len(fids) == 2


def test_sync_warning_counts_on_the_innermost_span():
    with profiling.recording():
        with profiling.span("outer"):
            with profiling.span("inner"):
                warnings.warn(profiling.SYNC_WARNING)
                warnings.warn(profiling.SYNC_WARNING)
            with pytest.warns(UserWarning, match="other"):  # other warnings still reach their handlers
                warnings.warn("other")
    recs = {r.name: r for r in profiling.drain()}
    assert recs["inner"].counts == {"syncs": 2} and recs["outer"].counts == {}
    assert sum(profiling.sync_sites().values()) == 2
    with warnings.catch_warnings(record=True) as seen:  # off: the warning is PyTorch's again
        warnings.simplefilter("always")
        warnings.warn(profiling.SYNC_WARNING)
    assert len(seen) == 1


def test_op_span_counts_launches():
    @profiling.op_span
    def fake(n):
        fake.launches += n
        return n

    fake.launches = 0
    assert fake(2) == 2 and fake.launches == 2
    with profiling.recording():
        fake(3)
        fake(0)
    recs = profiling.drain()
    assert [(r.name, r.counts) for r in recs] == [("op.fake", {"launches": 3}), ("op.fake", {})]
    assert fake.launches == 5


@pytest.mark.parametrize("kernel", ops.KERNELS, ids=lambda k: k.__name__)
def test_kernels_keep_name_and_launches(kernel):
    mod = importlib.import_module(kernel.__wrapped__.__module__)
    assert getattr(mod, kernel.__name__) is kernel and kernel.__wrapped__.__name__ == kernel.__name__
    before = ops.launch_counts()
    kernel.launches += 1
    assert ops.launch_counts()[kernel.__name__] == before[kernel.__name__] + 1
    kernel.launches -= 1


def test_clock_pair_and_trace_clock():
    with profiling.recording():
        wall, perf = profiling.clock()
    assert abs(wall - time.time_ns()) < 10 ** 9
    rec = profiling.Span("s", 1, None, None, perf + 5_000, perf + 7_000, {"k": 1}, {"syncs": 2})
    base = wall - 1_000_000
    ev = profiling.chrome_events([rec], base, (wall, perf))
    assert ev[0]["ph"] == "M"
    x = ev[1]
    assert x["ph"] == "X" and x["pid"] == profiling.SPAN_PID
    assert x["ts"] == pytest.approx(1005.0) and x["dur"] == pytest.approx(2.0)
    assert x["args"]["k"] == 1 and x["args"]["syncs"] == 2


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU or interpret mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
def test_card_counts_syncs_and_launches(card):
    x = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(0)).to(card)
    p = vit.init_params(0, VIT, device=card)
    s = serving.convert(p, vit.calibrate(p, VIT, make_policy(), x).qstate, VIT, make_policy(), [8] * VIT.num_matmuls)
    serving.serving_forward(s, VIT, x)  # the library's build
    with profiling.recording():
        with profiling.span("item"):
            x.sum().item()
        serving.serving_forward(s, VIT, x)
    recs = profiling.drain()
    assert next(r for r in recs if r.name == "item").counts == {"syncs": 1}
    launched = {}
    for r in recs:
        if r.name.startswith("op."):
            launched[r.name[3:]] = launched.get(r.name[3:], 0) + r.counts["launches"]
    assert launched == serving.launches_per_forward(VIT)
    print("syncs a forward:", {r.name: r.counts["syncs"] for r in recs if r.counts.get("syncs") and r.name != "item"},
          profiling.sync_sites())


@pytest.mark.cuda
def test_card_trace_holds_spans_and_kernels(card, tmp_path):
    a = torch.ones(64, 64, device=card)
    with profiling.trace(str(tmp_path)):
        with profiling.span("test.mm"):
            torch.mm(a, a)
        torch.cuda.synchronize()
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    (sp,) = [e for e in events if e.get("cat") == "program_span"]
    kernels = [e for e in events if e.get("cat") == "kernel"]
    launches = [e for e in events if e.get("cat") == "cuda_runtime" and "Launch" in e.get("name", "")]
    assert kernels and min(e["ts"] for e in kernels) > sp["ts"]
    assert not any(e.get("cat") == "cpu_op" for e in events)
    print("runtime launch events:", len(launches), [e["ts"] - sp["ts"] for e in launches][:4])

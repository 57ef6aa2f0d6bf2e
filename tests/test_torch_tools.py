"""The two ported weight-store tools, run with ``--device cpu`` (the kernels'
plain versions) at the tiny shapes of tests/test_bench_tools_smoke.py,
depth 2: their lines and pins, and each tool's chain against the same
chain built from the JAX package's functions on the same numpy draws (the
Pallas kernels in interpret mode); and ``w4pack_bench``, the stores'
device-time A/B, on the CPU (its pins and bounds).

The serving and search tools (``latency_ab``, ``search_bench``,
``search_bench_swin``, ``e2e_eval``) run as smoke cases with ``--device
cpu`` on TINY models put in their zoo under the names they look up.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.ops.matmul_int8 import int4_matmul_requant as j_int4
from p2vit_tpu.ops.matmul_int8 import int8_matmul_requant as j_int8
from p2vit_tpu.ops.matmul_int8 import pack_int4 as j_pack_int4
from p2vit_tpu.ops.matmul_wstream import pack_w4, pack_w8, wstream_matmul
from p2vit_tpu_torch.tools import _gemm_bench as gb
from p2vit_tpu_torch.tools import w4pack_latency as wl
from p2vit_tpu_torch.tools import wstream_bench as wsb

TINY_GEMMS = (("qkv", 32, 96, False), ("proj", 32, 32, False), ("fc1", 32, 128, True),
              ("fc2", 128, 32, False))
ARGV = ["--device", "cpu", "--iters", "1", "--depth", "2"]


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(gb, "DEIT_S_GEMMS", TINY_GEMMS)
    monkeypatch.setattr(gb, "CONTROL", ("fc2_b", 256, 64, False))


def _np_bf16(t):
    return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)


def _ulp(a, b):
    def key(x):
        u = np.asarray(x).view(np.uint16).astype(np.int32)
        return np.where(u & 0x8000, 0x8000 - (u & 0x7FFF) - 1, u + 0x8000)

    return np.abs(key(a) - key(b))


def test_w4pack_latency_smoke(tiny, capsys):
    res = wl.main(ARGV)
    out = capsys.readouterr().out
    assert "MISMATCH" not in out and "FAILED" not in out
    assert "depth-2 chain" in out and out.count("bitwise=ok") == 12
    assert all(r["bitwise"] for r in res.values())


def test_w4pack_bench_smoke(tiny, capsys):
    """The device-time A/B tool on the CPU: both stores' chains and GEMMs
    agree, and it prints the bounds (the int4 store's weight bytes half the
    int8 store's) and no device time."""
    from p2vit_tpu_torch.tools import w4pack_bench

    (line,) = w4pack_bench.main(["--device", "cpu", "--ms", "64", "--depth", "2"])
    assert json.loads(capsys.readouterr().out) == line
    assert not any(key.startswith("chain_us") for key in line)
    assert line["chain_bound_us w4p"] < line["chain_bound_us i8"]
    assert line["fc2_b_bound_us i8"] == round(w4pack_bench.gemm_bound_us(64, 256, 64, False), 3)
    assert w4pack_bench.gemm_bound_us(64, 256, 64, True) * 3.35e6 == pytest.approx(
        64 * 256 + 64 * 128 + 8 * 64 + 64 * 64, rel=1e-12)


def test_wstream_bench_smoke(tiny, capsys):
    res = wsb.main(ARGV)
    out = capsys.readouterr().out
    assert "FAILED" not in out and "!" not in out
    assert "best=" in out and "depth-2 chain" in out
    assert res["fc2@m197"]["w8p_bytes_ratio"] == 0.5  # K = 128: one padded 128-word panel row


def _jax_chain(x, layers, mm):
    c = x.shape[1]
    for (wq, rq, bq), (wp, rp, bp), (w1, r1, b1), (w2, r2, b2) in layers:
        a = mm(x, wq, rq, bq, False)
        p = mm(a[:, :c], wp, rp, bp, False)
        f = mm(p, w1, r1, b1, True)
        x = mm(f, w2, r2, b2, False)
    return x


def _jax_layers(layers):
    return [[tuple(jnp.asarray(t.numpy()) for t in g) for g in lay] for lay in layers]


@pytest.mark.parametrize("arm", ["i8", "w4p"])
def test_w4pack_chain_bitwise_vs_jax(tiny, arm):
    x, layers, stores = wl.chain_case(8, 5, 2, "cpu")
    got = wl.chain(arm, x, layers, stores)

    def mm(xx, w, r, b, gelu):
        kw = dict(gelu=True, out_inv=8.0) if gelu else {}
        if arm == "i8":
            return j_int8(xx, w, r, b, interpret=True, **kw)
        return j_int4(xx, j_pack_int4(w), r, b, interpret=True, **kw)

    want = _jax_chain(jnp.asarray(x.numpy()), _jax_layers(layers), mm)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("arm", ["bf16", "i8", "w8p", "w4p"])
def test_wstream_chain_vs_jax(tiny, arm):
    """JAX's envelope is ≤ 2 bf16 ulp per GEMM with GELU; at these draws the
    depth-2 chain is bit for bit JAX's in every store (measured 0 ulp)."""
    x, layers = wsb.chain_case(8, 5, 2, "cpu")
    got = wsb.chain(arm, x, layers, wsb.chain_stores(arm, layers))
    pack = {"bf16": lambda w: w.astype(jnp.bfloat16), "i8": lambda w: w, "w8p": pack_w8, "w4p": pack_w4}[arm]

    def mm(xx, w, r, b, gelu):
        return wstream_matmul(xx, pack(w), r, b, w_format=arm, gelu=gelu, interpret=True)

    want = _jax_chain(jnp.asarray(x.to(torch.float32).numpy()).astype(jnp.bfloat16), _jax_layers(layers), mm)
    assert _ulp(_np_bf16(got), want).max() == 0


# ---------------------------------------------------------------------------
# latency_ab, search_bench, search_bench_swin, e2e_eval at TINY size
# ---------------------------------------------------------------------------

from p2vit_tpu_torch.models.common import ViTConfig  # noqa: E402
from p2vit_tpu_torch.models.swin import SwinConfig  # noqa: E402

VTINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=64, depth=2, num_heads=2)
STINY = SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2), num_heads=(2, 2),
                   window_size=4)


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def test_latency_ab_smoke(monkeypatch, capsys, one_thread):
    """Every ViT arm (the fused layer's bitwise against the default) and the
    Swin set, one forward a window on the CPU, no device time."""
    from p2vit_tpu_torch.tools import latency_ab as la

    monkeypatch.setattr(la, "MODEL_ZOO", {"deit_small_patch16_224": VTINY, "swin_tiny_patch4_window7_224": STINY})
    monkeypatch.setattr(la, "SWIN_ZOO", {"swin_tiny_patch4_window7_224": STINY})
    res = la.main(["deit_small", "swin_tiny", "--device", "cpu", "--batches", "1,2"])
    out = capsys.readouterr().out
    vit_arms = ["bf16", "int8", "int8_staged", "int8_fl", "int8_loff", "int8_fl_loff", "wonly"]
    assert list(res) == ["deit_small_patch16_224@b1", "deit_small_patch16_224@b2", "swin_tiny_patch4_window7_224@b1",
                         "swin_tiny_patch4_window7_224@b2"]
    row = res["deit_small_patch16_224@b2"]
    assert all(row[f"{a}_ms"] > 0 and row[f"{a}_dev_ms"] is None for a in vit_arms)
    assert row["fl_bitwise"] is True and row["best"] in vit_arms
    # the check: every int8 arm equals its plain path; no launches on the CPU
    assert all(row[f"{a}_bad"] == 0 and row[f"{a}_launches"] == row[f"{a}_launches_want"] == {}
               for a in vit_arms[1:-1])
    swin_int8 = ("int8", "int8_loff")
    assert set(res["swin_tiny_patch4_window7_224@b1"]) == {f"{a}_{k}" for a in ("bf16", "int8", "int8_loff", "wonly")
                                                            for k in ("ms", "dev_ms")} | {"best"} | {
        f"{a}_{k}" for a in swin_int8 for k in ("bad", "launches", "launches_want")}
    assert all(res["swin_tiny_patch4_window7_224@b2"][f"{a}_bad"] == 0 for a in swin_int8)
    assert out.count("best=") == 4 and json.loads(out.strip().splitlines()[-1]) == res


@pytest.mark.parametrize("fam", ["vit", "swin"])
def test_search_bench_smoke(monkeypatch, capsys, one_thread, fam):
    """The search at a TINY width: a depth-12 ViT under deit_tiny's name (its
    mean-Hessian table has 50 slots; a depth-2 ViT's front is empty), and
    TINY Swin with live Hessian traces; a short evolution."""
    from p2vit_tpu_torch.tools import search_bench as sb

    name = "deit_tiny_patch16_224" if fam == "vit" else "swin_tiny_patch4_window7_224"
    cfg = (ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=12, num_heads=2)
           if fam == "vit" else STINY)
    monkeypatch.setattr(sb, "MODEL_ZOO", {name: cfg})
    monkeypatch.setattr(sb, "SWIN_ZOO", {name: cfg} if fam == "swin" else {})
    res = sb.run(name, 1, 4, torch.device("cpu"), n_hess=1, hess_batch=2, n_calib=4, pop_size=4, evo_iter=1)
    out = capsys.readouterr().out
    assert res["front"] > 0 and res["validations"] >= 5 and res["candidates_per_s"] > 0
    assert res["sim_img_per_s"] == pytest.approx(4 * res["candidates_per_s"])
    assert ("live Hessian traces" in out) == (fam == "swin") and "END-TO-END --mixed wall" in out
    assert 0 <= res["best_prec1"] <= 100


def test_search_bench_swin_entry_defaults(monkeypatch):
    from p2vit_tpu_torch.tools import search_bench as sb
    from p2vit_tpu_torch.tools import search_bench_swin as sbs

    seen = {}
    monkeypatch.setattr(sb, "run", lambda *a: seen.setdefault("a", a) and {})
    sbs.main(["--device", "cpu"])
    assert seen["a"][:3] == ("swin_tiny_patch4_window7_224", 2, 64) and seen["a"][4] == 2


def test_e2e_eval_smoke(monkeypatch, capsys, tmp_path, one_thread):
    """Disk to logits at TINY on the CPU: the folder written once, the
    loader line naming the route, the resident forward, the loop, a verdict."""
    pytest.importorskip("PIL")
    from p2vit_tpu_torch.tools import e2e_eval as ee

    monkeypatch.setattr(ee, "MODEL_ZOO", {"deit_small_patch16_224": VTINY})
    argv = ["--device", "cpu", "--batch", "4", "--imgs", "8", "--data", str(tmp_path)]
    res = ee.main(argv)
    out = capsys.readouterr().out
    assert "dataset: wrote 8 JPEGs" in out and f"loader={ee.loader_route()}" in out
    assert res["loader"] == ee.loader_route() and res["e2e_img_s"] > 0 and res["device_ms"] is None
    assert res["binding"] in ("host loader", "resident forward")
    assert ee.main(argv + ["--host-only"])["host_only"] is True
    assert "dataset: wrote" not in capsys.readouterr().out  # written once

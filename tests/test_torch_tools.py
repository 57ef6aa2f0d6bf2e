"""The two ported weight-store tools, run with ``--device cpu`` (the kernels'
plain versions) at the tiny shapes of tests/test_bench_tools_smoke.py,
depth 2: their lines and pins, and each tool's chain against the same
chain built from the JAX package's functions on the same numpy draws (the
Pallas kernels in interpret mode).
"""

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

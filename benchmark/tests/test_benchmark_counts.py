"""The yardstick's operation and byte counts against hand counts."""

import json

from benchmark import counts
from conftest import BENCH


def sizes(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())["sizes"]


def test_deit_b_products_per_image():
    # patch 196·768·768, per block qkv 197·768·2304 + proj 197·768² + fc1 and
    # fc2 2·197·768·3072 + attention 2·12·197²·64, head 768·1000
    blocks = 197 * 768 * 2304 + 197 * 768 * 768 + 2 * 197 * 768 * 3072 + 2 * 12 * 197 * 197 * 64
    macs = 196 * 768 * 768 + 12 * blocks + 768 * 1000
    assert counts.model_ops_per_image("vit", sizes("deit_b")) == 2 * macs
    assert round(macs / 1e9, 2) == 17.56


def test_swin_b_products_per_image():
    s = sizes("swin_b")
    macs = 3136 * 48 * 128  # the stem
    for i, depth in enumerate((2, 2, 18, 2)):
        c, tokens = 128 * 2 ** i, 3136 // 4 ** i
        n = 49
        macs += depth * (tokens * c * 3 * c + tokens * c * c + 2 * tokens * c * 4 * c + 2 * tokens * n * c)
        if i < 3:
            macs += tokens // 4 * 4 * c * 2 * c
    macs += 1024 * 1000
    assert counts.model_ops_per_image("swin", s) == 2 * macs


def test_layer_calls_at_batch():
    w = counts.work("vit", sizes("deit_b"), 256)
    m = 256 * 197
    assert len(w["qkv_attention"]) == 12 and len(w["requant_gemm"]) == 13
    ops, nbytes = w["qkv_attention"][0]
    assert ops == 2 * m * 768 * 2304 + 4 * 256 * 197 * 197 * 768
    assert nbytes == 2 * m * 768 + 2304 * 768 + 8 * 2304
    assert w["requant_gemm"][0] == (2 * m * 3072 * 768, m * 768 + 3072 * 768 + m * 3072 + 8 * 3072)
    sw = counts.work("swin", sizes("swin_b"), 2)
    assert len(sw["window_attention"]) == 24
    # qkv, proj, fc1 of 24 blocks, 3 plain fc2 before merging, 3 reductions, the head
    assert len(sw["requant_gemm"]) == 3 * 24 + 3 + 3 + 1


def test_least_seconds_takes_the_larger_bound():
    ops_bound = (int(1979e12), 1)
    byte_bound = (1, int(3.35e12))
    assert counts.least_seconds([ops_bound]) == 1.0
    assert counts.least_seconds([byte_bound]) == 1.0
    assert counts.least_seconds([ops_bound, byte_bound]) == 2.0

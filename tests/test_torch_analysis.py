"""The port's activation analysis (``p2vit_tpu_torch/analysis.py``), the
taps (``fp_forward(attn_tap=)`` is held in tests/test_torch_datafree.py;
``quant_forward(block_tap=)`` here) and ``synthetic_qstate``, against the
JAX package on the same numpy params and images at TINY ViT.

Tolerances: the float activations 1e-5 relative (float32 GEMMs and
reductions in another order); ``channel_ranges`` equal on the same array;
the block taps of the fake-quant simulation 1e-5 relative (codes on a PoT
grid times float scales; ``tests/test_torch_vit.py`` holds the logits at
the same bound); ``synthetic_qstate`` leaf for leaf equal; the serving
logits on it bit for bit against JAX's (``use_pallas=False``) and the
port's plain path.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import analysis as jan
from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import analysis as tan
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import vit as tvit

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TTINY = tcommon.ViTConfig(**dataclasses.asdict(TINY))
NAMES = ("attn_in", "qkv_out", "attn_scores", "attn_v", "proj_out", "mlp_in", "mlp_out")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def state():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(5).randn(3, 3, 32, 32).astype(np.float32)
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return dict(params=params, tp=tp, x=x)


@pytest.mark.parametrize("blocks", [None, [0, 1]])
def test_collect_activations_vs_jax(state, blocks):
    j = jan.collect_activations(state["params"], TINY, jnp.asarray(state["x"]), blocks=blocks)
    t = tan.collect_activations(state["tp"], TTINY, torch.from_numpy(state["x"]), blocks=blocks)
    want = [f"block{i}.{n}" for i in ([1] if blocks is None else blocks) for n in NAMES]
    assert list(t) == list(j) == want
    for k in t:
        assert t[k].shape == j[k].shape and rel(t[k], j[k]) < 1e-5, k


def test_channel_ranges(state):
    a = np.random.RandomState(6).randn(2, 5, 7).astype(np.float32)
    for got, want in zip(tan.channel_ranges(torch.from_numpy(a)), jan.channel_ranges(a)):
        np.testing.assert_array_equal(got, want)


def test_plot_distribution_writes_svgs(state, tmp_path):
    pytest.importorskip("matplotlib")
    acts = tan.collect_activations(state["tp"], TTINY, torch.from_numpy(state["x"]))
    paths = tan.plot_distribution(acts, "tiny", quant=True, outdir=str(tmp_path))
    assert len(paths) == 7 and all(os.path.exists(p) and p.endswith("_quant.svg") for p in paths)
    assert [os.path.basename(p) for p in paths] == [f"tiny_block1.{n}_quant.svg" for n in NAMES]


def test_plot_distribution_names_missing_matplotlib(state, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tan.plot_distribution({"a": torch.zeros(2, 3)}, "tiny", quant=False, outdir=str(tmp_path))


def test_synthetic_qstate_equals_jax():
    j = jax.tree.map(np.asarray, vit.synthetic_qstate(TINY))
    t = tvit.synthetic_qstate(TTINY, device="cpu")
    want = interop.qstate_from_numpy(j, device="cpu")
    jl, tl = jax.tree_util.tree_flatten_with_path(want)[0], jax.tree_util.tree_flatten_with_path(t)[0]
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (p, a), (_, b) in zip(jl, tl):
        assert a.dtype == b.dtype and torch.equal(a, b), p


def test_synthetic_qstate_serves(state):
    """A TINY W8 serving state from the synthetic state: the port's logits
    equal JAX's on JAX's synthetic state and the port's plain path."""
    bits = [8] * TINY.num_matmuls
    js = jserving.convert(state["params"], vit.synthetic_qstate(TINY), TINY, make_policy(), bits)
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(state["x"]), use_pallas=False))
    ts = tserving.convert(state["tp"], tvit.synthetic_qstate(TTINY, device="cpu"), TTINY, tmake_policy(), bits)
    x = torch.from_numpy(state["x"])
    t = tserving.serving_forward(ts, TTINY, x)
    assert bool(torch.isfinite(t).all())
    np.testing.assert_array_equal(t.numpy(), j)
    assert torch.equal(t, tserving.serving_forward(ts, TTINY, x, use_kernels=False))


def test_block_tap_vs_jax(state):
    """``quant_forward(block_tap=)``: one (B, N, C) tensor a block, the
    residual stream after qact4, as JAX's, W4A8, both on one calibrated
    state: the port's, given to JAX as arrays (the synthetic state's
    placeholder scales give NaN through the integer LN in both simulations;
    the port's calibration is held against JAX's in tests/test_torch_vit.py)."""
    bc = [4] * TINY.num_matmuls
    tq = tvit.calibrate(state["tp"], TTINY, tmake_policy(), torch.from_numpy(state["x"])).qstate
    jq = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tq)

    def jfwd(p, q, x, bi):
        taps = []
        return vit.quant_forward(p, q, TINY, make_policy(), x, bi, block_tap=taps), taps

    jl, jt = jax.jit(jfwd)(state["params"], jq, jnp.asarray(state["x"]), vit.bits_to_idx(bc))
    tt = []
    tl = tvit.quant_forward(state["tp"], tq, TTINY, tmake_policy(), torch.from_numpy(state["x"]),
                            tvit.bits_to_idx(bc), block_tap=tt)
    assert len(tt) == len(jt) == TINY.depth
    for a, b in zip(tt, jt):
        assert a.shape == b.shape and bool(torch.isfinite(a).all()) and rel(a, b) < 1e-5
    assert rel(tl, jl) < 1e-5

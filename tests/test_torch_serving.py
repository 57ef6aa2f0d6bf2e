"""The port's int8 serving path at TINY geometry: against the JAX serving
path on the same converted state (bit for bit), and against the port's own
fake-quant simulation inside the JAX package's envelope (rel < 0.05,
argmax equal, as ``tests/test_serving.py``)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.ops import launch_counts, reset_launch_counts

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TTINY = tcommon.ViTConfig(**dataclasses.asdict(TINY))
BITS = {"w8": [8], "w4": [4], "mixed": [4, 8]}


@pytest.fixture(scope="module")
def state():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(11).randn(4, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    return dict(params=params, calib=calib, tp=tp, tq=tq, x=x)


def _bit_config(name):
    n = TINY.num_matmuls
    return (BITS[name] * n)[:n]


@pytest.mark.parametrize("bits", list(BITS))
def test_serving_bitwise_vs_jax(state, bits):
    """The port's serving_forward and JAX's serving_forward(use_pallas=False)
    on the same converted state give identical logits: no LIS flip at any
    layer at this seed."""
    bc = _bit_config(bits)
    js = jserving.convert(state["params"], state["calib"].qstate, TINY, make_policy(), bc)
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(state["x"]), use_pallas=False))
    ts = tserving.convert(state["tp"], state["tq"], TTINY, tmake_policy(), bc)
    t = tserving.serving_forward(ts, TTINY, torch.from_numpy(state["x"]))
    assert t.dtype == torch.float32 and t.shape == (4, 16)
    np.testing.assert_array_equal(t.numpy(), j)
    # the weight codes convert() froze are the JAX package's too
    for blk_j, blk_t in zip(js["blocks"], ts["blocks"]):
        for layer in ("qkv", "proj", "mlp_fc1", "fc2"):
            np.testing.assert_array_equal(blk_t[layer]["w_q"].numpy(), np.asarray(blk_j[layer]["w_q"]))


@pytest.mark.parametrize("bits", list(BITS))
def test_serving_matches_port_simulation(state, bits):
    """Port serving against the port's quant_forward, on the port's own
    calibration: inside the JAX package's serving-vs-simulation envelope."""
    x = torch.from_numpy(state["x"])
    calib = tvit.calibrate(state["tp"], TTINY, tmake_policy(), x)
    bc = _bit_config(bits)
    sim = tvit.quant_forward(state["tp"], calib.qstate, TTINY, tmake_policy(), x,
                             tvit.bits_to_idx(bc)).numpy()
    ts = tserving.convert(state["tp"], calib.qstate, TTINY, tmake_policy(), bc)
    srv = tserving.serving_forward(ts, TTINY, x).numpy()
    rel = np.linalg.norm(srv - sim) / max(np.linalg.norm(sim), 1e-9)
    assert rel < 0.05, rel
    assert (sim.argmax(1) == srv.argmax(1)).all()


def test_kernel_and_plain_paths_agree_on_cpu(state):
    """On CPU tensors the kernel wrappers take their plain versions: the two
    paths agree and no kernel launch is counted."""
    ts = tserving.convert(state["tp"], state["tq"], TTINY, tmake_policy(), _bit_config("w4"))
    x = torch.from_numpy(state["x"])
    reset_launch_counts()
    a = tserving.serving_forward(ts, TTINY, x)
    b = tserving.serving_forward(ts, TTINY, x, use_kernels=False)
    assert torch.equal(a, b)
    assert set(launch_counts().values()) == {0}


def test_lis_off_plain_path_runs_and_stays_close_to_jax(state):
    """The LIS-off fp softmax: the port sums in float64 and rounds once, JAX
    in float32 in its own order with a float32 exp, so this is held to the
    statistical envelope (tests/test_torch_staged_lisoff.py counts the
    flipped codes)."""
    bc = _bit_config("w8")
    js = jserving.convert(state["params"], state["calib"].qstate, TINY, make_policy(), bc)
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(state["x"]), use_pallas=False,
                                            lis=False))
    ts = tserving.convert(state["tp"], state["tq"], TTINY, tmake_policy(), bc)
    t = tserving.serving_forward(ts, TTINY, torch.from_numpy(state["x"]), lis=False).numpy()
    assert np.isfinite(t).all()
    assert np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-9) < 0.05


def test_serving_rejects_unported_ingest(state):
    """uint8 needs ``attach_u8_ingest`` first (ValueError, as in JAX); other
    image types are not taken."""
    ts = tserving.convert(state["tp"], state["tq"], TTINY, tmake_policy(), _bit_config("w8"))
    with pytest.raises(ValueError, match="attach_u8_ingest"):
        tserving.serving_forward(ts, TTINY, torch.zeros(1, 3, 32, 32, dtype=torch.uint8))
    with pytest.raises(TypeError, match="float32 or uint8"):
        tserving.serving_forward(ts, TTINY, torch.zeros(1, 3, 32, 32, dtype=torch.float16))

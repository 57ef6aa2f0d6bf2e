"""``checkpoints.import_reference_state`` and ``import_reference_state_swin``
against the JAX package's, bit for bit, on one stand-in reference tree each.

The reference models are not in this repository, so
each test builds a stand-in: nested namespaces of torch tensors with the
reference's attribute names (``blocks``, ``layers``, each node's
``quantizer.scale`` / ``.zero_point``, a weight node's per-bit
``quantizer.dic_scale``, the SmoothQuant ``best_*`` lists), filled from the
port's seeded calibration of the TINY ViT and STINY Swin (the int8
``dic_scale`` entry a scalar, the others per channel, as the reference
stores them). Both packages' functions read the same tree; the JAX state
goes through ``interop.qstate_from_numpy`` and every leaf must equal the
port's, and ``flops`` and the zero ``global_distance`` too. Then the
imported states are served on the CPU: the port's ``serving_forward`` on
its import against JAX's jnp serving path on JAX's import, logits equal bit
for bit.
"""

import dataclasses
from types import SimpleNamespace as NS

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import checkpoints as jck
from p2vit_tpu import serving as jserving
from p2vit_tpu import serving_swin as jserving_swin
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import swin as jswin
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu_torch import checkpoints as tck
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch import serving_swin as tserving_swin
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models import vit as tvit

VTINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TVTINY = tcommon.ViTConfig(**dataclasses.asdict(VTINY))
STINY = jswin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                         num_heads=(2, 2), window_size=4)
TSTINY = tswin.SwinConfig(**dataclasses.asdict(STINY))
KEYS = ("uint3", "uint4", "int4", "int8")


def _act(node):
    return NS(quantizer=NS(scale=node["scale"].clone(), zero_point=node["zp"].clone()))


def _dic(rows):
    """A weight node: per-channel dic_scale rows, the int8 one a scalar."""
    return {k: (rows[i, :1].reshape(()) if k == "int8" else rows[i]).clone() for i, k in enumerate(KEYS)}


def _w(rows):
    return NS(quantizer=NS(dic_scale=_dic(rows)))


def _smooth(mod, **nodes):
    return NS(best_scale=[t.clone() for t in mod["channel_scale"]],
              best_act_scale=[t.reshape(1) for t in mod["qact0_scale"]],
              best_act_zp=[t.reshape(1) for t in mod["qact0_zp"]],
              best_weight_scale=[_dic(rows) for rows in mod["wscale"]], **nodes)


def vit_reference_tree(qs):
    """The reference VisionTransformer's quantizer state, as attributes."""
    blocks = []
    for b in qs["blocks"]:
        a, m = b["attn"], b["mlp"]
        attn = _smooth(a, qact1=_act(a["qact1"]), qact_attn1=_act(a["qact_attn1"]), qact2=_act(a["qact2"]),
                       proj=_w(a["proj_wscale"]), qact3=_act(a["qact3"]))
        mlp = _smooth(m, qact1=_act(m["qact1"]), fc2=_w(m["fc2_wscale"]), qact2=_act(m["qact2"]))
        blocks.append(NS(attn=attn, qact2=_act(b["qact2"]), mlp=mlp, qact4=_act(b["qact4"])))
    return NS(qact_input=_act(qs["qact_input"]),
              patch_embed=NS(proj=_w(qs["patch"]["wscale"]), qact=_act(qs["patch"]["qact"])),
              qact_embed=_act(qs["qact_embed"]), qact_pos=_act(qs["qact_pos"]), qact1=_act(qs["qact1"]),
              blocks=blocks, qact2=_act(qs["qact2"]), head=_w(qs["head_wscale"]), act_out=_act(qs["act_out"]))


def swin_reference_tree(qs):
    """The reference SwinTransformer's quantizer state, as attributes."""
    layers = []
    for st in qs["stages"]:
        blocks = []
        for b in st["blocks"]:
            a = b["attn"]
            attn = NS(qkv=_w(a["qkv_wscale"]), qact1=_act(a["qact1"]), qact_attn1=_act(a["qact_attn1"]),
                      qact_table=_act(a["qact_table"]), qact2=_act(a["qact2"]), qact3=_act(a["qact3"]),
                      proj=_w(a["proj_wscale"]), qact4=_act(a["qact4"]))
            mlp = NS(fc1=_w(b["fc1_wscale"]), qact1=_act(b["mlp_qact1"]), fc2=_w(b["fc2_wscale"]),
                     qact2=_act(b["mlp_qact2"]))
            blocks.append(NS(qact1=_act(b["qact1"]), attn=attn, qact2=_act(b["qact2"]), qact3=_act(b["qact3"]),
                             mlp=mlp, qact4=_act(b["qact4"])))
        ds = st.get("downsample")
        down = None if ds is None else NS(qact1=_act(ds["qact1"]), reduction=_w(ds["red_wscale"]),
                                          qact2=_act(ds["qact2"]))
        layers.append(NS(blocks=blocks, downsample=down))
    return NS(qact_input=_act(qs["qact_input"]),
              patch_embed=NS(proj=_w(qs["patch_wscale"]), qact_before_norm=_act(qs["patch_qact_bn"]),
                             qact=_act(qs["patch_qact"])),
              layers=layers, qact2=_act(qs["qact2"]), qact3=_act(qs["qact3"]), head=_w(qs["head_wscale"]),
              act_out=_act(qs["act_out"]))


def walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def assert_bitwise(got, want):
    g, w = list(walk(got)), list(walk(want))
    assert [p for p, _ in g] == [p for p, _ in w]
    for (p, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.shape == b.shape, p
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), p  # bits, signed zeros included


@pytest.fixture(scope="module")
def vit_case():
    x = np.random.RandomState(1).randn(4, 3, 32, 32).astype(np.float32)
    params = tvit.init_params(0, TVTINY, device="cpu")
    calib = tvit.calibrate(params, TVTINY, tmake_policy(), torch.from_numpy(x))
    return params, vit_reference_tree(calib.qstate), x


@pytest.fixture(scope="module")
def swin_case():
    x = np.random.RandomState(2).randn(4, 3, 32, 32).astype(np.float32)
    params = tswin.init_params(0, TSTINY, device="cpu")
    calib = tswin.calibrate(params, TSTINY, tmake_policy(), torch.from_numpy(x))
    return params, swin_reference_tree(calib.qstate), x


def test_import_reference_state_vs_jax(vit_case):
    _, tree, _ = vit_case
    t = tck.import_reference_state(tree, TVTINY, device="cpu")
    j = jck.import_reference_state(tree, VTINY)
    assert_bitwise(t.qstate, interop.qstate_from_numpy(jax.tree.map(np.asarray, j.qstate), device="cpu"))
    assert t.flops == list(j.flops)
    assert torch.equal(t.global_distance, torch.from_numpy(np.array(j.global_distance)))
    assert not t.global_distance.any()
    # the PTF masks re-derived from the scales; nothing aliases the tree
    m = t.qstate["qact1"]
    assert torch.equal(m["mask"], torch.round(m["scale"] / m["scale"].min()))
    assert m["scale"].data_ptr() != tree.qact1.quantizer.scale.data_ptr()


def test_import_reference_state_swin_vs_jax(swin_case):
    _, tree, _ = swin_case
    t = tck.import_reference_state_swin(tree, TSTINY, device="cpu")
    j = jck.import_reference_state_swin(tree, STINY)
    assert_bitwise(t.qstate, interop.qstate_from_numpy(jax.tree.map(np.asarray, j.qstate), device="cpu"))
    assert t.flops == list(j.flops) and t.global_distance.shape == (TSTINY.num_matmuls, 4)
    assert "downsample" in t.qstate["stages"][0] and "downsample" not in t.qstate["stages"][1]


def test_imported_vit_state_serves_as_jax(vit_case):
    """The imported state served on the CPU (W8): the port's serving path
    against JAX's jnp path on JAX's import of the same tree, bit for bit."""
    params, tree, x = vit_case
    bc = [8] * TVTINY.num_matmuls
    ts = tserving.convert(params, tck.import_reference_state(tree, TVTINY, device="cpu").qstate, TVTINY,
                          tmake_policy(), bc)
    t = tserving.serving_forward(ts, TVTINY, torch.from_numpy(x))
    jp = jax.tree.map(lambda a: jnp.asarray(a.numpy()), params)
    js = jserving.convert(jp, jck.import_reference_state(tree, VTINY).qstate, VTINY, make_policy(), bc)
    j = np.asarray(jserving.serving_forward(js, VTINY, jnp.asarray(x), use_pallas=False))
    assert bool(torch.isfinite(t).all())
    np.testing.assert_array_equal(t.numpy(), j)


def test_imported_swin_state_serves_as_jax(swin_case):
    params, tree, x = swin_case
    tq = tck.import_reference_state_swin(tree, TSTINY, device="cpu").qstate
    ts = tserving_swin.convert(params, tq, TSTINY, tmake_policy(), 8)
    t = tserving_swin.serving_forward(ts, tq, TSTINY, tmake_policy(), torch.from_numpy(x))
    jp = jax.tree.map(lambda a: None if a is None else jnp.asarray(a.numpy()), params,
                      is_leaf=lambda a: a is None)
    jq = jck.import_reference_state_swin(tree, STINY).qstate
    js = jserving_swin.convert(jp, jq, STINY, make_policy(), 8)
    j = np.asarray(jserving_swin.serving_forward(js, jq, STINY, make_policy(), jnp.asarray(x), use_pallas=False))
    assert bool(torch.isfinite(t).all())
    np.testing.assert_array_equal(t.numpy(), j)

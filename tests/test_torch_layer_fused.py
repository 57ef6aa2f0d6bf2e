"""The ViT ``fuse_layer`` serving path of the port against the JAX package,
on the same seeded numpy inputs: ``stack_layer_consts``, the plain version
of ``fused_vit_layer`` (against the Pallas kernel with ``interpret=True``),
``serving_forward(fuse_layer=True)``, the per-layer functions and the launch
counts.

Stated counts, measured on these inputs:
* TINY, LIS on: the plain version equals the JAX kernel bit for bit on both
  layers; LIS off: |Δcode| ≤ 1 on at most 0.1 % of the codes, the count
  stated per case (the fp32 softmax, tests/test_torch_staged_lisoff.py);
* DeiT-S width (N = 197, C = 384, 6 heads, hid 1536, 2 images, one layer
  of a seeded, calibrated W4 state), LIS on: 4 h' and 2 xc' codes of
  151,296 differ, each by 1, all in one token row. Traced: the JAX kernel
  equals its own four-kernel pipeline, whose every stage the port's plain
  versions reproduce except one fc1 GELU code, where XLA:CPU contracts the
  jitted erf polynomial into fused multiply-adds (ROADMAP.md §3; the eager
  JAX GELU gives the port's value); that code's row holds every output
  flip.
* ``serving_forward(fuse_layer=True)`` at TINY equals JAX's Pallas path
  (interpret) bit for bit with LIS on; LIS off rel < 0.05, argmax equal.
"""

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
from p2vit_tpu.ops.attention_lis import lis_attention_fused as j_attn
from p2vit_tpu.ops.layer_fused import fused_vit_layer as j_layer
from p2vit_tpu.ops.matmul_int8 import _gelu_exact as j_gelu
from p2vit_tpu.ops.matmul_int8 import int8_matmul_requant as j_mm
from p2vit_tpu.ops.matmul_ln import int8_matmul_res_ln as j_res_ln
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import VIT_ZOO
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.ops import (
    attention_lis, launch_counts, layer_fused, matmul_int8, matmul_ln, reset_launch_counts,
)

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
TTINY = tcommon.ViTConfig(**dataclasses.asdict(TINY))
BITS = {"w8": [8], "w4": [4], "mixed": [4, 8]}


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


def _bit_config(name):
    n = TINY.num_matmuls
    return (BITS[name] * n)[:n]


@pytest.fixture(scope="module")
def state():
    params = vit.init_params(jax.random.PRNGKey(3), TINY)
    x = np.random.RandomState(4).randn(3, 3, 32, 32).astype(np.float32)
    calib = vit.calibrate(params, TINY, make_policy(), jnp.asarray(x))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    return dict(params=params, calib=calib, tp=tp, tq=tq, x=x)


def _states(state, bits, policy=None):
    """(JAX state, port state) converted from the same calibration."""
    bc = _bit_config(bits)
    js = jserving.convert(state["params"], state["calib"].qstate, TINY, policy or make_policy(), bc)
    ts = tserving.convert(state["tp"], state["tq"], TTINY, tmake_policy(), bc)
    return js, ts


# ---------------------------------------------------------------------------
# (a) stack_layer_consts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits", list(BITS))
def test_stack_layer_consts_bitwise_vs_jax(state, bits):
    """The 29 depth-stacked entries, in order: the same dtype, shape and bytes."""
    js, ts = _states(state, bits)
    j = jserving.stack_layer_consts(js, TINY)
    t = tserving.stack_layer_consts(ts, TTINY)
    assert len(j) == len(t) == 29
    for i, (a, b) in enumerate(zip(j, t)):
        a = np.asarray(a)
        assert b.shape == a.shape and b.numpy().dtype == a.dtype, i
        assert b.numpy().tobytes() == a.tobytes(), i
    assert t[0].dtype == t[6].dtype == t[16].dtype == t[20].dtype == torch.int8


# ---------------------------------------------------------------------------
# (b) fused_vit_layer_plain against the JAX kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lis,stated", [(True, 0), (False, 0)])
def test_fused_vit_layer_plain_vs_jax_tiny(state, lis, stated):
    """Both TINY layers on the arguments the JAX serving path gives them
    (mixed bits), each layer fed the JAX kernel's previous output."""
    js, _ = _states(state, "mixed")
    h, xc = jserving.embed_codes(js, TINY, jnp.asarray(state["x"]), use_pallas=False)
    layers = jserving.stack_layer_consts(js, TINY)
    flips = 0
    for bi in range(TINY.depth):
        layer = [np.asarray(a[bi]) for a in layers]
        jh, jxc = j_layer(h, xc, *layer[:3], TINY.num_heads, *layer[3:], lis=lis, interpret=True)
        th, txc = layer_fused.fused_vit_layer_plain(T(h), T(xc), *map(T, layer[:3]), TINY.num_heads,
                                                    *map(T, layer[3:]), lis=lis)
        assert th.shape == txc.shape == h.shape and th.dtype == torch.int8
        assert len(np.unique(th.numpy())) > 20
        for j, t in ((jh, th), (jxc, txc)):
            d = np.abs(np.asarray(j).astype(np.int32) - t.numpy().astype(np.int32))
            assert d.max() <= 1 and (d != 0).mean() <= 1e-3
            flips += int((d != 0).sum())
        # the wrapper takes the plain version on CPU tensors
        wh, wxc = layer_fused.fused_vit_layer(T(h), T(xc), *map(T, layer[:3]), TINY.num_heads,
                                              *map(T, layer[3:]), lis=lis)
        assert torch.equal(wh, th) and torch.equal(wxc, txc)
        h, xc = jh, jxc
    assert flips == stated


@pytest.fixture(scope="module")
def deit_layer():
    """Layer 0's arguments at DeiT-S width: the port's seeded DeiT-S (depth
    2, biases and LN weights perturbed), calibrated on 2 images, converted
    at W4, and its embed codes."""
    cfg = dataclasses.replace(VIT_ZOO["deit_small_patch16_224"], depth=2, num_classes=10)
    params = tvit.init_params(0, cfg, device="cpu")
    rng = np.random.RandomState(7)

    def perturb(tree):
        for k, v in list(tree.items()):
            if isinstance(v, dict):
                perturb(v)
            elif isinstance(v, list):
                for e in v:
                    perturb(e)
            elif k == "b":
                tree[k] = v + T((rng.randn(*v.shape) * 0.02).astype(np.float32))

    perturb(params)
    for blk in params["blocks"]:
        for nm in ("norm1", "norm2"):
            blk[nm]["w"] = blk[nm]["w"] * T((1 + 0.2 * rng.randn(cfg.embed_dim)).astype(np.float32))
    x = T(np.random.RandomState(1).randn(2, 3, 224, 224).astype(np.float32))
    calib = tvit.calibrate(params, cfg, tmake_policy(), x)
    s = tserving.convert(params, calib.qstate, cfg, tmake_policy(), [4] * cfg.num_matmuls)
    h, xc = tserving.embed_codes(s, cfg, x)
    layer = [torch.as_tensor(v).numpy() for v in tserving.layer_consts(s, cfg, 0)]
    return cfg, h.numpy(), xc.numpy(), layer


def test_fused_vit_layer_plain_vs_jax_deit_width(deit_layer):
    """LIS on at DeiT-S width: the stated flips, traced (module docstring)."""
    cfg, h, xc, layer = deit_layer
    heads, c = cfg.num_heads, cfg.embed_dim
    (w_qkv, qr, qb, srq, sat, oro, w_proj, prr, prb, smid, sprev, sres1, ln2w, ln2b, ln2o, ln2r,
     w_fc1, f1r, f1b, f1inv, w_fc2, f2r, f2b, smid2, sres2, lnnw, lnnb, lnno, lnnr) = layer
    jh, jxc = map(np.asarray, j_layer(h, xc, *layer[:3], heads, *layer[3:], interpret=True))
    th, txc = layer_fused.fused_vit_layer_plain(T(h), T(xc), *map(T, layer[:3]), heads,
                                                *map(T, layer[3:]))
    assert len(np.unique(th.numpy())) > 150 and len(np.unique(txc.numpy())) > 150
    assert n_diff(jh, th) == 4 and n_diff(jxc, txc) == 2
    assert np.abs(jh.astype(np.int32) - th.numpy()).max() == 1
    # the JAX kernel equals its four-kernel pipeline (interpret) ...
    qkv = np.asarray(j_mm(h.reshape(-1, c), w_qkv, qr, qb, interpret=True))
    attn = np.asarray(j_attn(qkv.reshape(h.shape[0], -1, 3 * c), heads, srq, sat, oro, interpret=True))
    res1, mlp = map(np.asarray, j_res_ln(attn.reshape(-1, c), w_proj, prr, prb, xc.reshape(-1, c), smid,
                                         sprev, sres1, ln2w, ln2b, ln2o, ln2r, interpret=True))
    h1 = np.asarray(j_mm(mlp, w_fc1, f1r, f1b, out_inv=f1inv, gelu=True, interpret=True))
    res2, hn = map(np.asarray, j_res_ln(h1, w_fc2, f2r, f2b, res1, smid2, sres1, sres2, lnnw, lnnb,
                                        lnno, lnnr, interpret=True))
    assert n_diff(hn.reshape(jh.shape), jh) == 0 and n_diff(res2.reshape(jxc.shape), jxc) == 0
    # ... each stage of which the port's plain versions reproduce from the
    # same inputs, but for one fc1 code
    assert n_diff(qkv, matmul_int8.int8_matmul_requant_plain(T(h.reshape(-1, c)), T(w_qkv), T(qr),
                                                             T(qb))) == 0
    assert n_diff(attn, attention_lis.lis_attention_fused_plain(T(qkv.reshape(attn.shape[0], -1, 3 * c)),
                                                                heads, T(srq), T(sat), T(oro))) == 0
    t_res1, t_mlp = matmul_ln.int8_matmul_res_ln_plain(
        T(attn.reshape(-1, c)), T(w_proj), T(prr), T(prb), T(xc.reshape(-1, c)), T(smid), T(sprev),
        T(sres1), T(ln2w), T(ln2b), T(ln2o), T(ln2r))
    assert n_diff(res1, t_res1) == 0 and n_diff(mlp, t_mlp) == 0
    t_h1 = matmul_int8.int8_matmul_requant_plain(T(mlp), T(w_fc1), T(f1r), T(f1b), out_inv=T(f1inv),
                                                 gelu=True)
    assert n_diff(h1, t_h1) == 1
    t_res2, t_hn = matmul_ln.int8_matmul_res_ln_plain(T(h1), T(w_fc2), T(f2r), T(f2b), T(res1), T(smid2),
                                                      T(sres1), T(sres2), T(lnnw), T(lnnb), T(lnno),
                                                      T(lnnr))
    assert n_diff(res2, t_res2) == 0 and n_diff(hn, t_hn) == 0
    # the flipped GELU code: from the same pre-activation, the eager JAX
    # GELU gives the port's value; jitted, XLA:CPU contracts the erf
    # polynomial into fused multiply-adds and the value moves
    m, n = (int(i[0]) for i in np.nonzero(h1 != t_h1.numpy()))
    acc = mlp[m].astype(np.float64) @ w_fc1[n].astype(np.float64)
    y = jnp.float32(np.float32(np.float32(acc) * f1r[n]) + f1b[n])
    port = matmul_int8.gelu_as(torch.tensor(np.asarray(y))).numpy()
    assert np.asarray(j_gelu(y)) == port and np.asarray(jax.jit(j_gelu)(y)) != port
    # every output flip lies in that token row
    rows = {int(r) for a, b in ((jh, th), (jxc, txc)) for r in np.nonzero(
        np.asarray(a).reshape(-1, c) != b.numpy().reshape(-1, c))[0]}
    assert rows == {m}


# ---------------------------------------------------------------------------
# (c), (d), (e) serving_forward(fuse_layer=True)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lis", [True, False])
def test_serving_fuse_layer_vs_jax(state, lis):
    """Mixed bits at TINY against JAX's ``serving_forward(fuse_layer=True)``
    on its Pallas path (interpret): bit for bit with LIS on; LIS off rel <
    0.05 and argmax equal."""
    js, ts = _states(state, "mixed")
    x = state["x"]
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(x), use_pallas=True, interpret=True,
                                            lis=lis, fuse_layer=True))
    t = tserving.serving_forward(ts, TTINY, T(x), lis=lis, fuse_layer=True).numpy()
    assert t.shape == (3, 16) and np.isfinite(t).all()
    if lis:
        np.testing.assert_array_equal(t, j)
    else:
        assert np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-9) < 0.05
        assert (t.argmax(1) == j.argmax(1)).all()


@pytest.mark.parametrize("lis", [True, False])
@pytest.mark.parametrize("bits", list(BITS))
def test_fuse_layer_equals_default_and_staged(state, bits, lis):
    """On the CPU the fused-layer path equals the default and the staged
    paths bit for bit, on float32 and on uint8 images; the CPU wrappers
    count no launch."""
    _, ts = _states(state, bits)
    tserving.attach_u8_ingest(ts)
    x = T(state["x"])
    u8 = T(np.random.RandomState(9).randint(0, 256, (3, 3, 32, 32), dtype=np.uint8))
    for img in (x, u8):
        reset_launch_counts()
        got = tserving.serving_forward(ts, TTINY, img, lis=lis, fuse_layer=True)
        assert set(launch_counts().values()) == {0}
        assert torch.equal(got, tserving.serving_forward(ts, TTINY, img, lis=lis))
        assert torch.equal(got, tserving.serving_forward(ts, TTINY, img, lis=lis, fuse_embed=False,
                                                         fuse_qkv=False))
        assert torch.equal(got, tserving.serving_forward(ts, TTINY, img, lis=lis, fuse_layer=True,
                                                         use_kernels=False))
        # fuse_layer takes precedence over fuse_qkv
        assert torch.equal(got, tserving.serving_forward(ts, TTINY, img, lis=lis, fuse_layer=True,
                                                         fuse_qkv=False, fuse_embed=False))


def test_fuse_layer_dead_channel(state):
    """A dead channel (zero ``norm2_cs[0]``, so LN2's out-scale is 0 there):
    both paths floor the out-scale at 1e-30; the output stays finite and
    equals the four-kernel path, and JAX's fused-layer path too."""
    js, ts = _states(state, "w8")
    js["blocks"][0]["norm2_cs"] = js["blocks"][0]["norm2_cs"].at[0].set(0.0)
    sb = ts["blocks"][0]
    sb["norm2_cs"] = sb["norm2_cs"].clone()
    sb["norm2_cs"][0] = 0.0
    ts["consts"] = tserving.prepare(ts, TTINY)  # the default path's constants, formed again
    x = state["x"]
    got = tserving.serving_forward(ts, TTINY, T(x), fuse_layer=True)
    assert bool(torch.isfinite(got).all())
    assert torch.equal(got, tserving.serving_forward(ts, TTINY, T(x)))
    j = np.asarray(jserving.serving_forward(js, TINY, jnp.asarray(x), use_pallas=True, interpret=True,
                                            fuse_layer=True))
    np.testing.assert_array_equal(got.numpy(), j)


# ---------------------------------------------------------------------------
# (f) the per-layer functions over stacked slices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("runner", ["unfused_qkv_fused", "unfused_staged", "fused"])
def test_layer_functions_over_stacked_slices(state, runner):
    """``apply_unfused_layer`` / ``apply_fused_layer`` over the slices of
    ``stack_layer_consts`` equal the unrolled forward at the same flags."""
    _, ts = _states(state, "mixed")
    x = T(state["x"])
    layers = tserving.stack_layer_consts(ts, TTINY)
    h, xc = tserving.embed_codes(ts, TTINY, x)
    for bi in range(TTINY.depth):
        layer = tuple(a[bi] for a in layers)
        if runner == "fused":
            h, xc = tserving.apply_fused_layer(TTINY, layer, h, xc)
        else:
            h, xc = tserving.apply_unfused_layer(TTINY, layer, h, xc,
                                                 fuse_qkv=runner == "unfused_qkv_fused")
    flags = {"fused": dict(fuse_layer=True), "unfused_staged": dict(fuse_qkv=False),
             "unfused_qkv_fused": {}}[runner]
    assert torch.equal(tserving.head_logits(ts, h), tserving.serving_forward(ts, TTINY, x, **flags))


# ---------------------------------------------------------------------------
# (g) launch counts and the fit predicate
# ---------------------------------------------------------------------------


def test_launches_per_forward_fuse_layer():
    cfg = VIT_ZOO["deit_small_patch16_224"]
    assert tserving.launches_per_forward(cfg, fuse_layer=True) == {
        "fused_patch_embed": 1, "fused_vit_layer": 12, "int8_matmul_requant": 1}
    assert tserving.launches_per_forward(cfg, fuse_qkv=False, fuse_layer=True) == {
        "fused_patch_embed": 1, "fused_vit_layer": 12, "int8_matmul_requant": 1}
    assert tserving.launches_per_forward(cfg, fuse_embed=False, fuse_layer=True) == {
        "int_ln_requant": 1, "fused_vit_layer": 12, "int8_matmul_requant": 2}
    assert tserving.launches_per_forward(cfg) == {
        "fused_patch_embed": 1, "lis_attention_qkv_fused": 12, "int8_matmul_res_ln": 24,
        "int8_matmul_requant": 13}


@pytest.mark.parametrize("name,fits", [
    ("deit_tiny_patch16_224", True), ("deit_small_patch16_224", True),
    ("deit_base_patch16_224", False), ("vit_base_patch16_224", False),
    ("vit_large_patch16_224", False),
])
def test_check_fits_zoo(name, fits):
    """Which zoo models the CUDA kernel runs: DeiT-T and DeiT-S; the wider
    ones need more than an H100 block's shared memory."""
    cfg = VIT_ZOO[name]
    args = (cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.hidden_dim)
    if fits:
        layer_fused.check_fits(*args)
        assert layer_fused.smem_bytes(cfg.seq_len, cfg.embed_dim, cfg.hidden_dim) <= layer_fused.MAX_SMEM
    else:
        with pytest.raises(ValueError, match="shared memory.*fuse_layer=False"):
            layer_fused.check_fits(*args)
    assert layer_fused.smem_bytes(197, 384, 1536) == 229_992


@pytest.mark.parametrize("dims,why", [
    ((17, 992, 31, 4000), "multiples of 64"), ((300, 768, 12, 3072), "N = 300"),
    ((197, 96, 1, 384), "head_dim 96"), ((197, 992, 31, 520), "multiples of 64"),
])
def test_check_fits_rejects(dims, why):
    """A width whose padded tiles overflow shared memory (C = 992 runs at
    1024), too many tokens at DeiT-B width, a head_dim JAX's assert refuses,
    C = 992 with a ragged hidden width: ValueError naming the reason and
    fuse_layer=False. (TINY, N = 300 at DeiT-S width and ragged widths that
    fit are served since the kernel pads: tests/test_torch_shape_faults.py.)"""
    with pytest.raises(ValueError, match=f"{why}.*fuse_layer=False"):
        layer_fused.check_fits(*dims)

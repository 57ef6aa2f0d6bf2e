"""The ViT/DeiT zoo beyond DeiT-S, on the CPU: each member at full width and
depth 1, the port's plain serving path against the JAX package's
``serving_forward(use_pallas=False)``, and the port's own forwards against
``launches_per_forward`` and the kernels' launch plans.

* DeiT-T (C = 192, 3 heads), DeiT-B (768, 12) and ViT-L (1024, 16), LIS on,
  W4A8 ``[4]*num_matmuls``: JAX draws the seeded params and calibrates on 2
  seeded images (one calibration per member, in a module fixture); params
  and quant state cross to the port through ``interop``; both sides convert
  and serve the same 2 images. Weight codes and logits bit for bit.
* ViT-B's uint8 ingest at the vit family's mean = std = 0.5, LIS off: JAX
  calibrates (LIS off) on the same uint8 images normalized on the host,
  both sides attach the ingest constants and serve raw uint8 images. The
  ingest tables equal JAX's; the logit codes (logits / s_out, the head's
  int8 codes) lie within ±1 of JAX's, the LIS-off envelope of the JAX
  package's float32 softmax against the port's correctly rounded one
  (``tests/test_torch_staged_lisoff.py``); on these images 0 of 2,000
  differ.
* Every ViT member (DeiT-T/S/B, ViT-B/L) at depth 1, on a
  ``synthetic_qstate`` (the shapes of a calibrated state): one forward per
  serving flag set makes the plain calls ``launches_per_forward`` states,
  launching and building nothing; and every plan function accepts every
  call's shape, scaled to batches 1, 8 and 64, LIS on and off. The fused layer
  runs DeiT-T and DeiT-S and refuses the others (``check_fits``), as JAX's
  VMEM guard does.

Tolerance 0 but for ViT-B's LIS-off codes (±1, count stated).
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import VIT_ZOO as JVIT_ZOO
from p2vit_tpu.models import vit as jvit
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import PREPROCESS, VIT_ZOO
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.ops import (
    _lib, attention_lis, embed_fused, intln, launch_counts, layer_fused, matmul_int8, matmul_ln,
    reset_launch_counts,
)

MEMBERS = {"deit_tiny": "deit_tiny_patch16_224", "deit_small": "deit_small_patch16_224",
           "deit_base": "deit_base_patch16_224", "vit_base": "vit_base_patch16_224",
           "vit_large": "vit_large_patch16_224"}
FLAGS = {"default": {}, "staged": dict(fuse_embed=False, fuse_qkv=False), "layer": dict(fuse_layer=True)}
FUSED_LAYER_FITS = ("deit_tiny", "deit_small")  # check_fits and JAX's VMEM guard admit these only
SMS = 132  # the H100's SMs, as the plans take them on the card
BATCHES = (1, 8, 64)

# the kernels' plain versions, as the serving path looks them up
PLAIN = {"fused_patch_embed": (embed_fused, "fused_patch_embed_plain"),
         "lis_attention_qkv_fused": (attention_lis, "lis_attention_qkv_fused_plain"),
         "lis_attention_fused": (attention_lis, "lis_attention_fused_plain"),
         "int8_matmul_res_ln": (matmul_ln, "int8_matmul_res_ln_plain"),
         "int8_matmul_requant": (matmul_int8, "int8_matmul_requant_plain"),
         "int_ln_requant": (intln, "int_ln_requant_plain"),
         "fused_vit_layer": (layer_fused, "fused_vit_layer_plain")}


def _depth1(name):
    return dataclasses.replace(JVIT_ZOO[MEMBERS[name]], depth=1)


def _images(seed, n, size=224):
    return np.random.RandomState(seed).randn(n, 3, size, size).astype(np.float32)


def _u8_images(seed, n, size=224):
    return np.random.RandomState(seed).randint(0, 256, (n, 3, size, size)).astype(np.uint8)


def _host_normalize(u8, mean, std):
    mean = np.asarray(mean, np.float32).reshape(3, 1, 1)
    std = np.asarray(std, np.float32).reshape(3, 1, 1)
    return (u8.astype(np.float32) / np.float32(255.0) - mean) / std


def _to_port(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_member(name, lis=True, u8=None):
    """One JAX calibration of the member at depth 1, converted W4A8 on both
    sides and served on 2 images (uint8 with ``u8`` = (mean, std))."""
    cfg = _depth1(name)
    tcfg = tcommon.ViTConfig(**dataclasses.asdict(cfg))
    pol, tpol = make_policy(lis=lis), tmake_policy(lis=lis)
    params = jvit.init_params(jax.random.PRNGKey(0), cfg)
    if u8 is None:
        calib_x, x = _images(1, 2), _images(2, 2)
    else:
        calib_x, x = _host_normalize(_u8_images(1, 2), *u8), _u8_images(2, 2)
    calib = jvit.calibrate(params, cfg, pol, jnp.asarray(calib_x))
    bits = [4] * cfg.num_matmuls
    js = jserving.convert(params, calib.qstate, cfg, pol, bits)
    tp = interop.params_from_numpy(_to_port(params), device="cpu")
    tq = interop.qstate_from_numpy(_to_port(calib.qstate), device="cpu")
    ts = tserving.convert(tp, tq, tcfg, tpol, bits)
    if u8 is not None:
        js = jserving.attach_u8_ingest(js, *u8)
        tserving.attach_u8_ingest(ts, *u8)
    j = np.asarray(jserving.serving_forward(js, cfg, jnp.asarray(x), use_pallas=False, lis=lis))
    t = tserving.serving_forward(ts, tcfg, torch.from_numpy(x), use_kernels=False, lis=lis).numpy()
    return dict(cfg=cfg, js=js, ts=ts, j=j, t=t)


@pytest.fixture(scope="module")
def jax_members():
    """The members' JAX calibrations and both sides' logits, each computed
    once, on first use."""
    cache = {}

    def get(key):
        if key not in cache:
            if key == "vit_base_u8":
                pp = PREPROCESS["vit"]
                cache[key] = _jax_member("vit_base", lis=False, u8=(pp["mean"], pp["std"]))
            else:
                cache[key] = _jax_member(key)
        return cache[key]

    return get


@pytest.mark.parametrize("name", ["deit_tiny", "deit_base", "vit_large"])
def test_zoo_serving_bitwise_vs_jax(jax_members, name):
    """LIS on, W4A8, full width at depth 1: the weight codes ``convert``
    froze and 0 of 2,000 logits differ."""
    m = jax_members(name)
    for blk_j, blk_t in zip(m["js"]["blocks"], m["ts"]["blocks"]):
        for layer in ("qkv", "proj", "mlp_fc1", "fc2"):
            np.testing.assert_array_equal(blk_t[layer]["w_q"].numpy(), np.asarray(blk_j[layer]["w_q"]))
    assert m["t"].shape == m["j"].shape == (2, m["cfg"].num_classes)
    assert np.isfinite(m["t"]).all()
    assert int((m["t"] != m["j"]).sum()) == 0


def test_vit_base_u8_ingest_lisoff_vs_jax(jax_members):
    """ViT-B, LIS off, uint8 images at mean = std = 0.5: the ingest tables
    equal JAX's, ``u8_ingest_exact`` holds for the literal form, and the
    logit codes lie within ±1 of JAX's: 0 of 2,000 differ on these images."""
    m = jax_members("vit_base_u8")
    for key in ("mean", "std", "a", "b", "lut"):
        np.testing.assert_array_equal(m["ts"]["u8"][key].numpy(), np.asarray(m["js"]["u8"][key]), err_msg=key)
    assert tserving.u8_ingest_exact(m["ts"])
    s_out = float(m["ts"]["s_out"])
    d = np.abs(m["t"].astype(np.float64) - m["j"].astype(np.float64)) / s_out
    assert np.isfinite(m["t"]).all() and np.array_equal(d, np.round(d))
    assert d.max() <= 1
    assert int((d != 0).sum()) == 0


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's forwards here run at full width: one intra-op thread, so
    that the suite's parallel workers do not oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _capture(run):
    """Run ``run()`` with every plain version wrapped; returns the calls
    made from outside another plain version: [(kernel, bound arguments)]."""
    calls, depth = [], [0]
    with pytest.MonkeyPatch.context() as mp:
        for kernel, (mod, pname) in PLAIN.items():
            fn = getattr(mod, pname)
            sig = inspect.signature(fn)

            def rec(*a, _fn=fn, _k=kernel, _sig=sig, **kw):
                if depth[0] == 0:
                    bound = _sig.bind(*a, **kw)
                    bound.apply_defaults()
                    calls.append((_k, bound.arguments))
                depth[0] += 1
                try:
                    return _fn(*a, **kw)
                finally:
                    depth[0] -= 1

            mp.setattr(mod, pname, rec)
        run()
    return calls


@pytest.fixture(scope="module")
def captures():
    """One forward at batch 1 per member (depth 1, ``synthetic_qstate``) and
    flag set through the wrappers (CPU tensors: their plain versions):
    (config, the plain calls, the launch counters after it), each computed
    once."""
    cache, states = {}, {}

    def get(name, flags):
        if name not in states:
            cfg = dataclasses.replace(VIT_ZOO[MEMBERS[name]], depth=1)
            params = tvit.init_params(0, cfg, device="cpu")
            states[name] = cfg, tserving.convert(params, tvit.synthetic_qstate(cfg, device="cpu"), cfg,
                                                 tmake_policy(), [4] * cfg.num_matmuls)
        if (name, flags) not in cache:
            cfg, s = states[name]
            x = torch.from_numpy(_images(3, 1))
            reset_launch_counts()
            calls = _capture(lambda: tserving.serving_forward(s, cfg, x, **FLAGS[flags]))
            cache[(name, flags)] = cfg, calls, launch_counts()
        return cache[(name, flags)]

    return get


def _pad(v, m):
    return -(-v // m) * m


def _plan(kernel, a, b, lis):
    """The launch plan of one batch-1 call's kernel at batch ``b`` (and
    ``lis`` for the attention kernels); raises where the kernel does not
    take the shape."""
    if kernel == "int8_matmul_requant":
        (m, k), n = a["x_q"].shape, a["w_q"].shape[0]
        return matmul_int8.requant_plan(m * b, n, _pad(k, 32), SMS, bool(a["gelu"]))
    if kernel == "int8_matmul_res_ln":
        (m, k), n = a["x_q"].shape, a["w_q"].shape[0]
        return matmul_ln.res_ln_plan(m * b, n, k, SMS)
    if kernel == "fused_patch_embed":
        (_, n_patch, k), c = a["patches"].shape, a["w_q"].shape[0]
        return embed_fused.embed_plan(b * n_patch, c, k, SMS)
    if kernel == "lis_attention_qkv_fused":
        (_, n, c_in), c3 = a["h_q"].shape, a["w_q"].shape[0]
        dk = attention_lis.qkv_kernel_hd(c3 // 3 // a["num_heads"])
        return attention_lis.qkv_cluster_plan(n, _pad(c_in, 16), dk)
    if kernel == "lis_attention_fused":
        _, n, c3 = a["qkv_q"].shape
        return attention_lis.vit_attention_plan(n, c3 // 3 // a["num_heads"], lis)
    if kernel == "int_ln_requant":
        m, c = a["codes"].shape
        return intln.ln_plan(m * b, c)
    if kernel == "fused_vit_layer":
        (_, n, c), hid = a["h_q"].shape, a["w_fc1"].shape[0]
        layer_fused.check_fits(n, c, a["num_heads"], hid)
        return layer_fused.layer_plan(b, n, c, a["num_heads"], hid, lis, SMS)
    raise AssertionError(kernel)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("name", list(MEMBERS))
def test_zoo_plain_calls_equal_launches_per_forward(captures, name, flags):
    """One forward at batch 1 through the wrappers makes the plain calls
    ``launches_per_forward`` states, launching and building nothing;
    ``fuse_layer`` at a member the fused layer does not fit raises naming
    ``fuse_layer=False``."""
    if flags == "layer" and name not in FUSED_LAYER_FITS:
        cfg = VIT_ZOO[MEMBERS[name]]
        with pytest.raises(ValueError, match="fuse_layer=False"):
            layer_fused.check_fits(cfg.seq_len, cfg.embed_dim, cfg.num_heads, cfg.hidden_dim)
        return
    cfg, calls, launched = captures(name, flags)
    got = {}
    for kernel, _ in calls:
        got[kernel] = got.get(kernel, 0) + 1
    assert got == tserving.launches_per_forward(cfg, **FLAGS[flags])
    assert set(launched.values()) == {0}
    assert _lib.library.cache_info().currsize == 0


@pytest.mark.parametrize("name", list(MEMBERS))
def test_zoo_plans_accept_every_shape(captures, name):
    """Every kernel call of the member's serving paths (each flag set the
    kernels take), scaled from batch 1 to batches 1, 8 and 64, LIS on and
    off, has a launch plan: no kernel refuses a zoo shape."""
    calls = [c for flags in FLAGS if flags != "layer" or name in FUSED_LAYER_FITS
             for c in captures(name, flags)[1]]
    assert {k for k, _ in calls} == set(PLAIN) - ({"fused_vit_layer"} if name not in FUSED_LAYER_FITS else set())
    for kernel, a in calls:
        for b in BATCHES:
            for lis in (True, False):
                assert _plan(kernel, a, b, lis) is not None

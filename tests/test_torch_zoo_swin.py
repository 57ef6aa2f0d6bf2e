"""The Swin zoo on the CPU: Swin-B's widths against the JAX package, and
Swin-T, Swin-S and Swin-B against ``launches_per_forward`` and the kernels'
launch plans.

* Swin-B's widths (C = 128, heads 4/8/16/32, every stage and merge) at depths
  (1, 1, 1, 1), W4 ``convert(4)``: JAX draws the seeded params and
  calibrates on 2 seeded images (one calibration, in a module fixture);
  params and quant state cross to the port through ``interop``; the port's
  plain ``serving_forward`` against JAX's ``serving_forward(use_pallas=
  False)`` on the same 2 images: 0 of 2,000 logits differ. Marked ``slow``:
  JAX compiles Swin-B's calibration, convert and forward for ~40 s on the
  CPU (full depth: ``tests/test_torch_fullsize_parity.py``).
* Swin-T, Swin-S and Swin-B at depths (2, 2, 2, 2) (a shifted block in every
  stage that has more than one window), on a synthetic quant state of the
  member's widths (power-of-two scales, unit PTF masks: the shapes of a
  calibrated state): one forward per serving flag set makes the plain calls
  ``launches_per_forward`` states, launching and building nothing; and every
  plan function accepts every call's shape, scaled to batches 1, 8 and 64,
  LIS on and off.
"""

import dataclasses
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving_swin as jss
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import SWIN_ZOO as JSWIN_ZOO
from p2vit_tpu.models import swin as jswin
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving_swin as tss
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import SWIN_ZOO
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.ops import (
    _lib, attention_lis, intln, launch_counts, matmul_int8, matmul_ln, reset_launch_counts, swin_stem,
)

MEMBERS = {"swin_tiny": "swin_tiny_patch4_window7_224", "swin_small": "swin_small_patch4_window7_224",
           "swin_base": "swin_base_patch4_window7_224"}
FLAGS = {"default": {}, "fold": dict(fold_windows=True), "stem": dict(fuse_stem=True),
         "int_stem_unfused": dict(int_stem=True, fuse_res=False)}
DEPTHS = (2, 2, 2, 2)
SMS = 132  # the H100's SMs, as the plans take them on the card
BATCHES = (1, 8, 64)

# the kernels' plain versions, as the serving path looks them up
PLAIN = {"swin_lis_attention": (attention_lis, "swin_lis_attention_plain"),
         "swin_lis_attention_folded": (attention_lis, "swin_lis_attention_folded_plain"),
         "int_ln_requant": (intln, "int_ln_requant_plain"),
         "int_res_ln_requant": (intln, "int_res_ln_requant_plain"),
         "int8_matmul_res_ln": (matmul_ln, "int8_matmul_res_ln_plain"),
         "int8_matmul_requant": (matmul_int8, "int8_matmul_requant_plain"),
         "fused_swin_stem": (swin_stem, "fused_swin_stem_plain")}


def _images(seed, n, size=224):
    return np.random.RandomState(seed).randn(n, 3, size, size).astype(np.float32)


@pytest.mark.slow
def test_swin_b_widths_serving_bitwise_vs_jax():
    """Swin-B's widths at depths (1, 1, 1, 1), W4: 0 of 2,000 logits differ."""
    cfg = dataclasses.replace(JSWIN_ZOO["swin_base_patch4_window7_224"], depths=(1, 1, 1, 1))
    tcfg = tswin.SwinConfig(**dataclasses.asdict(cfg))
    policy, tpolicy = make_policy(), tmake_policy()
    params = jswin.init_params(jax.random.PRNGKey(0), cfg)
    calib = jswin.calibrate(params, cfg, policy, jnp.asarray(_images(1, 2)))
    x = _images(2, 2)
    js = jss.convert(params, calib.qstate, cfg, policy, 4)
    j = np.asarray(jss.serving_forward(js, calib.qstate, cfg, policy, jnp.asarray(x), use_pallas=False))
    tp = interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    tq = interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu")
    t = tss.serving_forward(tss.convert(tp, tq, tcfg, tpolicy, 4), tq, tcfg, tpolicy, torch.from_numpy(x),
                            use_kernels=False).numpy()
    assert t.shape == j.shape == (2, cfg.num_classes) and np.isfinite(t).all()
    assert int((t != j).sum()) == 0


def synthetic_qstate(cfg) -> dict:
    """A Swin quant state of ``cfg``'s widths with power-of-two placeholder
    scales (0.125 for activations, 0.0625 for weights) and unit PTF masks:
    serving from it runs a calibrated state's shapes and kernels."""
    def act(chan=None):
        s = torch.full((chan,) if chan else (), 0.125)
        d = {"scale": s, "zp": torch.zeros(())}
        if chan:
            d["mask"] = torch.ones(chan)
        return d

    def wdic(o):
        return torch.full((4, o), 0.0625)

    stages = []
    for i, depth in enumerate(cfg.depths):
        c = cfg.embed_dim * 2 ** i
        blocks = [{"qact1": act(), "attn": {"qkv_wscale": wdic(3 * c), "qact1": act(), "qact_attn1": act(),
                                             "qact_table": act(), "qact2": act(), "qact3": act(),
                                             "proj_wscale": wdic(c), "qact4": act()},
                   "qact2": act(c), "qact3": act(), "fc1_wscale": wdic(4 * c), "mlp_qact1": act(),
                   "fc2_wscale": wdic(c), "mlp_qact2": act(c), "qact4": act(c)} for _ in range(depth)]
        stage = {"blocks": blocks}
        if i + 1 < len(cfg.depths):
            stage["downsample"] = {"qact1": act(), "red_wscale": wdic(2 * c), "qact2": act(2 * c)}
        stages.append(stage)
    return {"qact_input": act(), "patch_wscale": wdic(cfg.embed_dim), "patch_qact_bn": act(),
            "patch_qact": act(), "stages": stages, "qact2": act(), "qact3": act(),
            "head_wscale": wdic(cfg.num_classes), "act_out": act()}


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
    """One forward at batch 1 per member (depths ``DEPTHS``, ``synthetic_
    qstate``) and flag set through the wrappers (CPU tensors: their plain
    versions): (config, the plain calls, the launch counters after it), each
    computed once a configuration (Swin-T's and Swin-S's are one at these
    depths)."""
    cache, states = {}, {}

    def get(name, flags):
        cfg = dataclasses.replace(SWIN_ZOO[MEMBERS[name]], depths=DEPTHS)
        if cfg not in states:
            q = synthetic_qstate(cfg)
            states[cfg] = q, tss.convert(tswin.init_params(0, cfg, device="cpu"), q, cfg, tmake_policy(), 4)
        if (cfg, flags) not in cache:
            q, s = states[cfg]
            x = torch.from_numpy(_images(3, 1))
            reset_launch_counts()
            calls = _capture(lambda: tss.serving_forward(s, q, cfg, tmake_policy(), x, **FLAGS[flags]))
            cache[(cfg, flags)] = cfg, calls, launch_counts()
        return cache[(cfg, flags)]

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
    if kernel in ("int_ln_requant", "int_res_ln_requant"):
        m, c = a["codes" if kernel == "int_ln_requant" else "a_q"].shape
        return intln.ln_plan(m * b, c, kernel == "int_res_ln_requant")
    if kernel == "fused_swin_stem":
        (m, k), c = a["patches"].shape, a["w"].shape[0]
        return swin_stem.stem_plan(m * b, k, c)
    heads = a["num_heads"]
    if kernel == "swin_lis_attention":
        w, n, c3 = a["qkv_q"].shape
        nw = a["n_windows"] if a["mask"] is not None else 1
        return attention_lis.swin_attention_plan(w * b, nw, heads, n, SMS, lis=lis,
                                                 hd=attention_lis.swin_kernel_hd(c3 // 3 // heads))
    if kernel == "swin_lis_attention_folded":
        _, res, _, c3 = a["qkv_r"].shape
        g2 = (res // a["window"]) ** 2
        return attention_lis.swin_attention_plan(b * g2, g2, heads, a["window"] ** 2, SMS, lis=lis,
                                                 hd=attention_lis.swin_kernel_hd(c3 // 3 // heads))
    raise AssertionError(kernel)


@pytest.mark.parametrize("flags", list(FLAGS))
@pytest.mark.parametrize("name", list(MEMBERS))
def test_zoo_plain_calls_equal_launches_per_forward(captures, name, flags):
    """One forward at batch 1 through the wrappers makes the plain calls
    ``launches_per_forward`` states, launching and building nothing."""
    cfg, calls, launched = captures(name, flags)
    got = {}
    for kernel, _ in calls:
        got[kernel] = got.get(kernel, 0) + 1
    assert got == tss.launches_per_forward(cfg, **FLAGS[flags])
    assert set(launched.values()) == {0}
    assert _lib.library.cache_info().currsize == 0


@pytest.mark.parametrize("name", list(MEMBERS))
def test_zoo_plans_accept_every_shape(captures, name):
    """Every kernel call of the member's serving paths (each flag set),
    scaled from batch 1 to batches 1, 8 and 64, LIS on and off, has a launch
    plan: no kernel refuses a zoo shape."""
    calls = [c for flags in FLAGS for c in captures(name, flags)[1]]
    assert {k for k, _ in calls} == set(PLAIN)
    assert any(a["mask"] is not None for k, a in calls if k.startswith("swin_lis"))
    for kernel, a in calls:
        for b in BATCHES:
            for lis in (True, False):
                assert _plan(kernel, a, b, lis) is not None

"""The port's CLI (``python -m p2vit_tpu_torch.cli``) against the JAX CLI
(the repo-root ``test_quant.py``) and the JAX package's functions.

* ``build_parser``: the same destinations, defaults and choices but
  ``--device``; ``accuracy`` and ``AverageMeter`` equal JAX's; each flag
  whose module is not ported (``--plot``, ``--mode 2``, the parallel
  flags) exits 2 with one line naming ROADMAP.md.
* The flags of the rest of calibration and the search, against the JAX
  CLI's flow (``test_quant.py:304-350, 549-608``) through JAX's functions:
  ``--calib-iter 2`` with each ``--quant-method`` (statistics over the
  first shuffled batch, the solve on the second; decisions bit for bit,
  float scales within 1e-6 relative); ``--mode 1`` (the port's seeded
  noise, through JAX's calibration too); ``--mixed`` with
  ``MEAN_HESSIAN["deit_tiny"]`` at deit_tiny's 50 slots and TINY width
  over one shared calibration (the printed front and the best configs
  equal JAX's search over JAX's simulation); ``--live-hessian`` with
  ``--hessian-batches`` 1 and 2 (the CLI's sensitivities equal the
  module's functions on the same batches and generators; the front equals
  JAX's ``pareto_front`` on them).
* The CLI's own steps (``load_model`` from a ``--checkpoint`` ``.pth`` of
  the JAX package's seeded params, ``calibrate_or_load``,
  ``build_model_fn``, ``validate``) at TINY ViT and TINY Swin size on a
  synthetic PIL folder, against the same flow through JAX's functions
  (``data.iterate_batches`` → ``calibrate`` → the forward the flags select
  → ``accuracy``), for ``--quant``, ``--quant --serve``, ``--quant --serve
  --u8-ingest``, ``--quant --serve-weight-only`` and no ``--quant``:
  calibration decisions equal (PTF base scales, floats of fp activations
  summed in another order, within 1e-6 relative as in
  ``tests/test_torch_vit.py``), Prec@1 and Prec@5 equal, and logits:
  - ``--serve`` on JAX's quant state, written in the port's file format and
    read with ``--load-quant-state``: bit for bit JAX's serving logits;
  - ``--serve`` on each package's own calibration: bit for bit (measured);
  - ``--quant`` (the simulation): within 1e-5 relative, argmax equal;
  - no ``--quant``: rtol 1e-5, atol 1e-6 (``tests/test_torch_vit.py``);
  - ``--serve-weight-only``: bf16 forwards of PyTorch and XLA on the
    CPU, within 2e-2 relative (bf16 keeps 8 bits; measured below 1e-2),
    argmax equal.
* The quant-state file: the save → load round trip, its leaves against the
  file JAX's ``save_quant_state`` writes for the same calibration, serving
  logits after a load equal to those before it.
* A subprocess smoke of the module entry point, ``--device`` defaulting to
  the card, and an import guard: every module of ``p2vit_tpu_torch``
  imports with ``jax`` and ``p2vit_tpu`` blocked.
* ``slow``: both CLIs end to end as subprocesses at deit_tiny and
  swin_tiny size, which run full-size calibrations on the CPU.
"""

import contextlib
import dataclasses
import importlib.util
import json
import os
import random
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from p2vit_tpu import checkpoints as jck
from p2vit_tpu import data as jdata
from p2vit_tpu import serving as jserving
from p2vit_tpu import search as jsearch
from p2vit_tpu import serving_swin as jserving_swin
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import PREPROCESS, swin, vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu.profiling import AverageMeter as JAverageMeter
from p2vit_tpu_torch import checkpoints as tck
from p2vit_tpu_torch import cli as tcli
from p2vit_tpu_torch import interop
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.profiling import AverageMeter

ROOT = Path(__file__).resolve().parents[1]
VTINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
STINY = swin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 2), window_size=4)
FAMILIES = {
    "vit": dict(model="deit_tiny", cfg=VTINY, tcfg=tcommon.ViTConfig(**dataclasses.asdict(VTINY)),
                jmod=vit, tmod=tvit, seed=3),
    "swin": dict(model="swin_tiny", cfg=STINY, tcfg=tswin.SwinConfig(**dataclasses.asdict(STINY)),
                 jmod=swin, tmod=tswin, seed=4),
}
FLAG_SETS = {"quant": ["--quant"], "serve": ["--quant", "--serve"],
             "serve_u8": ["--quant", "--serve", "--u8-ingest"],
             "weight_only": ["--quant", "--serve-weight-only"], "fp": []}
BATCH = ["--calib-batchsize", "4", "--val-batchsize", "3"]


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jcli = _load(ROOT / "test_quant.py", "jax_test_quant")  # the JAX CLI
# the state-dict layouts the checkpoint tests build
state_dicts = _load(Path(__file__).with_name("test_torch_checkpoints.py"), "torch_checkpoint_layouts")


# ---------------------------------------------------------------------------
# Parser, accuracy, unported flags
# ---------------------------------------------------------------------------


def test_parser_matches_jax_cli():
    def spec(p):
        return {a.dest: (a.default, a.choices, type(a).__name__, a.nargs, a.type) for a in p._actions}

    t, j = spec(tcli.build_parser()), spec(jcli.build_parser())
    assert sorted(t) == sorted(j)
    for dest in t:
        if dest == "device":
            continue
        assert t[dest][:4] == j[dest][:4], dest
        assert (t[dest][4] is None) == (j[dest][4] is None), dest
    assert t["device"][0] == "cuda"
    assert tcli.MODEL_CHOICES == jcli.MODEL_CHOICES and tcli.FULL_NAME == jcli.FULL_NAME
    for v in ("True", "no", "1", "off", "Y"):
        assert tcli.str2bool(v) == jcli.str2bool(v)
    args = tcli.build_parser().parse_args(["deit_small", "d", "--ptf", "false", "--lis", "0"])
    assert (args.ptf, args.lis, args.device) == (False, False, "cuda")


def test_accuracy_and_average_meter_match_jax():
    rng = np.random.RandomState(0)
    logits, target = rng.randn(37, 10).astype(np.float32), rng.randint(0, 10, 37)
    assert tcli.accuracy(logits, target, topk=(1, 5)) == jcli.accuracy(logits, target, topk=(1, 5))
    t, j = AverageMeter(), JAverageMeter()
    for v, n in ((50.0, 4), (25.0, 4), (100.0, 1)):
        t.update(v, n)
        j.update(v, n)
        assert (t.val, t.sum, t.count, t.avg) == (j.val, j.sum, j.count, j.avg)


@pytest.mark.parametrize("extra,item", [
    (["--plot"], "item 5"), (["--mode", "2"], "item 5"),
    (["--dp", "2"], "item 6"), (["--tp", "2"], "item 6"), (["--sp"], "item 6"), (["--pp", "2"], "item 6"),
    (["--pp-micro", "4"], "item 6"),
])
def test_unported_flags_exit_2(capsys, extra, item):
    with pytest.raises(SystemExit) as e:
        tcli.main(["deit_tiny", "/nonexistent", "--quant", "--device", "cpu", *extra])
    assert e.value.code == 2
    out = capsys.readouterr()
    lines = out.err.strip().splitlines()
    assert len(lines) == 1 and "ROADMAP.md" in lines[0] and f"queue 1 {item}" in lines[0]
    assert extra[0] in lines[0] and out.out == ""


def test_device_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tcli.main(["deit_tiny", str(tmp_path), "--quant", "--random-init"])


# ---------------------------------------------------------------------------
# The CLI's steps at TINY size, against the JAX flow
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    """train/ (3 classes × 4) and val/ (3 × 2: two batches of 3) of seeded
    JPEGs and PNGs, 30-70 pixels a side."""
    root = tmp_path_factory.mktemp("imagefolder")
    rng = np.random.RandomState(7)
    for split, per in (("train", (4, 4, 4)), ("val", (2, 2, 2))):
        for cls, n in zip(("c0", "c1", "c2"), per):
            d = root / split / cls
            d.mkdir(parents=True)
            for i in range(n):
                h, w = rng.randint(30, 70, 2)
                img = Image.fromarray(rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
                img.save(d / f"{i}.{'jpg' if i % 2 else 'png'}")
    return str(root)


@pytest.fixture(scope="module")
def models(folder, tmp_path_factory):
    """Per family: the JAX package's seeded params and a ``.pth`` of them,
    JAX's calibration on the first shuffled train batch, and the port's
    (through its CLI steps, saving its quant state)."""
    out = {}
    tmp = tmp_path_factory.mktemp("states")
    for fam, f in FAMILIES.items():
        params = f["jmod"].init_params(jax.random.PRNGKey(f["seed"]), f["cfg"])
        pth = str(tmp / f"{fam}.pth")
        npp = jax.tree.map(np.asarray, params)
        layout = state_dicts.vit_state_dict if fam == "vit" else state_dicts.swin_state_dict
        torch.save(layout(npp, f["cfg"]), pth)
        pp = PREPROCESS[f["model"].split("_")[0]]
        train = jdata.ImageFolder(f"{folder}/train", jdata.build_transform(
            f["cfg"].img_size, pp["mean"], pp["std"], pp["crop_pct"]))
        cal = next(jdata.iterate_batches(train, 4, shuffle=True, seed=0, drop_last=True))[0]
        jc = f["jmod"].calibrate(params, f["cfg"], make_policy(), jnp.asarray(cal))

        qpath = str(tmp / f"{fam}_port.npz")
        args = _args(fam, folder, ["--quant", "--checkpoint", pth, "--save-quant-state", qpath])
        tparams = tcli.load_model(args, f["tcfg"], f["tmod"], "cpu")
        tc = tcli.calibrate_or_load(args, f["tcfg"], f["tmod"], tparams, tmake_policy(), "cpu")
        # JAX's calibration in the port's file format, for --load-quant-state
        jq = str(tmp / f"{fam}_jax.npz")
        result = tvit.CalibResult if fam == "vit" else tswin.SwinCalibResult
        tck.save_quant_state(jq, result(
            qstate=interop.qstate_from_numpy(jax.tree.map(np.asarray, jc.qstate), device="cpu"),
            flops=list(jc.flops), global_distance=torch.from_numpy(np.array(jc.global_distance))))
        out[fam] = dict(params=params, pth=pth, jc=jc, cal=cal, tparams=tparams, tc=tc, qpath=qpath,
                        jq=jq, jpath=str(tmp / f"{fam}_jaxfile.npz"))
    return out


def _args(fam, folder, flags):
    return tcli.build_parser().parse_args([FAMILIES[fam]["model"], folder, "--device", "cpu", *BATCH, *flags])


def _port_run(fam, folder, m, flags, load=None):
    """The port CLI's steps; returns (per-batch logits, prec1, prec5)."""
    f = FAMILIES[fam]
    args = _args(fam, folder, flags + ["--checkpoint", m["pth"]] + (["--load-quant-state", load] if load else []))
    policy = tmake_policy(args.ptf, args.lis, args.quant_method)
    params = tcli.load_model(args, f["tcfg"], f["tmod"], "cpu")
    calib = None
    if args.quant:
        calib = tcli.calibrate_or_load(args, f["tcfg"], f["tmod"], params, policy, "cpu") if load else m["tc"]
    u8 = args.u8_ingest and args.quant and args.serve
    val = tcli.make_dataset(args, f["tcfg"], "val", raw=u8)
    model_fn = tcli.build_model_fn(args, f["tcfg"], f["tmod"], params, calib, policy, u8)
    logits = []
    p1, p5 = tcli.validate(args, val, model_fn, [4] * f["cfg"].num_matmuls, "cpu",
                           on_batch=lambda i, imgs, t, lg, *_: logits.append(lg))
    return logits, p1, p5


def _jax_run(fam, folder, m, flags, qstate):
    """The same flow through the JAX package's functions (the JAX CLI's
    ``main`` on the CPU: ``use_pallas=False``)."""
    f = FAMILIES[fam]
    cfg, jmod, params = f["cfg"], f["jmod"], m["params"]
    policy = make_policy()
    pp = PREPROCESS[f["model"].split("_")[0]]
    bits = [4] * cfg.num_matmuls
    quant, serve, u8, wo = "--quant" in flags, "--serve" in flags, "--u8-ingest" in flags, \
        "--serve-weight-only" in flags
    # jitted as the JAX CLI jits them (a runtime params argument, one trace per batch shape)
    if quant and wo:
        srv = jserving_swin if fam == "swin" else jserving
        pw = jax.tree.map(lambda a: a.astype(jnp.bfloat16) if a.dtype == jnp.float32 else a,
                          srv.weight_only_params(params, qstate, cfg, policy, bits))
        jfwd = jax.jit(lambda p, x: jmod.fp_forward(p, cfg, x.astype(jnp.bfloat16)).astype(jnp.float32))
        fwd = lambda x: jfwd(pw, x)  # noqa: E731
    elif quant and serve:
        if fam == "swin":
            s = jserving_swin.convert(params, qstate, cfg, policy, bits)
            if u8:
                jserving_swin.attach_u8_ingest(s, pp["mean"], pp["std"])
            fwd = lambda x: jserving_swin.serving_forward(s, qstate, cfg, policy, x, use_pallas=False)  # noqa: E731
        else:
            s = jserving.convert(params, qstate, cfg, policy, bits)
            if u8:
                jserving.attach_u8_ingest(s, pp["mean"], pp["std"])
            fwd = lambda x: jserving.serving_forward(s, cfg, x, use_pallas=False,  # noqa: E731
                                                     lis=policy.int_softmax)
    elif quant:
        idx = vit.bits_to_idx(bits)
        if fam == "swin":
            jfwd = jax.jit(lambda p, q, x, bi: swin.quant_forward_mixed(p, q, cfg, policy, x, bi))
        else:
            jfwd = jax.jit(lambda p, q, x, bi: vit.quant_forward(p, q, cfg, policy, x, bi))
        fwd = lambda x: jfwd(params, qstate, x, idx)  # noqa: E731
    else:
        jfwd = jax.jit(lambda p, x: jmod.fp_forward(p, cfg, x))
        fwd = lambda x: jfwd(params, x)  # noqa: E731
    val = jdata.ImageFolder(f"{folder}/val", jdata.build_transform(
        cfg.img_size, pp["mean"], pp["std"], pp["crop_pct"], raw=quant and serve and u8))
    top1, top5, logits = JAverageMeter(), JAverageMeter(), []
    for imgs, targets in jdata.iterate_batches(val, 3, prefetch=2):
        lg = np.asarray(fwd(jnp.asarray(imgs)))
        logits.append(lg)
        p1, p5 = jcli.accuracy(lg, targets, topk=(1, 5))
        top1.update(p1, len(targets))
        top5.update(p5, len(targets))
    return logits, top1.avg, top5.avg


def _leaves(tree):
    return jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, tree))[0]


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_cli_calibration_decisions_equal_jax(folder, models, fam):
    """The port CLI's calibration (load_model from the .pth, the first
    shuffled full train batch) takes JAX's decisions."""
    m = models[fam]
    jl = _leaves(m["jc"].qstate)
    tl = _leaves(jax.tree.map(lambda t: t.numpy(), m["tc"].qstate))
    assert len(jl) == len(tl) > 70
    for (pa, a), (pb, b) in zip(jl, tl):
        key = jax.tree_util.keystr(pa)
        assert key == jax.tree_util.keystr(pb) and a.shape == b.shape, key
        if key.endswith("['scale']") and a.ndim == 1 and "qact0" not in key:
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)
    np.testing.assert_allclose(m["tc"].global_distance.numpy(), np.asarray(m["jc"].global_distance), rtol=1e-5)
    assert m["tc"].flops == list(m["jc"].flops)


@pytest.mark.parametrize("flags", list(FLAG_SETS))
@pytest.mark.parametrize("fam", list(FAMILIES))
def test_cli_flow_matches_jax(folder, models, fam, flags):
    m = models[fam]
    fl = FLAG_SETS[flags]
    t_logits, t1, t5 = _port_run(fam, folder, m, fl)
    j_logits, j1, j5 = _jax_run(fam, folder, m, fl, m["jc"].qstate)
    assert [lg.shape[0] for lg in t_logits] == [lg.shape[0] for lg in j_logits] == [3, 3]
    assert (t1, t5) == (j1, j5)
    t, j = np.concatenate(t_logits), np.concatenate(j_logits)
    assert t.dtype == np.float32 and np.isfinite(t).all()
    rel = np.linalg.norm(t - j) / max(np.linalg.norm(j), 1e-9)
    if flags.startswith("serve"):
        np.testing.assert_array_equal(t, j)
        # JAX's own quant state read through --load-quant-state: bit for bit
        l_logits, l1, l5 = _port_run(fam, folder, m, fl, load=m["jq"])
        np.testing.assert_array_equal(np.concatenate(l_logits), j)
        assert (l1, l5) == (j1, j5)
    elif flags == "quant":
        assert rel < 1e-5, rel
    elif flags == "fp":
        np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    else:
        assert rel < 2e-2, rel
    assert (t.argmax(1) == j.argmax(1)).all()


# ---------------------------------------------------------------------------
# --calib-iter, --quant-method, --mode 1, --mixed, --live-hessian
# ---------------------------------------------------------------------------

FLOAT_METHODS = ("ema", "percentile", "omse")
V12 = dataclasses.replace(VTINY, depth=12)  # deit_tiny's 50 matmul slots at TINY width


@contextlib.contextmanager
def _torch_threads(n):
    old = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(old)


@pytest.fixture
def one_thread():
    """The search and Hessian cases run thousands of small PyTorch ops: on
    one thread, as the entry-point smoke, since a thread per core beside
    the other test workers multiplied their time by 10-60."""
    with _torch_threads(1):
        yield


def _assert_decisions_equal(jq, tq, method):
    """Decisions (PoT exponents, masks, zero points, channel and weight
    scales) bit for bit; the floats of fp activations within 1e-6 relative:
    PTF base scales, and every activation scale of the float observers."""
    jl, tl = _leaves(jq), _leaves(jax.tree.map(lambda t: t.numpy(), tq))
    assert len(jl) == len(tl) > 60
    for (pa, a), (pb, b) in zip(jl, tl):
        key = jax.tree_util.keystr(pa)
        assert key == jax.tree_util.keystr(pb) and a.shape == b.shape, key
        is_scale = key.endswith("['scale']") or key.endswith("['qact0_scale']")
        if is_scale and (method in FLOAT_METHODS or (a.ndim == 1 and "qact0" not in key)):
            np.testing.assert_allclose(b, a, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(b, a, err_msg=key)


@pytest.mark.parametrize("fam,method", [("vit", "minmax"), ("vit", "ema"), ("vit", "percentile"),
                                        ("vit", "omse"), ("swin", "percentile")])
def test_calib_iter_2_decisions_equal_jax(folder, models, capsys, fam, method):
    """``--calib-iter 2 --quant-method <method>`` through the port CLI's
    ``calibrate_or_load``, against the JAX CLI's flow: the first two
    shuffled full train batches, ``collect_stats`` on the first,
    ``calibrate(stats=)`` on the second."""
    f, m = FAMILIES[fam], models[fam]
    args = _args(fam, folder, ["--quant", "--checkpoint", m["pth"], "--calib-iter", "2", "--quant-method", method])
    tc = tcli.calibrate_or_load(args, f["tcfg"], f["tmod"], m["tparams"], tmake_policy(quant_method=method), "cpu")
    assert capsys.readouterr().out == "Calibrating with real data...\n  stats batch 1/2\n"
    pp = PREPROCESS[f["model"].split("_")[0]]
    train = jdata.ImageFolder(f"{folder}/train", jdata.build_transform(
        f["cfg"].img_size, pp["mean"], pp["std"], pp["crop_pct"]))
    it = jdata.iterate_batches(train, 4, shuffle=True, seed=0, drop_last=True)
    first, second = next(it)[0], next(it)[0]
    policy = make_policy(quant_method=method)
    stats = f["jmod"].collect_stats(m["params"], f["cfg"], policy, jnp.asarray(first))
    jc = f["jmod"].calibrate(m["params"], f["cfg"], policy, jnp.asarray(second), stats=stats)
    _assert_decisions_equal(jc.qstate, tc.qstate, method)
    np.testing.assert_allclose(tc.global_distance.numpy(), np.asarray(jc.global_distance), rtol=1e-5)


def test_mode_1_calibrates_on_seeded_noise(folder, models, capsys):
    """``--mode 1``: the port's noise is ``torch.randn`` from a generator
    seeded by ``--seed`` (JAX's CLI draws with jax.random); JAX's calibration
    of the same noise takes the same decisions."""
    f, m = FAMILIES["vit"], models["vit"]
    args = _args("vit", folder, ["--quant", "--checkpoint", m["pth"], "--mode", "1", "--seed", "5"])
    tc = tcli.calibrate_or_load(args, f["tcfg"], f["tmod"], m["tparams"], tmake_policy(), "cpu")
    assert capsys.readouterr().out == "Calibrating with Gaussian noise...\n"
    noise = torch.randn((4, 3, 32, 32), generator=torch.Generator().manual_seed(5))
    own = tvit.calibrate(m["tparams"], f["tcfg"], tmake_policy(), noise)
    for (_, a), (_, b) in zip(_leaves(jax.tree.map(lambda t: t.numpy(), own.qstate)),
                              _leaves(jax.tree.map(lambda t: t.numpy(), tc.qstate))):
        np.testing.assert_array_equal(b, a)
    jc = vit.calibrate(m["params"], f["cfg"], make_policy(), jnp.asarray(noise.numpy()))
    _assert_decisions_equal(jc.qstate, tc.qstate, "minmax")


@pytest.fixture(scope="module")
def deep(folder, tmp_path_factory):
    """deit_tiny's slot layout at TINY width: JAX's seeded params, a .pth of
    them, and the port CLI's calibration of them, saved: the shared quant
    state of both searches."""
    tmp = tmp_path_factory.mktemp("deep")
    params = vit.init_params(jax.random.PRNGKey(8), V12)
    pth, q = str(tmp / "deep.pth"), str(tmp / "deep.npz")
    torch.save(state_dicts.vit_state_dict(jax.tree.map(np.asarray, params), V12), pth)
    tcfg = tcommon.ViTConfig(**dataclasses.asdict(V12))
    args = tcli.build_parser().parse_args(["deit_tiny", folder, "--device", "cpu", *BATCH, "--quant",
                                           "--checkpoint", pth, "--save-quant-state", q])
    with _torch_threads(1):
        tcli.calibrate_or_load(args, tcfg, tvit, tcli.load_model(args, tcfg, tvit, "cpu"), tmake_policy(), "cpu")
    return dict(params=params, pth=pth, q=q, tcfg=tcfg, calib=tck.load_quant_state(q, device="cpu"))


SEARCH_LINES = ("Pareto Frontier", "Hessian-Based", "Start Evolutionary", "Best mixed", "[", "{")


def test_mixed_front_and_best_configs_equal_jax(folder, deep, one_thread, capsys, monkeypatch):
    """``main`` with ``--quant --mixed`` (MEAN_HESSIAN["deit_tiny"]) on the
    shared state, against JAX's ``pareto_front`` and ``evolutionary_search``
    with the same seed, validating with JAX's jitted simulation on the same
    val batches: the same printed front, configs validated and best configs
    with their Prec@1."""
    from p2vit_tpu.hessian_tables import MEAN_HESSIAN
    from p2vit_tpu_torch import models as tmodels

    monkeypatch.setitem(tmodels.MODEL_ZOO, tcli.FULL_NAME["deit_tiny"], deep["tcfg"])
    tcli.main(["deit_tiny", folder, "--device", "cpu", *BATCH, "--quant", "--mixed", "--checkpoint", deep["pth"],
               "--load-quant-state", deep["q"], "--print-freq", "1000"])
    got = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith(SEARCH_LINES)]

    calib, policy = deep["calib"], make_policy()
    qstate = jax.tree.map(lambda t: jnp.asarray(t.numpy()), calib.qstate)
    fwd = jax.jit(lambda p, q, x, bi: vit.quant_forward(p, q, V12, policy, x, bi))
    pp = PREPROCESS["deit"]
    val = jdata.ImageFolder(f"{folder}/val", jdata.build_transform(32, pp["mean"], pp["std"], pp["crop_pct"]))
    batches = list(jdata.iterate_batches(val, 3))
    seen = []

    def validate(bits):
        top1, top5 = JAverageMeter(), JAverageMeter()
        for imgs, targets in batches:
            lg = np.asarray(fwd(deep["params"], qstate, jnp.asarray(imgs), vit.bits_to_idx(bits)))
            p1, p5 = jcli.accuracy(lg, targets, topk=(1, 5))
            top1.update(p1, len(targets))
            top5.update(p5, len(targets))
        seen.append(list(bits))
        return top1.avg, top5.avg

    rng = random.Random(0)
    front = jsearch.pareto_front(calib.flops, np.asarray(calib.global_distance), MEAN_HESSIAN["deit_tiny"], rng)
    for bits, _ in front[:5]:
        validate(bits)
    result = jsearch.evolutionary_search(lambda bc: validate(bc)[0], [c for c, _ in front], calib.flops, rng)
    want = (["Pareto Frontier.......", "Hessian-Based Validating..."] + [str(c) for c, _ in front[:5]]
            + ["Start Evolutionary.......", "Best mixed-precision configs:"]
            + [json.dumps({"bit_config": c, "prec1": p}) for c, p in result[:5]])
    assert len(front) > 5 and len(seen) > 25
    assert got == want


@pytest.mark.parametrize("n_batches", [1, 2])
def test_live_hessian_sensitivities_and_front(folder, deep, one_thread, capsys, n_batches):
    """``--live-hessian --hessian-batches N``: the CLI's sensitivities equal
    ``normalized_mean_hessian`` of ``hessian_traces`` on the same batches
    (shuffled with --seed + 1) and generators (--seed + i); the CLI's front
    on them equals JAX's ``pareto_front`` on the shared calibration."""
    from p2vit_tpu_torch import data as tdata
    from p2vit_tpu_torch import hessian as th

    args = tcli.build_parser().parse_args(["deit_tiny", folder, "--device", "cpu", *BATCH, "--quant", "--mixed",
                                           "--live-hessian", "--hessian-batches", str(n_batches),
                                           "--checkpoint", deep["pth"]])
    tp = tcli.load_model(args, deep["tcfg"], tvit, "cpu")
    mh = tcli.sensitivities(args, deep["tcfg"], tp, "cpu")
    assert "Calculating sensitivities via the averaged Hessian trace...\n" in capsys.readouterr().out
    train = tcli.make_dataset(args, deep["tcfg"], "train")
    traces = [th.hessian_traces(tp, deep["tcfg"], torch.from_numpy(imgs), torch.from_numpy(targets),
                                torch.Generator().manual_seed(i))
              for i, (imgs, targets) in zip(range(n_batches), tdata.iterate_batches(
                  train, 4, shuffle=True, seed=1, drop_last=True))]
    assert len(mh) == 49 and mh == th.normalized_mean_hessian(traces)
    front, pop = tcli.mixed_search(args, deep["tcfg"], False, deep["calib"], mh, lambda bits: (0.0, 0.0))
    assert front == jsearch.pareto_front(deep["calib"].flops, deep["calib"].global_distance.numpy(), mh,
                                         random.Random(0))
    assert 0 < len(pop) <= 25


def test_mixed_needs_quant_and_a_table(folder, deep, monkeypatch):
    from p2vit_tpu_torch import models as tmodels

    monkeypatch.setitem(tmodels.MODEL_ZOO, tcli.FULL_NAME["deit_tiny"], deep["tcfg"])
    with pytest.raises(SystemExit, match="--mixed requires --quant"):
        tcli.main(["deit_tiny", folder, "--device", "cpu", *BATCH, "--mixed", "--random-init"])
    args = tcli.build_parser().parse_args(["deit_small", folder, "--device", "cpu", "--quant", "--mixed"])
    with pytest.raises(SystemExit, match="no hardcoded Hessian table for deit_small; use --live-hessian"):
        tcli.sensitivities(args, deep["tcfg"], None, "cpu")


# ---------------------------------------------------------------------------
# The quant-state file
# ---------------------------------------------------------------------------


def _walk(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _walk(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_quant_state_round_trip(models, fam):
    """The file ``--save-quant-state`` wrote, read back onto the CPU: the
    family's result type, every leaf, flops and distances equal."""
    c = models[fam]["tc"]
    back = tck.load_quant_state(models[fam]["qpath"], device="cpu")
    assert type(back) is type(c) is (tvit.CalibResult if fam == "vit" else tswin.SwinCalibResult)
    assert back.flops == c.flops and torch.equal(back.global_distance, c.global_distance)
    got, want = list(_walk(back.qstate)), list(_walk(c.qstate))
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.device.type == "cpu" and a.dtype == b.dtype and torch.equal(a, b), p
    if not torch.cuda.is_available():  # the default device is the card
        with pytest.raises(RuntimeError, match="CUDA"):
            tck.load_quant_state(models[fam]["qpath"])


def _jax_key(path) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_quant_state_leaves_equal_jax_file(models, fam):
    """The port's file of JAX's calibration and the file JAX's
    ``save_quant_state`` writes for it hold the same leaves under the same
    paths (JAX's side read back and flattened with jax.tree_util)."""
    m = models[fam]
    jck.save_quant_state(m["jpath"], m["jc"])
    jr = jck.load_quant_state(m["jpath"])
    jleaves = jax.tree_util.tree_flatten_with_path(
        {"qstate": jr.qstate, "flops": jnp.asarray(jr.flops), "global_distance": jr.global_distance})[0]
    with np.load(m["jq"]) as fh:
        tfile = {k: fh[k] for k in fh.files}
    assert str(tfile.pop("family")) == fam
    assert sorted(tfile) == sorted(_jax_key(p) for p, _ in jleaves)
    for p, leaf in jleaves:
        key, want = _jax_key(p), np.asarray(leaf)
        got = tfile[key].astype(want.dtype) if key == "flops" else tfile[key]
        assert got.dtype == want.dtype and got.shape == want.shape, key
        np.testing.assert_array_equal(got, want, err_msg=key)


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_serving_logits_survive_a_reload(folder, models, fam):
    m = models[fam]
    before, *_ = _port_run(fam, folder, m, FLAG_SETS["serve"])
    after, *_ = _port_run(fam, folder, m, FLAG_SETS["serve"], load=m["qpath"])
    for a, b in zip(before, after):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# Entry point, import guard
# ---------------------------------------------------------------------------


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


PREC = re.compile(r"^ \* Prec@1 ([0-9.]+) Prec@5 ([0-9.]+)$", re.M)


def test_module_entry_point_smoke(folder):
    """deit_tiny at full size on one thread (~7 s alone). With a thread
    per core, beside the other test workers, it once passed 300 s."""
    env = _env()
    env["OMP_NUM_THREADS"] = env["MKL_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, "-m", "p2vit_tpu_torch.cli", "deit_tiny", folder, "--quant", "--serve",
                        "--device", "cpu", "--random-init", "--limit-val", "1", "--calib-batchsize", "2",
                        "--val-batchsize", "2"], capture_output=True, text=True, cwd=ROOT, env=env,
                       timeout=900)
    assert r.returncode == 0, r.stderr[-2000:]
    assert len(PREC.findall(r.stdout)) == 1 and "Test: [0]" in r.stdout


GUARD = r"""
import importlib, importlib.abc, pkgutil, sys

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "p2vit_tpu"):
            raise ImportError(f"blocked: {name}")
        return None

sys.meta_path.insert(0, Block())
import p2vit_tpu_torch
names = ["p2vit_tpu_torch"] + [m.name for m in pkgutil.walk_packages(p2vit_tpu_torch.__path__, "p2vit_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "p2vit_tpu"))
assert not bad, bad
print(len(names), " ".join(sorted(names)))
"""


def test_port_imports_neither_jax_nor_the_jax_package():
    r = subprocess.run([sys.executable, "-c", GUARD], capture_output=True, text=True, cwd=ROOT, env=_env(),
                       timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    names = set(r.stdout.split()[1:])
    for mod in ("cli", "data", "checkpoints", "native", "interop", "serving", "serving_swin", "profiling",
                "ops.attention_lis", "models.vit", "models.swin"):
        assert f"p2vit_tpu_torch.{mod}" in names, mod


# ---------------------------------------------------------------------------
# Both CLIs end to end (slow: full-size calibrations on the CPU)
# ---------------------------------------------------------------------------


@pytest.mark.slow
@pytest.mark.parametrize("serve", [False, True])
@pytest.mark.parametrize("model", ["deit_tiny", "swin_tiny"])
def test_both_clis_end_to_end(folder, tmp_path, model, serve):
    """``JAX_PLATFORMS=cpu python test_quant.py`` against ``python -m
    p2vit_tpu_torch.cli --device cpu`` on one folder and one ``.pth`` of the
    JAX package's seeded full-size params: equal Prec lines, and saved quant
    states with equal leaves (PTF base scales within 1e-6 relative)."""
    from p2vit_tpu.models import MODEL_ZOO

    name = jcli.FULL_NAME[model]
    cfg = MODEL_ZOO[name]
    jmod = swin if model.startswith("swin") else vit
    params = jax.tree.map(np.asarray, jmod.init_params(jax.random.PRNGKey(0), cfg))
    pth = str(tmp_path / "w.pth")
    layout = state_dicts.swin_state_dict if model.startswith("swin") else state_dicts.vit_state_dict
    torch.save(layout(params, cfg), pth)
    common = [model, folder, "--quant", "--checkpoint", pth, "--limit-val", "1", *BATCH] + \
        (["--serve"] if serve else [])
    env = _env()
    env["JAX_PLATFORMS"] = "cpu"
    jq, tq = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    rj = subprocess.run([sys.executable, "test_quant.py", *common, "--save-quant-state", jq],
                        capture_output=True, text=True, cwd=ROOT, env=env, timeout=1800)
    rt = subprocess.run([sys.executable, "-m", "p2vit_tpu_torch.cli", *common, "--device", "cpu",
                         "--save-quant-state", tq], capture_output=True, text=True, cwd=ROOT, env=env,
                        timeout=1800)
    assert rj.returncode == 0, rj.stderr[-2000:]
    assert rt.returncode == 0, rt.stderr[-2000:]
    assert PREC.findall(rt.stdout) == PREC.findall(rj.stdout) and len(PREC.findall(rt.stdout)) == 1
    jr = jck.load_quant_state(jq)
    jleaves = dict((_jax_key(p), np.asarray(v)) for p, v in jax.tree_util.tree_flatten_with_path(
        {"qstate": jr.qstate, "global_distance": jr.global_distance})[0])
    with np.load(tq) as fh:
        tfile = {k: fh[k] for k in fh.files if k not in ("family", "flops")}
    assert sorted(tfile) == sorted(jleaves)
    for key, want in jleaves.items():
        if key == "global_distance":
            np.testing.assert_allclose(tfile[key], want, rtol=1e-5)
        elif key.endswith("/scale") and want.ndim == 1 and "qact0" not in key:
            np.testing.assert_allclose(tfile[key], want, rtol=1e-6, err_msg=key)
        else:
            np.testing.assert_array_equal(tfile[key], want, err_msg=key)

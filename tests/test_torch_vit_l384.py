"""ViT-L/16 at 384 (``vit_large_patch16_384``, 577 tokens) on the CPU.

* At N = 577 (384² images, patch 16) and a small width (C 64, one head of
  64, depth 2), on the benchmark's seeded weights and calibration images:
  the port's plain serving path (``use_kernels=False``) against the
  benchmark's plain reference (``benchmark/reference/vit.py``), 0 codes
  differ and the logit gap is 0.0; and against the JAX package's op-by-op
  forward (``jax.disable_jit``) on the port's calibration, built from JAX's
  own ``ViTConfig`` at the same sizes, 0 logits differ.
* The zoo entry's sizes are the benchmark configuration's; the CLI name
  ``vit_large_384`` resolves to timm's 384 preprocessing (mean = std = 0.5,
  ``crop_pct`` 1.0) and every other name keeps its family's.
* ``counts.work`` gives 382.13 GOP an image.
* A recorded default forward at N = 577 puts ``cluster`` = 10 (the
  qkv-fused kernel's non-portable cluster) on each
  ``op.lis_attention_qkv_fused`` span; off the card there is no
  ``resident_clusters``. Neither ``convert`` nor a forward that is not
  recorded reads the launch facts.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmark import counts, harness
from benchmark import weights as W
from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy as jmake_policy
from p2vit_tpu.models import common as jcommon
from p2vit_tpu_torch import cli, profiling, serving
from p2vit_tpu_torch.config import make_policy
from p2vit_tpu_torch.models import MODEL_ZOO, PREPROCESS, VIT_ZOO, preprocess, vit
from p2vit_tpu_torch.ops import attention_lis

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark" / "configs" / "vit_l384.json").read_text())
SMALL = {"embed_dim": 64, "num_heads": 1, "depth": 2, "num_classes": 10}  # N = 577 stays: img 384, patch 16
SEED = 2 ** 31 + 4321


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _recorder_off():
    profiling.disable()
    profiling.drain()
    yield
    profiling.disable()
    profiling.drain()


def small_config() -> dict:
    cfg = json.loads(json.dumps(CONFIG))
    cfg["sizes"].update(SMALL)
    cfg["quant"]["calib_batchsize"] = 4
    return cfg


@pytest.fixture(scope="module")
def served():
    """The port at the harness's entries on the seed's weights (``Program``:
    calibrate, convert, uint8 ingest), 3 request images, the port's plain
    logits, and the plain reference's on its own draw of the same seed."""
    cfg = small_config()
    dev = torch.device("cpu")
    gen, params, cal_x = harness.make_inputs(cfg, SEED, dev)
    x = W.images(gen, 3, cfg["sizes"]["img_size"], dev)
    prog = harness.family(cfg).Program(cfg, params, cal_x)
    plain = serving.serving_forward(prog.s, prog.cfg, x, use_kernels=False)
    _, params, cal_x = harness.make_inputs(cfg, SEED, dev)
    ref = harness.family(cfg).reference(cfg, params, cal_x)(x)
    return {"cfg": cfg, "prog": prog, "x": x, "plain": plain, "ref": ref}


def test_small_width_keeps_577_tokens(served):
    tcfg = served["prog"].cfg
    assert (tcfg.seq_len, tcfg.embed_dim, tcfg.head_dim, tcfg.depth) == (577, 64, 64, 2)


def test_plain_path_equals_reference_at_577(served):
    plain, ref = served["plain"], served["ref"]
    s_out = served["prog"].s["s_out"]
    assert plain.shape == ref.shape == (3, SMALL["num_classes"])
    assert int((torch.round(plain / s_out) != torch.round(ref / s_out)).sum()) == 0
    assert torch.equal(plain, ref)
    assert harness.logit_gap(plain, ref) == 0.0


def test_default_entries_equal_plain_path_at_577(served):
    """The default forward (the kernels' entries, their plain versions on
    CPU tensors) gives the plain path's logits."""
    prog = served["prog"]
    assert torch.equal(prog.forward(served["x"]), served["plain"])


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    return jnp.asarray(tree.detach().cpu().numpy())


def test_plain_path_equals_jax_op_by_op_at_577(served):
    """JAX's serving path on the port's params and calibration, op by op,
    from JAX's ``ViTConfig`` at the same sizes: the same logits."""
    cfg, tcfg = served["cfg"], served["prog"].cfg
    jcfg = jcommon.ViTConfig(**{k: cfg["sizes"][k] for k in ("img_size", "patch_size", "in_chans", "num_classes",
                                                             "embed_dim", "depth", "num_heads", "mlp_ratio",
                                                             "ln_eps")})
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    q, pp = cfg["quant"], cfg["preprocess"]
    dev = torch.device("cpu")
    _, params, cal_x = harness.make_inputs(cfg, SEED, dev)
    qstate = vit.calibrate(params, tcfg, make_policy(q["ptf"], q["lis"], q["quant_method"]), cal_x).qstate
    bits = [q["weight_bits"]] * jcfg.num_matmuls
    js = jserving.convert(_numpy_tree(params), _numpy_tree(qstate), jcfg,
                          jmake_policy(q["ptf"], q["lis"], q["quant_method"]), bits)
    jserving.attach_u8_ingest(js, pp["mean"], pp["std"])
    with jax.disable_jit():
        j = np.asarray(jserving.serving_forward(js, jcfg, jnp.asarray(served["x"].numpy()), use_pallas=False,
                                                scan_layers=False))
    t = served["plain"].numpy()
    assert t.shape == j.shape
    assert int((t != j).sum()) == 0


def test_zoo_entry_is_the_benchmark_configuration():
    cfg = VIT_ZOO["vit_large_patch16_384"]
    sizes = CONFIG["sizes"]
    assert {k: getattr(cfg, k) for k in sizes} == sizes
    assert (cfg.seq_len, cfg.head_dim, cfg.hidden_dim) == (577, 64, 4096)
    assert cli.FULL_NAME["vit_large_384"] == "vit_large_patch16_384" == CONFIG["model"]
    assert list(preprocess(CONFIG["model"])["mean"]) == CONFIG["preprocess"]["mean"]
    assert list(preprocess(CONFIG["model"])["std"]) == CONFIG["preprocess"]["std"]


@pytest.mark.parametrize("name", cli.MODEL_CHOICES)
def test_cli_preprocessing(name, monkeypatch):
    """``vit_large_384`` takes timm's 384 ViT preprocessing; every other CLI
    name keeps its family's, and ``make_dataset`` builds with it."""
    from p2vit_tpu_torch import data

    want = PREPROCESS[name.split("_")[0]]
    if name == "vit_large_384":
        want = {"mean": (0.5, 0.5, 0.5), "std": (0.5, 0.5, 0.5), "crop_pct": 1.0}
    assert preprocess(cli.FULL_NAME[name]) == want
    seen = {}
    monkeypatch.setattr(data, "build_transform", lambda size, mean, std, crop_pct, raw=False: seen.update(
        size=size, mean=mean, std=std, crop_pct=crop_pct))
    monkeypatch.setattr(data, "ImageFolder", lambda root, transform: None)
    cli.make_dataset(cli.build_parser().parse_args([name, "d"]), MODEL_ZOO[cli.FULL_NAME[name]], "val")
    assert (seen["mean"], seen["std"], seen["crop_pct"]) == (want["mean"], want["std"], want["crop_pct"])


def test_counts_per_image():
    """382.13 GOP an image, 10.9× DeiT-B's; row 3's share 31.4 %."""
    w = counts.work("vit", CONFIG["sizes"], 1)
    total = sum(ops for ops, _ in w["model"])
    assert round(total / 1e9, 2) == 382.13
    assert round(sum(ops for ops, _ in w["qkv_attention"]) / total, 3) == 0.314
    assert len(w["qkv_attention"]) == 24 and len(w["requant_gemm"]) == 25


def test_cpu_forward_records_the_cluster(served):
    """Each ``op.lis_attention_qkv_fused`` span of a recorded default forward
    carries ``cluster`` = 10; no ``resident_clusters`` off the card; the
    forward forms no constant and makes no sync."""
    prog = served["prog"]
    with profiling.recording():
        out = prog.forward(served["x"][:1])
    recs = profiling.drain()
    assert torch.equal(out, served["plain"][:1])
    qkv = [r for r in recs if r.name == "op.lis_attention_qkv_fused"]
    assert len(qkv) == prog.cfg.depth
    assert all(r.attrs == {"cluster": 10} for r in qkv)
    assert sum(r.counts.get("consts_formed", 0) + r.counts.get("syncs", 0) for r in recs) == 0


def test_launch_facts_are_read_only_while_recording(served):
    """``convert`` and a forward that is not recorded leave the launch facts
    unread (on the card, reading them loads the kernel library)."""
    cfg = small_config()
    dev = torch.device("cpu")
    _, params, cal_x = harness.make_inputs(cfg, SEED, dev)
    attention_lis.qkv_launch_facts.cache_clear()
    prog = harness.family(cfg).Program(cfg, params, cal_x)
    assert torch.equal(prog.forward(served["x"][:1]), served["plain"][:1])
    assert attention_lis.qkv_launch_facts.cache_info().currsize == 0


@pytest.mark.parametrize("n,c_in,hd,cluster", [(577, 1024, 64, 10), (197, 768, 64, 4), (577, 200, 64, 10),
                                               (300, 256, 128, 5), (1025, 64, 64, None), (769, 64, 64, None)])
def test_launch_facts_off_the_card(n, c_in, hd, cluster):
    """The facts follow ``qkv_cluster_plan`` (C_in padded to 16); empty where
    the kernel does not take the shape."""
    facts = attention_lis.qkv_launch_facts(n, c_in, hd, True, False)
    assert facts == ({} if cluster is None else {"cluster": cluster})

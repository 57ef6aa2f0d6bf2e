"""The port's parallel serving (``p2vit_tpu_torch/parallel/``) on the CPU
against the JAX package's parallel functions and against the port's own
single-process forwards, at the TINY ViT and Swin of
``tests/test_parallel.py``.

One module-scoped fixture starts ONE gloo group of 4 CPU ranks
(``dist.run_ranks``, with its deadline) that runs every scenario of
``parallel.dryrun.run_scenarios`` on the port's conversion of JAX's
seeded states: DP over a 4×1 mesh, TP over 2×2 (qkv-fused and staged,
sequence-parallel, W4, uint8), Swin TP over 2×2 (LIS on and off), a
2-stage pipeline at 1, 2 and 4 microbatches, full batches of 8 and short
ones of 5 (pad and trim); and the three mesh surfaces of JAX's GSPMD tests
(``tests/test_parallel.py``): ``calibrate`` on the batch sharded over a 4×1
mesh (the quant state bit for bit here, and within JAX's rtol 1e-6, the
envelope the card is held to), DP×TP of ``quant_forward`` over 2×2 (within
one LSB of act_out's grid, argmax equal) and the DP data-free generation
gradient over 4×1 (within rtol 2e-4, atol 2e-6 of one process's). The states are the port's seeded init and
calibration on a numpy-seeded batch, handed to JAX as arrays (the port's
calibration takes a few seconds where JAX's jit takes ~25). The JAX
results come from the 8-virtual-device CPU mesh: ``dp_serving_fn``,
``tp_serving_fn`` (``use_pallas=False``, and the Pallas kernels in
interpret mode with ``fuse_qkv`` both ways), ``seq_parallel=True``,
``tensor_swin.tp_serving_fn`` (LIS on and off) and
``pipeline_serving_forward`` (interpret mode); each JAX function compiles
per batch shape, so the short batches and 1 and 4 microbatches are held
against the port's one-process forward only. Tolerance 0 throughout but for
those two envelopes, which are JAX's: every other comparison is bit for
bit.

Also: ``_qkv_tp_perm``, ``check_tp`` and the TP divisibility errors against
JAX's, ``make_pipeline_mesh`` raising inside a group and ``make_mesh``
inside and outside one, and the CLI's ``build_parallel_meshes`` against JAX's precedence
matrix (``tests/test_pipeline.py``).
"""

import contextlib
import dataclasses
import importlib.util
import io
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu import serving_swin as jserving_swin
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import swin as jswin
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu.parallel import mesh as jmesh
from p2vit_tpu.parallel import pipeline as jpipe
from p2vit_tpu.parallel import tensor as jtensor
from p2vit_tpu.parallel import tensor_swin as jtensor_swin
from p2vit_tpu.quant.observers import collect_minmax as jcollect_minmax
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch import serving_swin as tserving_swin
from p2vit_tpu_torch.cli import build_parallel_meshes, build_parser
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.models import swin as tswin
from p2vit_tpu_torch.models import vit as tvit
from p2vit_tpu_torch.parallel import dist as pdist
from p2vit_tpu_torch.parallel import dryrun, pipeline, tensor, tensor_swin
from p2vit_tpu_torch.parallel import mesh as pmesh
from p2vit_tpu_torch.quant.observers import collect_minmax

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=10, embed_dim=16, depth=2, num_heads=2)
SWIN = jswin.SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                        num_heads=(2, 2), window_size=4)
WORLD = 4
SHORT = 5  # run_scenarios' short batch: 8 − 3

pytestmark = pytest.mark.skipif(len(jax.devices()) < 8, reason="needs the 8-virtual-device CPU mesh")


def _j(tree):
    return jax.tree.map(lambda t: jnp.asarray(t.numpy().copy()), tree)


@pytest.fixture(scope="module")
def states():
    """The port's seeded TINY ViT and Swin, calibrated on a numpy-seeded
    batch, and their serving states; JAX gets the same params and quant
    states as arrays."""
    rng = np.random.RandomState(1)
    x = rng.randn(8, 3, 32, 32).astype(np.float32)
    xu8 = rng.randint(0, 256, (8, 3, 32, 32)).astype(np.uint8)
    tpol = tmake_policy()
    vcfg = tcommon.ViTConfig(**dataclasses.asdict(TINY))
    scfg = tswin.SwinConfig(**dataclasses.asdict(SWIN))
    tp = tvit.init_params(0, vcfg, device="cpu")
    tq = tvit.calibrate(tp, vcfg, tpol, torch.from_numpy(x)).qstate
    sp = tswin.init_params(0, scfg, device="cpu")
    sq = tswin.calibrate(sp, scfg, tpol, torch.from_numpy(x)).qstate
    s8 = tserving.convert(tp, tq, vcfg, tpol, [8] * TINY.num_matmuls)
    tserving.attach_u8_ingest(s8)
    st = dict(vit_cfg=vcfg, swin_cfg=scfg, policy=tpol, params=tp, qstate=tq, s8=s8,
              s4=tserving.convert(tp, tq, vcfg, tpol, [4] * TINY.num_matmuls),
              sstate=tserving_swin.convert(sp, sq, scfg, tpol, 8), sqstate=sq,
              x=torch.from_numpy(x), xu8=torch.from_numpy(xu8),
              img=torch.from_numpy(rng.randn(8, 3, 32, 32).astype(np.float32)))
    return dict(st=st, x=x, xu8=xu8, policy=make_policy(), params=_j(tp), qstate=_j(tq), sparams=_j(sp),
                sqstate=_j(sq))


@pytest.fixture(scope="module")
def ranks(states):
    """Every scenario on one group of 4 CPU ranks; returns each rank's results."""
    return pdist.run_ranks(dryrun.run_scenarios, WORLD, states["st"], device="cpu", timeout_s=120)


@pytest.fixture(scope="module")
def jax_results(states):
    """JAX's parallel functions on the same inputs (the CPU mesh). Each
    compiles per batch shape, so the short batch and the Pallas arms run
    where the port's result is held against them (``VS_JAX``)."""
    x, policy, params, qstate = jnp.asarray(states["x"]), states["policy"], states["params"], states["qstate"]
    s8 = jserving.convert(params, qstate, TINY, policy, [8] * TINY.num_matmuls)
    s4 = jserving.convert(params, qstate, TINY, policy, [4] * TINY.num_matmuls)
    ss = jserving_swin.convert(states["sparams"], states["sqstate"], SWIN, policy, 8)
    out = {}
    dp = jmesh.make_mesh(WORLD, model_parallel=1)
    tp = jmesh.make_mesh(WORLD, model_parallel=2)
    with dp:
        st = jmesh.sharded_minmax_stats(dp, x.reshape(8, -1, 32))
    out["stats"] = (st.min_val, st.max_val)
    rs = jmesh.replicate(s8, dp)
    fn = jmesh.dp_serving_fn(lambda xx: jserving.serving_forward(rs, TINY, xx, use_pallas=False), dp)
    out["dp"] = (fn(x), fn(x[:SHORT]))
    for name, kw in (("tp", dict(use_pallas=False)), ("sp", dict(use_pallas=False, seq_parallel=True))):
        fn = jtensor.tp_serving_fn(s8, TINY, tp, **kw)
        out[name] = (fn(x), fn(x[:SHORT]))
    # the Pallas kernels (interpret mode) on each shard, fuse_qkv both ways
    for name, fq in (("tp_pallas", True), ("tp_unfused", False)):
        out[name] = jtensor.tp_serving_fn(s8, TINY, tp, use_pallas=True, interpret=True, fuse_qkv=fq)(x)
    out["tp_w4"] = jtensor.tp_serving_fn(s4, TINY, tp, use_pallas=False)(x)
    su8 = dict(s8)
    jserving.attach_u8_ingest(su8)
    out["tp_u8"] = jtensor.tp_serving_fn(su8, TINY, tp, use_pallas=False)(jnp.asarray(states["xu8"]))
    for lis in (True, False):
        fn = jtensor_swin.tp_serving_fn(ss, states["sqstate"], SWIN, tp, use_pallas=False, lis=lis)
        out["swin_tp" if lis else "swin_tp_lisoff"] = fn(x)
    pm = jpipe.make_pipeline_mesh(2)
    out["pp2"] = jpipe.pipeline_serving_forward(s8, TINY, x, pm, n_micro=2, interpret=True)
    out["pp_short"] = jpipe.pp_serving_fn(s8, TINY, pm, n_micro=2, interpret=True)(x[:SHORT])
    return jax.tree.map(np.asarray, out)


def _np(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_np(t) for t in tree)
    return tree.numpy()


def _assert_equal(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_equal(g, w)
        return
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# (the port's scenario, JAX's result it equals bit for bit; a full batch's
# result against a single JAX array, full and short against a pair)
VS_JAX = [("stats", "stats"), ("dp", "dp"), ("tp", "tp"), ("tp", "tp_pallas"), ("tp_unfused", "tp_unfused"),
          ("sp", "sp"), ("tp_w4", "tp_w4"), ("tp_u8", "tp_u8"), ("swin_tp", "swin_tp"),
          ("swin_tp_lisoff", "swin_tp_lisoff"), ("pp2", "pp2"), ("pp_short", "pp_short")]


@pytest.mark.parametrize("port_name,jax_name", VS_JAX)
def test_parallel_matches_jax(ranks, jax_results, port_name, jax_name):
    """Rank 0's result equals JAX's parallel function's, bit for bit."""
    got, want = _np(ranks[0][port_name]), jax_results[jax_name]
    if isinstance(got, tuple) and not isinstance(want, tuple):
        got = got[0]
    _assert_equal(got, want)


@pytest.fixture(scope="module")
def one_process(states):
    return dryrun.references(states["st"])


@pytest.mark.parametrize("name", dryrun.SCENARIOS)
def test_parallel_matches_one_process(one_process, ranks, name):
    """Rank 0's result equals the port's single-process forward (or
    ``collect_minmax`` / ``quant_forward``) bit for bit, and every other
    rank that took part returns the same."""
    _assert_equal(_np(ranks[0][name]), _np(one_process[name]))
    for r in ranks[1:]:
        if name in r:
            _assert_equal(_np(r[name]), _np(ranks[0][name]))


@pytest.mark.parametrize("name", dryrun.ENVELOPES)
def test_mesh_surfaces_within_jax_envelopes(one_process, ranks, states, name):
    """The sharded calibration, DP×TP of ``quant_forward`` and the DP
    generation gradient against one process's, within JAX's envelopes
    (``dryrun.outside_envelope``); every rank returns the same."""
    assert dryrun.outside_envelope(name, ranks[0][name], one_process[name], states["st"]) == 0
    assert all(bool(torch.isfinite(t).all()) for t in dryrun.leaves(ranks[0][name]))
    for r in ranks[1:]:
        if name in r:
            assert dryrun.mismatches(r[name], ranks[0][name]) == 0


def test_sharded_calibrate_equals_one_process_bitwise(one_process, ranks):
    """On the CPU a shard's forward rounds as the whole batch's, so the
    sharded calibration's quant state equals one process's bit for bit,
    leaf for leaf, on every rank."""
    for r in ranks:
        got = r["calib_sharded"]
        assert len(got) == len(one_process["calib_sharded"])
        for g, w in zip(got, one_process["calib_sharded"]):
            assert torch.equal(g, w)


def test_param_shardings_match_jax(states):
    """The port's placement of every ViT param leaf equals JAX's
    ``param_shardings`` spec, path for path."""
    specs = pmesh.param_shardings(states["st"]["params"])
    jspecs = jmesh.param_shardings(states["params"], jmesh.make_mesh(WORLD, model_parallel=2))
    got = dict(_paths(specs))
    want = {p: tuple(s.spec) for p, s in _paths(jspecs)}
    assert got == want and ("model", None) in got.values() and (None, "model") in got.values()


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], f"{prefix}/{k}")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _paths(v, f"{prefix}/{i}")
    else:
        yield prefix, tree


def test_shard_params_cuts_megatron_blocks(states):
    """Each model rank's shard: qkv rows head-aligned (rank m holds the q, k
    and v rows of its heads), fc1 rows and proj/fc2 columns in contiguous
    blocks; the shards of every rank rebuild the whole."""
    from types import SimpleNamespace

    params, heads = states["st"]["params"], TINY.num_heads
    shards = [pmesh.shard_params(params, SimpleNamespace(shape={"data": 1, "model": 2}, index=lambda a, m=m: m),
                                 heads) for m in range(2)]
    blk = [s["blocks"][0] for s in shards]
    whole = params["blocks"][0]
    perm = torch.as_tensor(tensor._qkv_tp_perm(TINY.embed_dim, heads, 2))
    assert torch.equal(torch.cat([b["qkv"]["w"] for b in blk]), whole["qkv"]["w"][perm])
    assert torch.equal(torch.cat([b["qkv"]["b"] for b in blk]), whole["qkv"]["b"][perm])
    assert torch.equal(torch.cat([b["fc1"]["w"] for b in blk]), whole["fc1"]["w"])
    assert torch.equal(torch.cat([b["proj"]["w"] for b in blk], 1), whole["proj"]["w"])
    assert torch.equal(torch.cat([b["fc2"]["w"] for b in blk], 1), whole["fc2"]["w"])
    assert blk[0]["proj"]["b"] is whole["proj"]["b"] and shards[1]["head"]["w"] is params["head"]["w"]


def test_sharded_stats_equal_collect_minmax(states, ranks):
    """MIN/MAX over "data" equals the global batch's observer stats (both
    packages')."""
    v = states["x"].reshape(8, -1, 32)
    ref = collect_minmax(torch.from_numpy(v), "activation", layer_wise=False)
    jref = jcollect_minmax(jnp.asarray(v), "activation", layer_wise=False)
    lo, hi = _np(ranks[0]["stats"])
    np.testing.assert_array_equal(lo, ref.min_val.numpy())
    np.testing.assert_array_equal(hi, ref.max_val.numpy())
    np.testing.assert_array_equal(lo, np.asarray(jref.min_val))


def test_one_process_matches_jax_serving(states):
    """The port's single-process serving at this TINY equals JAX's (the
    premise of holding the port's parallel paths against both)."""
    p, st, x = states["policy"], states["st"], states["x"]
    s8 = jserving.convert(states["params"], states["qstate"], TINY, p, [8] * TINY.num_matmuls)
    j = np.asarray(jserving.serving_forward(s8, TINY, jnp.asarray(x), use_pallas=False))
    np.testing.assert_array_equal(tserving.serving_forward(st["s8"], st["vit_cfg"], st["x"]).numpy(), j)


@pytest.mark.parametrize("c,heads,tp", [(16, 2, 2), (384, 6, 2), (384, 6, 3), (96, 3, 3), (768, 24, 4)])
def test_qkv_tp_perm_matches_jax(c, heads, tp):
    np.testing.assert_array_equal(tensor._qkv_tp_perm(c, heads, tp), jtensor._qkv_tp_perm(c, heads, tp))


@pytest.mark.parametrize("heads,tp", [((2, 2), 3), ((3, 6, 12, 24), 2), ((4, 8, 16, 32), 3), ((3, 6, 12, 24), 3)])
def test_swin_check_tp_matches_jax(heads, tp):
    """The same configs pass, the same raise with JAX's message."""
    jcfg = dataclasses.replace(SWIN, depths=(2,) * len(heads), num_heads=heads)
    tcfg = tswin.SwinConfig(**dataclasses.asdict(jcfg))
    try:
        jtensor_swin.check_tp(jcfg, tp)
    except ValueError as e:
        with pytest.raises(ValueError) as te:
            tensor_swin.check_tp(tcfg, tp)
        assert str(te.value) == str(e)
    else:
        tensor_swin.check_tp(tcfg, tp)


@pytest.mark.parametrize("tp", [3, 4])
def test_vit_tp_divisibility_matches_jax(states, tp):
    """tp ∤ heads raises JAX's message (TINY: 2 heads)."""
    s8 = jserving.convert(states["params"], states["qstate"], TINY, states["policy"], [8] * TINY.num_matmuls)
    with pytest.raises(ValueError) as je:
        jtensor.tp_serving_fn(s8, TINY, jmesh.make_mesh(tp, model_parallel=tp), use_pallas=False)
    with pytest.raises(ValueError) as te:
        tensor.check_tp(states["st"]["vit_cfg"], 64, tp)
    assert str(te.value) == str(je.value)


def test_mesh_layouts_raise_outside_a_group():
    """Outside a process group: a layout, no groups; the same raises."""
    pm = pipeline.make_pipeline_mesh(3)
    assert pm.shape == {"stage": 3}
    with pytest.raises(RuntimeError, match="layout only"):
        pm.group
    with pytest.raises(ValueError, match="not divisible by model_parallel=2"):
        pmesh.make_mesh(3, model_parallel=2)
    m = pmesh.make_mesh(4, model_parallel=2)
    assert m.shape == {"data": 2, "model": 2} and not m.member
    with pytest.raises(RuntimeError, match="layout only"):
        m.group("data")


def test_mesh_raises_inside_a_group(ranks):
    """Inside the 4-rank group: a 5-stage pipeline and a 6-rank mesh raise,
    naming the world."""
    errs = ranks[0]["errors"]
    assert errs["pipeline"] == "5-stage pipeline needs 5 ranks; only 4 available"
    assert errs["mesh"] == "a mesh of 6 ranks needs 6 ranks; only 4 in the process group"


def _jax_cli():
    spec = importlib.util.spec_from_file_location(
        "p2vit_cli_par", os.path.join(os.path.dirname(__file__), "..", "test_quant.py"))
    cli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cli)
    return cli


MATRIX = [
    ("vit", []), ("vit", ["--dp", "4"]), ("vit", ["--pp", "2", "--dp", "4"]),
    ("vit", ["--tp", "2", "--dp", "2", "--sp"]), ("vit", ["--tp", "2", "--pp", "2"]),
    ("vit", ["--tp", "4", "--dp", "2"]), ("vit_noserve", ["--dp", "4"]), ("vit_noserve", ["--tp", "2"]),
    ("vit", ["--sp"]), ("vit_noserve", ["--pp", "2"]),
    ("swin", ["--tp", "2", "--sp"]), ("swin", ["--tp", "3"]), ("swin", ["--tp", "2", "--pp", "2"]),
    ("swin", ["--dp", "2"]),
]


def _shape(m):
    return None if m is None else dict(m.shape)


@pytest.mark.parametrize("fam,extra", MATRIX)
def test_build_parallel_meshes_matches_jax(fam, extra):
    """The port's flag resolution equals JAX's: which meshes, their shapes,
    and the printed lines."""
    jcli = _jax_cli()
    is_swin = fam == "swin"
    argv = ["swin_tiny" if is_swin else "deit_tiny", "/tmp/none"]
    if fam != "vit_noserve":
        argv += ["--quant", "--serve"]
    if is_swin:
        jcfg = SWIN
        tcfg = tswin.SwinConfig(**dataclasses.asdict(SWIN))
    else:
        jcfg = TINY
        tcfg = tcommon.ViTConfig(**dataclasses.asdict(TINY))
    jout, tout = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(jout):
        jm = jcli.build_parallel_meshes(jcli.build_parser().parse_args(argv + extra), jcfg, is_swin)
    with contextlib.redirect_stdout(tout):
        tm = build_parallel_meshes(build_parser().parse_args(argv + extra), tcfg, is_swin)
    assert [_shape(m) for m in tm] == [_shape(m) for m in jm]
    assert tout.getvalue() == jout.getvalue()


def test_run_ranks_raises_with_each_failed_ranks_traceback():
    """A rank that raises fails the call with its traceback (here both ranks:
    the payload lacks every state), and no rank is left running."""
    with pytest.raises(RuntimeError, match="2 of 2 ranks failed") as e:
        pdist.run_ranks(dryrun.run_scenarios, 2, {}, device="cpu", timeout_s=60)
    assert str(e.value).count("KeyError") == 2


def test_run_ranks_kills_the_ranks_past_the_deadline(states):
    """Past ``timeout_s`` the ranks are killed and the call raises (the
    ranks are still starting half a second in)."""
    import time

    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="not done within 0.5 s; killed"):
        pdist.run_ranks(dryrun.run_scenarios, 2, states["st"], device="cpu", timeout_s=0.5)
    assert time.monotonic() - t0 < 30


def test_dryrun_main_defaults_to_the_card(monkeypatch):
    """``python -m p2vit_tpu_torch.parallel.dryrun`` without ``--device``
    asks for the card, and raises on a machine without one before it
    builds any state."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device and none is available"):
        dryrun.main([])


def test_dryrun_main_runs_on_the_cpu(states, ranks, monkeypatch, capsys):
    """``--device cpu`` starts the dry run's ranks on the CPU and holds every
    scenario against one process. The file's group of CPU ranks stands in
    for the one ``main`` would start (the same ``run_scenarios``, on the
    file's states)."""
    started = []

    def run_ranks(fn, world, st, device, timeout_s):
        started.append((fn, world, device))
        return ranks

    monkeypatch.setattr(dryrun, "tiny_states", lambda device, seed: states["st"])
    monkeypatch.setattr(pdist, "run_ranks", run_ranks)
    assert dryrun.main(["--device", "cpu", "--world", str(WORLD)]) == 0
    assert started == [(dryrun.run_scenarios, WORLD, torch.device("cpu"))]
    out = capsys.readouterr().out
    assert f"{WORLD} ranks on cpu" in out and out.rstrip().endswith("dryrun: OK")
    assert all(f"{name}: 0 elements" in out for name in dryrun.SCENARIOS + dryrun.ENVELOPES)

"""Dry run of every parallel path on tiny shapes over one rank group (the
port's counterpart of ``__graft_entry__.dryrun_multichip``).

    python -m p2vit_tpu_torch.parallel.dryrun --world 4 --device cpu
    python -m p2vit_tpu_torch.parallel.dryrun --world 4 --device cuda   # ranks share the card

Builds seeded tiny ViT and Swin serving states in this process, starts
``--world`` ranks (``dist.run_ranks``) that run ``run_scenarios``: the
sharded min/max statistics, DP of ``quant_forward``, DP, TP (qkv-fused and
staged), TP with sequence-parallel epilogues, W4 and uint8 TP, Swin TP (LIS
on and off) and a 2-stage pipeline at 1, 2 and 4 microbatches, each on a
full and a short batch; and the three mesh surfaces of the fake-quant and
float programs: ``calibrate`` on the data-sharded batch, DP×TP of
``quant_forward`` ((world/2) × 2) and the DP data-free generation gradient.
Then holds every result against one process's ``serving_forward`` (or
``collect_minmax`` / ``quant_forward`` / ``calibrate`` / the gradient), bit
for bit but for the two whose sums reassociate across ranks, which are held
to the JAX package's envelopes (``ENVELOPES``), prints one line per
scenario and exits 1 on any mismatch.

The ViT has head_dim 64 (two heads at C = 128), which the card's qkv-fused
kernel takes; the Swin is the JAX tests' TINY (heads (2, 2), 4×4 windows).
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from . import dist as pdist


def tiny_configs():
    from ..models.common import ViTConfig
    from ..models.swin import SwinConfig

    vit_cfg = ViTConfig(img_size=32, patch_size=8, num_classes=10, embed_dim=128, depth=2, num_heads=2)
    swin_cfg = SwinConfig(img_size=32, patch_size=4, num_classes=10, embed_dim=16, depths=(2, 2),
                          num_heads=(2, 2), window_size=4)
    return vit_cfg, swin_cfg


def tiny_states(device, seed: int = 0, batch: int = 8) -> dict:
    """Seeded tiny ViT and Swin states: params, calibration on one seeded
    batch, W8 and W4 ViT serving states (the W8 one with uint8 ingestion),
    a W8 Swin state, and the request batches (float32 and uint8)."""
    from .. import serving, serving_swin
    from ..config import make_policy
    from ..models import swin, vit

    vit_cfg, swin_cfg = tiny_configs()
    gen = torch.Generator().manual_seed(seed + 1)
    x = torch.randn((batch, 3, 32, 32), generator=gen).to(device)
    xu8 = torch.randint(0, 256, (batch, 3, 32, 32), generator=gen, dtype=torch.uint8).to(device)
    img = torch.randn((batch, 3, 32, 32), generator=gen).to(device)
    policy = make_policy()
    params = vit.init_params(seed, vit_cfg, device=device)
    calib = vit.calibrate(params, vit_cfg, policy, x)
    s8 = serving.convert(params, calib.qstate, vit_cfg, policy, [8] * vit_cfg.num_matmuls)
    serving.attach_u8_ingest(s8)
    s4 = serving.convert(params, calib.qstate, vit_cfg, policy, [4] * vit_cfg.num_matmuls)
    sparams = swin.init_params(seed, swin_cfg, device=device)
    scalib = swin.calibrate(sparams, swin_cfg, policy, x)
    ss = serving_swin.convert(sparams, scalib.qstate, swin_cfg, policy, 8)
    return dict(vit_cfg=vit_cfg, swin_cfg=swin_cfg, policy=policy, params=params, qstate=calib.qstate,
                s8=s8, s4=s4, sstate=ss, sqstate=scalib.qstate, x=x, xu8=xu8, img=img)


def _bits_idx(cfg, bits):
    from ..models import vit

    return vit.bits_to_idx([bits] * cfg.num_matmuls)


def leaves(tree) -> tuple:
    """The tensors of a nested dict/list tree, in sorted-key order."""
    if isinstance(tree, dict):
        return tuple(t for k in sorted(tree) for t in leaves(tree[k]))
    if isinstance(tree, (list, tuple)):
        return tuple(t for v in tree for t in leaves(v))
    return (tree,)


# the data-free objective's arguments of JAX's DP gradient test
# (tests/test_parallel.py): the pseudo-labels, the TV target, a jitter
# offset of 2 pixels and the mirror flip
def _gen_args(st):
    b = st["img"].shape[0]
    labels = torch.arange(b, device=st["img"].device) % st["vit_cfg"].num_classes
    return labels, 2750.0, 2, True


def _dp_generation_grad(st, mesh):
    """This rank's gradient of the DP objective on its data shard, gathered
    back into the whole batch's."""
    from . import mesh as pmesh

    im = pmesh.shard_batch(mesh, st["img"]).detach().clone().requires_grad_(True)
    loss = pmesh.dp_generation_loss(im, st["params"], st["vit_cfg"], *_gen_args(st), mesh)
    (g,) = torch.autograd.grad(loss, im)
    return pmesh.gather_batch(mesh, g)


def run_scenarios(device, st: dict, names=None) -> dict:
    """On each rank of the group: every scenario of ``names`` (default all)
    on the states of ``tiny_states`` (or the same keys made elsewhere).
    Returns {scenario: result}, whole-batch results on every rank that
    takes part (ranks outside a scenario's mesh return nothing for it).
    Meshes use ranks 0 .. n−1 of the world: DP over all of them, TP as
    (world/2) × 2, the pipeline on ranks 0 and 1. ``errors`` holds what a
    pipeline or a mesh larger than the world raises."""
    from .. import serving, serving_swin
    from ..models import vit
    from . import mesh as pmesh
    from . import pipeline, tensor, tensor_swin

    st = pdist.map_tensors(st, lambda t: t.to(device))
    world = pdist.world_size()
    names = set(names or SCENARIOS + ENVELOPES)
    vcfg, scfg, policy = st["vit_cfg"], st["swin_cfg"], st["policy"]
    x, xu8 = st["x"], st["xu8"]
    short = x.shape[0] - 3
    out = {}
    errors = {}  # what a mesh too large for the world raises
    for key, make in (("pipeline", lambda: pipeline.make_pipeline_mesh(world + 1)),
                      ("mesh", lambda: pmesh.make_mesh(world + 2, 2))):
        try:
            make()
        except ValueError as e:
            errors[key] = str(e)
    out["errors"] = errors
    dp = pmesh.make_mesh(world, 1)
    tp = pmesh.make_mesh(world - world % 2, 2)
    pp = pipeline.make_pipeline_mesh(2)
    if "stats" in names:
        stats = pmesh.sharded_minmax_stats(dp, x.reshape(x.shape[0], -1, x.shape[-1]))
        out["stats"] = (stats.min_val, stats.max_val)
    if "dp_quant" in names:
        run = pmesh.data_parallel_eval(
            lambda p, xx, bi: vit.quant_forward(p, st["qstate"], vcfg, policy, xx, bi), dp, st["params"])
        out["dp_quant"] = run(x, _bits_idx(vcfg, 8).to(device))
    if "calib_sharded" in names:
        out["calib_sharded"] = leaves(vit.calibrate(st["params"], vcfg, policy, x, mesh=dp).qstate)
    if "dp_grad" in names:
        out["dp_grad"] = _dp_generation_grad(st, dp)
    if "dp_tp_quant" in names and tp.member:
        run = pmesh.data_parallel_eval(
            lambda p, xx, bi, mesh=None: vit.quant_forward(p, st["qstate"], vcfg, policy, xx, bi, mesh=mesh), tp,
            st["params"])
        out["dp_tp_quant"] = run(x, _bits_idx(vcfg, 8).to(device))
    if "dp" in names:
        fn = pmesh.dp_serving_fn(lambda xx: serving.serving_forward(st["s8"], vcfg, xx), dp)
        out["dp"] = (fn(x), fn(x[:short]))
    if tp.member:
        for name, kw in (("tp", {}), ("tp_unfused", dict(fuse_qkv=False)), ("sp", dict(seq_parallel=True))):
            if name in names:
                fn = tensor.tp_serving_fn(st["s8"], vcfg, tp, **kw)
                out[name] = (fn(x), fn(x[:short]))
        if "tp_w4" in names:
            out["tp_w4"] = tensor.tp_serving_fn(st["s4"], vcfg, tp)(x)
        if "tp_u8" in names:
            out["tp_u8"] = tensor.tp_serving_fn(st["s8"], vcfg, tp)(xu8)
        for lis in (True, False):
            name = "swin_tp" if lis else "swin_tp_lisoff"
            if name in names:
                fn = tensor_swin.tp_serving_fn(st["sstate"], st["sqstate"], scfg, tp, lis=lis)
                out[name] = (fn(x), fn(x[:short]))
    if pp.member:
        for n_micro in (1, 2, 4):
            if f"pp{n_micro}" in names:
                out[f"pp{n_micro}"] = pipeline.pipeline_serving_forward(st["s8"], vcfg, x, pp, n_micro=n_micro)
        if "pp_short" in names:
            out["pp_short"] = pipeline.pp_serving_fn(st["s8"], vcfg, pp, n_micro=2)(x[:short])
    return out


SCENARIOS = ("stats", "dp_quant", "dp", "tp", "tp_unfused", "sp", "tp_w4", "tp_u8", "swin_tp", "swin_tp_lisoff",
             "pp1", "pp2", "pp4", "pp_short")
# scenarios whose float results may round differently across ranks, and
# their envelopes (tests/test_parallel.py's): the sharded calibration's
# quant state within rtol 1e-6 (atol 0) of one process's, so that every
# power-of-two decision is equal and a float scale moves by at most a few
# ulps (on the card, cuBLAS picks a shard's GEMM kernel by its rows, so a
# shard's proj and fc2 outputs can differ in their last bits from the whole
# batch's, and the PTF scales derived from them with them; on the CPU the
# state is equal bit for bit); DP×TP within one LSB of act_out's grid with
# the argmax equal; the gradient within rtol 2e-4, atol 2e-6
ENVELOPES = ("calib_sharded", "dp_tp_quant", "dp_grad")


def outside_envelope(name: str, got, want, st: dict) -> int:
    """Elements of an ``ENVELOPES`` scenario's result outside its envelope
    (DP×TP: also each row whose argmax differs)."""
    if isinstance(got, (tuple, list)):
        return sum(outside_envelope(name, g, w, st) for g, w in zip(got, want))
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    if name == "dp_tp_quant":
        lsb = float(st["qstate"]["act_out"]["scale"])
        return int(((got - want).abs() > lsb * 1.0001).sum()) + int((got.argmax(1) != want.argmax(1)).sum())
    rtol, atol = (1e-6, 0.0) if name == "calib_sharded" else (2e-4, 2e-6)
    return int((~torch.isclose(got, want, rtol=rtol, atol=atol)).sum())


def references(st: dict, names=None) -> dict:
    """One process's results for the scenarios of ``run_scenarios`` in
    ``names`` (default all; ``calib_sharded``'s: the calibration
    ``tiny_states`` made on the same batch)."""
    from .. import datafree, serving, serving_swin
    from ..models import vit
    from ..quant.observers import collect_minmax

    vcfg, scfg, policy, x = st["vit_cfg"], st["swin_cfg"], st["policy"], st["x"]
    short = x.shape[0] - 3
    names = set(names or SCENARIOS + ENVELOPES)
    ref = {}
    if "stats" in names:
        mm = collect_minmax(x.reshape(x.shape[0], -1, x.shape[-1]), "activation", layer_wise=False)
        ref["stats"] = (mm.min_val, mm.max_val)
    if names & {"dp_quant", "dp_tp_quant"}:
        ref["dp_quant"] = ref["dp_tp_quant"] = vit.quant_forward(st["params"], st["qstate"], vcfg, policy, x,
                                                                 _bits_idx(vcfg, 8).to(x.device))
    ref["calib_sharded"] = leaves(st["qstate"])
    if "dp_grad" in names:
        img = st["img"].detach().clone().requires_grad_(True)
        (ref["dp_grad"],) = torch.autograd.grad(datafree.generation_loss(img, st["params"], vcfg, *_gen_args(st)),
                                                img)
    if names & {"dp", "tp", "tp_unfused", "sp", "tp_w4", "tp_u8"}:
        v = serving.serving_forward(st["s8"], vcfg, x)
        for name in ("dp", "tp", "tp_unfused", "sp"):
            ref[name] = (v, v[:short])
        ref["tp_w4"] = serving.serving_forward(st["s4"], vcfg, x)
        ref["tp_u8"] = serving.serving_forward(st["s8"], vcfg, st["xu8"])
    if names & {"swin_tp", "swin_tp_lisoff"}:
        for lis in (True, False):
            sv = serving_swin.serving_forward(st["sstate"], st["sqstate"], scfg, policy, x, lis=lis)
            ref["swin_tp" if lis else "swin_tp_lisoff"] = (sv, sv[:short])
    if names & {"pp1", "pp2", "pp4", "pp_short"}:
        fl = serving.serving_forward(st["s8"], vcfg, x, fuse_layer=True)
        for n_micro in (1, 2, 4):
            ref[f"pp{n_micro}"] = fl
        ref["pp_short"] = fl[:short]
    return ref


def mismatches(got, want) -> int:
    """Elements that differ (bitwise), summed over paired tensors."""
    if isinstance(got, (tuple, list)):
        return sum(mismatches(g, w) for g, w in zip(got, want))
    got, want = got.cpu(), want.cpu()
    if got.shape != want.shape:
        return max(got.numel(), want.numel())
    return int((got != want).sum())


def report(outs: list, ref: dict, st: dict, names=None) -> tuple:
    """(one line per scenario of ``names``, the elements that fail): rank
    0's result against one process's, bit for bit or, for ``ENVELOPES``,
    within its envelope, and every other rank's against rank 0's."""
    lines, bad = [], 0
    for name in [n for n in SCENARIOS + ENVELOPES if names is None or n in names]:
        n = (mismatches(outs[0][name], ref[name]) if name in SCENARIOS
             else outside_envelope(name, outs[0][name], ref[name], st))
        spread = sum(mismatches(o[name], outs[0][name]) for o in outs[1:] if name in o)
        bad += n + spread
        what = ("differ from" if name in SCENARIOS else
                f"(of {mismatches(outs[0][name], ref[name])} that differ at all) lie outside the envelope of")
        lines.append(f"{name}: {n} elements {what} one process, {spread} differ between ranks")
    return lines, bad


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4, help="ranks (even, at least 2)")
    ap.add_argument("--device", default="cpu", help="cpu, or cuda: every rank on cuda:0")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--timeout", type=float, default=600.0, help="seconds before the ranks are killed")
    args = ap.parse_args(argv)
    if args.world < 2 or args.world % 2:
        ap.error("--world must be even and at least 2 (TP runs on (world/2) × 2)")
    dev = pdist.rank_device(args.device)
    st = tiny_states(dev, args.seed)
    t0 = time.time()
    outs = pdist.run_ranks(run_scenarios, args.world, pdist.map_tensors(st, lambda t: t.cpu()),
                           device=dev, timeout_s=args.timeout)
    print(f"{args.world} ranks on {dev} in {time.time() - t0:.1f} s")
    lines, bad = report(outs, references(st), st)
    for line in lines:
        print(f"  {line}")
    print("dryrun: OK" if bad == 0 else f"dryrun: FAIL ({bad} elements differ)")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())

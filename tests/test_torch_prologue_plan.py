"""The two prologue kernels' plans and data flow on the CPU, and the fused
embed's float32-patch arm against JAX.

``csrc/embed_fused.cu`` runs the ViT prologue on the junction kernel's
design: clusters of CS CTAs take row blocks of 64·NC patch rows of the
contiguous (B·NP, K) patch matrix, each CTA a part of C, and patch row m is
stored at token row m + ⌊m/NP⌋ + 1. ``csrc/swin_stem.cu`` holds 4 rows ×
CC channels of the Swin stem's dot in each thread's registers. Both kernels
need the card (``tests/test_torch_cuda_kernels.py``); here: their Python
plans (``embed_plan``, ``stem_plan``) against the C plans' rules, the row
map against the plain version's concatenation, and the float32 arm of the
plain embed against JAX's Pallas kernel in interpret mode, with the serving
path's constants. Every comparison is bit for bit.
"""

import dataclasses
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import vit
from p2vit_tpu.models.common import ViTConfig
from p2vit_tpu.ops.embed_fused import fused_patch_embed as j_embed
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.ops import embed_fused as ef
from p2vit_tpu_torch.ops import matmul_int8
from p2vit_tpu_torch.ops import matmul_ln as ml
from p2vit_tpu_torch.ops import swin_stem

H100_SMS = 132
H100_RESIDENT = (132, 66, 39, 30)  # clusters of 1–4 CTAs one H100 SXM holds at once at one CTA per SM
TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)
_CONSTS = ("patch_requant", "patch_bias", "embed_requant", "s_embed", "pos_val", "cls_xc", "s_qact1", "ln_mask",
           "ln_s1", "ln_w_os", "ln_b_os")


# ---------------------------------------------------------------------------
# embed_plan: the junction kernel's rule over the embed kernel's shared memory
# ---------------------------------------------------------------------------


def _rule_plan(m, c, resident):
    """The C plan's rule written out by enumeration: every (CS, NC) whose CTA
    fits shared memory with two ring stages, BN and cpc of least waste per
    CS (widest BN on a tie), CS > 1 dropped where it wastes more than a CS = 1
    that fits, then the least busiest-consumer load, the smaller CS, the
    smaller NC."""
    c_pad = -(-c // 16) * 16
    cands, waste1 = [], None
    for cs in range(1, 5):
        options = [(-(-c_pad // (cs * bn)) * cs * bn - c_pad, -bn, bn) for bn in ef.WIDTHS]
        waste, _, bn = min(options)
        cpc = -(-c_pad // (cs * bn))
        stages = {nc: ml.ring_stages(ef.embed_smem, bn, cpc, nc, cs) for nc in (1, 2)}
        if cs == 1:
            waste1 = waste if max(stages.values()) >= 2 else None
        if waste1 is not None and waste > waste1:
            continue
        for nc in (1, 2):
            if stages[nc] >= 2:
                blocks = -(-m // (64 * nc))
                load = -(-blocks // resident[cs - 1]) * 64 * cpc * bn
                cands.append((load, cs, nc, bn, cpc, stages[nc], blocks))
    load, cs, nc, bn, cpc, stages, blocks = min(cands)
    return dict(cs=cs, nc=nc, bn=bn, cpc=cpc, stages=stages, blocks=blocks)


@pytest.mark.parametrize("b,c", list(itertools.product([1, 8, 64], [192, 384, 768, 1024, 1536, 2816, 3272])))
def test_embed_plan_follows_the_rule(b, c):
    """At the zoo's 196 patches and K = 768: the plan equals the rule
    enumerated, fits shared memory with two stages or more, its clusters
    cover the padded C with every CTA holding columns, and its persistent
    grid is min(blocks, resident clusters) clusters."""
    m = b * 196
    plan = ef.embed_plan(m, c, 768, H100_SMS, H100_RESIDENT)
    want = _rule_plan(m, c, H100_RESIDENT)
    assert {k: getattr(plan, k) for k in want} == want
    assert plan.c_pad % 16 == 0 and plan.c_pad - 16 < c <= plan.c_pad and plan.k_pad == 768
    assert plan.cs * plan.cols >= plan.c_pad > (plan.cs - 1) * plan.cols
    assert plan.smem_bytes == ef.embed_smem(plan.bn, plan.cpc, plan.nc, plan.stages, plan.cs) <= ef.MAX_SMEM
    assert plan.stages >= 2 and (plan.stages == matmul_int8.MAX_STAGES or ef.embed_smem(
        plan.bn, plan.cpc, plan.nc, plan.stages + 1, plan.cs) > ef.MAX_SMEM)
    assert plan.grid == min(plan.blocks, H100_RESIDENT[plan.cs - 1]) * plan.cs
    assert plan.blocks * plan.rows >= m > (plan.blocks - 1) * plan.rows


def test_embed_plan_forced_and_limits():
    """Each forced (CS, NC) that fits is taken as asked; past C = 3272 and
    at K = 0 the plan raises, naming the limit."""
    for cs, nc in itertools.product(range(1, 5), (1, 2)):
        plan = ef.embed_plan(3 * 196, 384, 768, H100_SMS, H100_RESIDENT, cs=cs, nc=nc)
        assert (plan.cs, plan.nc) == (cs, nc) and plan.smem_bytes <= ef.MAX_SMEM
    with pytest.raises(ValueError, match="C <= 3272"):
        ef.embed_plan(196, 3273, 768, H100_SMS)
    with pytest.raises(ValueError, match="K > 0"):
        ef.embed_plan(196, 384, 0, H100_SMS)


# ---------------------------------------------------------------------------
# The patch-row → token-row map and the kernel's walk
# ---------------------------------------------------------------------------


def _embed_args(rng, b, n_patch, k, c, f32=False):
    """fused_patch_embed arguments as numpy: int8 patch codes (or float32
    patches), int4-valued weights, power-of-two requant scales, PTF s_qact1
    (non-PoT base, masks up to 4), the [CLS] row and LN constants."""
    f = lambda a: np.asarray(a, np.float32)  # noqa: E731
    patches = (rng.randn(b, n_patch, k) * 0.8).astype(np.float32) if f32 else \
        rng.randint(-128, 128, (b, n_patch, k)).astype(np.int8)
    return dict(
        patches=patches, w_q=rng.randint(-8, 8, (c, k)).astype(np.int8),
        patch_requant=f(2.0 ** rng.randint(-10, -6, c)), patch_bias=f(rng.randn(c)),
        embed_requant=f(0.5), s_embed=f(2.0**-4), pos_val=f(rng.randn(n_patch, c) * 0.2),
        cls_xc=rng.randint(-128, 128, (1, c)).astype(np.int8),
        s_qact1=f(0.013 * 2.0 ** rng.randint(0, 3, c)), ln_mask=f(2.0 ** rng.randint(0, 3, c)),
        ln_s1=f(0.013), ln_w_os=f(rng.randn(c) * 8), ln_b_os=f(rng.randn(c) * 4))


@pytest.mark.parametrize("b,n_patch,cs,nc", [(3, 7, 1, 2), (5, 49, 2, 1), (2, 196, 4, 1), (1, 9, 3, 2)])
def test_token_row_map_replays_the_plain_cat(b, n_patch, cs, nc):
    """The kernel's walk over row blocks of 64·NC patch rows, each patch row
    stored at token_row(m) and the [CLS] row at b·(NP + 1), rebuilds the
    plain version's [cls; patches] concatenation at ragged B·NP, every token
    row written once."""
    c = 384  # a width every cluster size splits without waste
    a = {k: torch.from_numpy(v) for k, v in _embed_args(np.random.RandomState(b * n_patch), b, n_patch, 40, c).items()}
    want_xc, want_h = ef.fused_patch_embed_plain(a["patches"], a["w_q"], *(a[k] for k in _CONSTS))
    m = b * n_patch
    plan = ef.embed_plan(m, c, 40, H100_SMS, H100_RESIDENT, cs=cs, nc=nc)
    assert (plan.cs, plan.nc) == (cs, nc)
    flat_xc, flat_h = want_xc.reshape(-1, c), want_h.reshape(-1, c)
    got_xc, got_h = torch.zeros_like(flat_xc), torch.zeros_like(flat_h)
    stores = torch.zeros(b * (n_patch + 1), dtype=torch.int64)
    rows = torch.arange(m)
    patch_rows = flat_xc.reshape(b, n_patch + 1, c)[:, 1:].reshape(m, c)
    patch_h = flat_h.reshape(b, n_patch + 1, c)[:, 1:].reshape(m, c)
    clusters = plan.grid // plan.cs
    for cl in range(clusters):
        for blk in range(cl, plan.blocks, clusters):
            r = rows[blk * plan.rows:(blk + 1) * plan.rows]
            t = ef.token_row(r, n_patch)
            got_xc[t], got_h[t] = patch_rows[r], patch_h[r]
            stores[t] += 1
        for img in range(cl, b, clusters):  # the [CLS] rows of the cluster's images
            got_xc[img * (n_patch + 1)] = a["cls_xc"].reshape(c)
            got_h[img * (n_patch + 1)] = flat_h[img * (n_patch + 1)]
            stores[img * (n_patch + 1)] += 1
    assert (stores == 1).all()
    assert torch.equal(got_xc, flat_xc) and torch.equal(got_h, flat_h)
    # the map itself against the concatenation's row order
    tok = torch.arange(b * (n_patch + 1)).reshape(b, n_patch + 1)[:, 1:].reshape(-1)
    assert torch.equal(ef.token_row(rows, n_patch), tok)


def test_cls_rows_are_one_row_per_image():
    """The [CLS] rows of xc and h are the same in every image (the kernel
    computes the row once per CTA and stores it for its images)."""
    a = {k: torch.from_numpy(v) for k, v in _embed_args(np.random.RandomState(3), 4, 9, 48, 32).items()}
    xc, h = ef.fused_patch_embed_plain(a["patches"], a["w_q"], *(a[k] for k in _CONSTS))
    assert torch.equal(xc[:, 0], a["cls_xc"].expand(4, 32))
    assert (h[:, 0] == h[:1, 0]).all()


# ---------------------------------------------------------------------------
# stem_plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,cc", [(96, 6), (128, 8), (192, 12), (256, 16)])
def test_stem_plan(c, cc):
    """Swin-T/S (96), Swin-B (128) and two wider stems at K = 48, batch 64:
    CC = C/16 channels a thread, fewer than one shared-memory load per
    product, the CTA's shared memory within the card's, a persistent grid."""
    m = 64 * 3136
    plan = swin_stem.stem_plan(m, 48, c, H100_SMS, 3)
    assert (plan.cc, plan.c_pad, plan.k_pad) == (cc, c, 48)
    assert plan.smem_bytes == swin_stem.stem_smem(48, c) <= swin_stem.MAX_STEM_SMEM
    assert plan.blocks == m // 64 and plan.grid == H100_SMS * 3
    g = 4 if cc % 4 == 0 else 2
    assert plan.loads_per_product == (4 + 4 * cc / g) / (16 * cc) < 0.2


def test_stem_plan_pads_and_refuses():
    """C and K off the kernel's grid are padded (C = 100 → 128, K = 50 →
    52); past C = 4096 (sixteen CTAs of 256 channels) or where the weight
    and the two row buffers do not fit shared memory the plan raises, naming
    C <= 4096."""
    plan = swin_stem.stem_plan(777, 50, 100)
    assert (plan.cc, plan.c_pad, plan.k_pad, plan.blocks) == (8, 128, 52, 13)
    for c, k in ((4097, 48), (256, 200)):
        with pytest.raises(ValueError, match="C <= 4096"):
            swin_stem.stem_plan(100, k, c)


# ---------------------------------------------------------------------------
# The float32-patch arm against JAX's kernel
# ---------------------------------------------------------------------------


def _jax_embed(a, s_input):
    kw = {k: jnp.asarray(a[k]) for k in _CONSTS}
    return j_embed(jnp.asarray(a["patches"]), jnp.asarray(a["w_q"]), s_input, interpret=True, **kw)


@pytest.mark.parametrize("s_input,edges", [(2.0**-6, True), (0.013, True), (0.0271, False)])
def test_f32_arm_plain_matches_jax(s_input, edges):
    """float32 patches quantized as clip(round(x / s_input)) by a true
    divide: the plain version against JAX's Pallas kernel in interpret mode,
    0 codes differ. ``edges``: a third of the patch values placed on the
    round-half edges, x = fl((n + 0.5)·s_input) (exact halves where s_input
    is a power of two)."""
    rng = np.random.RandomState(int(s_input * 1e4))
    a = _embed_args(rng, 3, 9, 48, 32, f32=True)
    if edges:
        half = ((rng.randint(-140, 140, a["patches"].shape) + 0.5) * np.float32(s_input)).astype(np.float32)
        a["patches"] = np.where(rng.rand(*a["patches"].shape) < 1 / 3, half, a["patches"]).astype(np.float32)
    xc_j, h_j = _jax_embed(a, np.float32(s_input))
    xc_t, h_t = ef.fused_patch_embed_plain(torch.from_numpy(a["patches"]), torch.from_numpy(a["w_q"]),
                                           *(torch.from_numpy(np.asarray(a[k])) for k in _CONSTS),
                                           s_input=torch.tensor(s_input, dtype=torch.float32))
    np.testing.assert_array_equal(xc_t.numpy(), np.asarray(xc_j))
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    # and the arm's codes are those of the int8 arm on the quantized patches
    q = ef.input_codes_plain(torch.from_numpy(a["patches"]), s_input)
    xc_i, h_i = ef.fused_patch_embed_plain(q, torch.from_numpy(a["w_q"]),
                                           *(torch.from_numpy(np.asarray(a[k])) for k in _CONSTS))
    assert torch.equal(xc_i, xc_t) and torch.equal(h_i, h_t)


def test_f32_arm_padding_and_refusal():
    """The float32 arm zero-pads K like the int8 arm (zero patches quantize
    to zero codes) and refuses float32 patches without s_input."""
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in
         _embed_args(np.random.RandomState(11), 2, 5, 40, 24, f32=True).items()}
    want = ef.fused_patch_embed_plain(a["patches"], a["w_q"], *(a[k] for k in _CONSTS), s_input=0.02)
    vecs, scal = ef.embed_consts(24, torch.device("cpu"), a["patch_requant"], a["patch_bias"], a["s_qact1"],
                                 a["ln_mask"], a["ln_w_os"], a["ln_b_os"], a["embed_requant"], a["s_embed"],
                                 a["ln_s1"])
    pp, wp, vp, pos, cls = ef.embed_pad(a["patches"], a["w_q"], vecs, a["pos_val"], a["cls_xc"].reshape(24))
    assert pp.dtype == torch.float32 and pp.shape[-1] == 48 and wp.shape == (32, 48)
    got = ef.embed_codes_plain(pp, wp, vp, scal, pos, cls, c_true=24, s_input=0.02)
    assert torch.equal(got[0][..., :24], want[0]) and torch.equal(got[1][..., :24], want[1])
    with pytest.raises(ValueError, match="s_input"):
        ef.fused_patch_embed(a["patches"], a["w_q"], *(a[k] for k in _CONSTS))


@pytest.fixture(scope="module")
def converted():
    params = vit.init_params(jax.random.PRNGKey(0), TINY)
    x = np.random.RandomState(7).randn(3, 3, 32, 32).astype(np.float32)
    policy = make_policy()
    calib = vit.calibrate(params, TINY, policy, jnp.asarray(x))
    bits = [4] * TINY.num_matmuls
    js = jserving.convert(params, calib.qstate, TINY, policy, bits)
    tcfg = tcommon.ViTConfig(**dataclasses.asdict(TINY))
    ts = tserving.convert(interop.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu"),
                          interop.qstate_from_numpy(jax.tree.map(np.asarray, calib.qstate), device="cpu"),
                          tcfg, tmake_policy(), bits)
    return js, ts, tcfg, x


def test_serving_consts_carry_s_input_and_embed_codes_match_jax(converted):
    """``_embed_fused_consts`` passes ``s_input`` as JAX's does; the serving
    prologue (int8 patches, quantized before extraction) still equals JAX's
    fused path at TINY, and so does the float32 arm on the raw patches with
    the same constants."""
    js, ts, tcfg, x = converted
    k_t, k_j = tserving._embed_fused_consts(ts, tcfg), jserving._embed_fused_consts(js, TINY)
    assert set(k_t) == set(k_j)
    assert float(k_t["s_input"]) == float(np.asarray(k_j["s_input"]))
    h_t, xc_t = tserving.embed_codes(ts, tcfg, torch.from_numpy(x), use_kernels=False)
    h_j, xc_j = jserving.embed_codes(js, TINY, jnp.asarray(x), use_pallas=True, interpret=True)
    np.testing.assert_array_equal(h_t.numpy(), np.asarray(h_j))
    np.testing.assert_array_equal(xc_t.numpy(), np.asarray(xc_j))
    from p2vit_tpu_torch.models.common import extract_patches

    patches = extract_patches(torch.from_numpy(x), tcfg.patch_size).contiguous()
    xc_f, h_f = ef.fused_patch_embed(patches, ts["patch"]["w_q"], **k_t)
    assert torch.equal(xc_f, xc_t) and torch.equal(h_f, h_t)


def test_prologue_bench_on_the_cpu():
    """The measurement tool with ``--device cpu``: the plain versions only,
    one line per shape with its bound and no device time; without
    ``--device cpu`` and without a card it refuses to run."""
    from p2vit_tpu_torch.tools import prologue_bench as pb

    lines = pb.main(["--device", "cpu", "--batches", "1", "--models", "deit_tiny,swin_tiny"])
    assert [(ln["kernel"], ln["batch"]) for ln in lines] == [("fused_patch_embed", 1), ("fused_swin_stem", 1)]
    assert all("device_us" not in ln and ln["bound_us"] > 0 for ln in lines)
    assert lines[1]["mul_add_ceiling_us"] == pytest.approx(2 * lines[1]["bound_us"], rel=1e-2)
    if not torch.cuda.is_available():
        with pytest.raises(SystemExit, match="needs a CUDA device"):
            pb.main(["--batches", "1"])

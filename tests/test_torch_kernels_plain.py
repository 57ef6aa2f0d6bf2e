"""The plain PyTorch versions of the four serving kernels against the JAX
package: its Pallas kernels run with ``interpret=True`` and its jnp twins,
on the same seeded numpy inputs, with random power-of-two scales.

Stated bounds (measured on these inputs, and on DeiT-S-width sweeps: 0 LIS
code flips in 4.2M codes at N=197, 0 LN flips in 3 full-width junctions
whose Σx² rows all exceed 2^24): every comparison here is bit for bit,
LIS codes included. The CUDA kernels are held against these plain versions
on the card (``chip_smoke.py``, ``tests/test_torch_cuda_kernels.py``).
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu import serving as jserving
from p2vit_tpu.config import make_policy
from p2vit_tpu.models import vit
from p2vit_tpu.models.common import ViTConfig, extract_patches
from p2vit_tpu.ops.attention_lis import lis_attention_qkv_fused as j_attn
from p2vit_tpu.ops.attention_lis import lis_attention_ref
from p2vit_tpu.ops.embed_fused import fused_patch_embed as j_embed
from p2vit_tpu.ops.matmul_int8 import int8_matmul_requant as j_mm
from p2vit_tpu.ops.matmul_int8 import int8_matmul_requant_ref
from p2vit_tpu.ops.matmul_ln import int8_matmul_res_ln as j_resln
from p2vit_tpu.ops.matmul_ln import int8_matmul_res_ln_ref
from p2vit_tpu_torch import interop
from p2vit_tpu_torch import serving as tserving
from p2vit_tpu_torch.config import make_policy as tmake_policy
from p2vit_tpu_torch.models import common as tcommon
from p2vit_tpu_torch.ops import _lib, attention_lis, embed_fused, matmul_int8, matmul_ln

TINY = ViTConfig(img_size=32, patch_size=8, num_classes=16, embed_dim=32, depth=2, num_heads=2)


def T(a):
    return torch.from_numpy(np.array(a, copy=True))


def n_diff(a, b):
    return int((np.asarray(a).astype(np.int32) != np.asarray(b).astype(np.int32)).sum())


def _mm_inputs(seed, m=70, k=96, n=130, gelu=False):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    if gelu:  # accumulators scaled into the erf's sensitive range |y| < 4
        w = rng.randint(-8, 8, (n, k)).astype(np.int8)
        r = (2.0 ** rng.randint(-14, -10, n)).astype(np.float32)
    else:
        w = rng.randint(-128, 128, (n, k)).astype(np.int8)
        r = (2.0 ** rng.randint(-12, -4, n)).astype(np.float32)
    b = (rng.randn(n) * (0.5 if gelu else 1.0)).astype(np.float32)
    return x, w, r, b


@pytest.mark.parametrize("gelu", [False, True])
def test_int8_matmul_requant_plain_vs_jax(gelu):
    x, w, r, b = _mm_inputs(0, gelu=gelu)
    kw = dict(out_inv=32.0, gelu=True) if gelu else {}
    t = matmul_int8.int8_matmul_requant_plain(T(x), T(w), T(r), T(b), **kw)
    j = j_mm(x, w, r, b, block_m=128, block_n=128, interpret=True, **kw)
    jr = int8_matmul_requant_ref(x, w, r, b, **kw)
    assert t.dtype == torch.int8 and t.shape == (70, 130)
    assert n_diff(j, t) == 0 and n_diff(jr, t) == 0
    if gelu:
        assert len(np.unique(t.numpy())) > 50  # the erf chain was exercised


def test_gelu_epilogue_wide_sweep_vs_ref():
    """The A&S erf-GELU epilogue against the JAX twin on 590k accumulators:
    0 flips (the port's exp is float64-rounded, XLA's float32 exp differs by
    an ulp on ~10% of inputs, yet no code lands on a knife edge here)."""
    x, w, r, b = _mm_inputs(1, m=256, k=384, n=384, gelu=True)
    t = matmul_int8.int8_matmul_requant_plain(T(x), T(w), T(r), T(b), out_inv=32.0, gelu=True)
    assert n_diff(int8_matmul_requant_ref(x, w, r, b, out_inv=32.0, gelu=True), t) == 0


def _res_ln_inputs(seed, m, k, n, wrange=128):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-wrange, wrange, (n, k)).astype(np.int8)
    r = (2.0 ** rng.randint(-12, -6, n)).astype(np.float32)
    bias = rng.randn(n).astype(np.float32)
    res = rng.randint(-128, 128, (m, n)).astype(np.int8)
    s_mid = (np.abs(rng.randn(n)) * 0.02 + 0.01).astype(np.float32)
    s_res = (0.011 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)
    s_out = (0.013 * 2.0 ** rng.randint(0, 4, n)).astype(np.float32)
    ln_w = rng.randn(n).astype(np.float32)
    ln_b = (rng.randn(n) * 0.1).astype(np.float32)
    ln_out = (np.abs(rng.randn(n)) * 0.03 + 0.01).astype(np.float32)
    ratio = (2.0 ** rng.randint(-1, 2, n)).astype(np.float32)
    return (x, w, r, bias, res, s_mid, s_res, s_out, ln_w, ln_b, ln_out, ratio)


def test_int8_matmul_res_ln_plain_vs_jax():
    args = _res_ln_inputs(2, 64, 96, 128)
    t = matmul_ln.int8_matmul_res_ln_plain(*map(T, args))
    j = j_resln(*args, interpret=True)
    jr = int8_matmul_res_ln_ref(*args)
    for i in range(2):
        assert t[i].dtype == torch.int8
        assert n_diff(j[i], t[i]) == 0 and n_diff(jr[i], t[i]) == 0


@pytest.mark.parametrize("k", [384, 1536])
def test_res_ln_full_width_deit_s_junction(k):
    """One DeiT-S junction at full width (M = 2·197, C = 384; K = 384 proj,
    1536 fc2): the plain version against ``int8_matmul_res_ln_ref``. Stated
    flip bound: 0 (the port's LN row sums are exact integers; the twin's
    float32 sums pass 2^24 on every row here and still agree)."""
    args = _res_ln_inputs(3, 394, k, 384, wrange=8)
    t = matmul_ln.int8_matmul_res_ln_plain(*map(T, args))
    jr = int8_matmul_res_ln_ref(*args)
    x = t[0].numpy().astype(np.int64) * np.round(args[7] / args[7].min()).astype(np.int64)
    assert ((x * x).sum(1) > 2**24).mean() > 0.5
    assert n_diff(jr[0], t[0]) == 0
    assert n_diff(jr[1], t[1]) == 0


def _attn_inputs(seed, b=2, n=33, c=128, heads=2):
    rng = np.random.RandomState(seed)
    h = rng.randint(-128, 128, (b, n, c)).astype(np.int8)
    w = rng.randint(-128, 128, (3 * c, c)).astype(np.int8)
    rv = (2.0 ** rng.randint(-13, -10, 3 * c)).astype(np.float32)
    bv = rng.randn(3 * c).astype(np.float32)
    return h, w, rv, bv, heads


def _attn_staged_ref(h, w, rv, bv, heads, sr, sa, ro):
    b, n, c = h.shape
    d = c // heads
    qkv = np.asarray(int8_matmul_requant_ref(h.reshape(-1, c), w, rv, bv))
    qkv = qkv.reshape(b, n, 3, heads, d).transpose(2, 0, 3, 1, 4).reshape(3, b * heads, n, d)
    av = np.asarray(lis_attention_ref(qkv[0], qkv[1], qkv[2], sr, sa, ro))
    return av.reshape(b, heads, n, d).transpose(0, 2, 1, 3).reshape(b, n, c)


@pytest.mark.parametrize("scales", [(2.0**-11, 0.0625, 0.25), (2.0**-12, 2.0**-11, 1.0)])
def test_lis_attention_qkv_fused_plain_vs_jax(scales):
    """Against the JAX qkv-fused kernel (interpret) and the staged twins
    (requant matmul → lis_attention_ref). s_attn = 2^-11 is the scale a
    random-init model calibrates to, where exp_sum exceeds 2^63 at N=197."""
    h, w, rv, bv, heads = _attn_inputs(4)
    sr, sa, ro = scales
    t = attention_lis.lis_attention_qkv_fused_plain(T(h), T(w), T(rv), T(bv), heads, sr, sa, ro)
    j = j_attn(h, w, rv, bv, heads, sr, sa, ro, images_per_step=2, interpret=True)
    assert t.shape == (2, 33, 128) and t.dtype == torch.int8
    assert n_diff(j, t) == 0
    assert n_diff(_attn_staged_ref(h, w, rv, bv, heads, sr, sa, ro), t) == 0


def test_lis_codes_deit_s_width_vs_jax():
    """LIS at DeiT-S geometry (N = 197, d = 64) through the staged JAX twin:
    0 output flips at the random-init scale s_attn = 2^-11."""
    h, w, rv, bv, heads = _attn_inputs(5, b=1, n=197, c=384, heads=6)
    sr, sa, ro = 2.0**-12, 2.0**-11, 1.0
    t = attention_lis.lis_attention_qkv_fused_plain(T(h), T(w), T(rv), T(bv), heads, sr, sa, ro)
    assert n_diff(_attn_staged_ref(h, w, rv, bv, heads, sr, sa, ro), t) == 0


def _exact_f32(v: int) -> float:
    """Round a non-negative Python int to float32, half to even."""
    nb = v.bit_length()
    if nb <= 24:
        return float(v)
    shift = nb - 24
    q, rem = divmod(v, 1 << shift)
    half = 1 << (shift - 1)
    if rem > half or (rem == half and q & 1):
        q += 1
    return math.ldexp(q, shift)


def test_exact_sum_f32_matches_big_int_sum():
    rng = np.random.RandomState(6)
    mant = rng.randint(0, 1 << 24, (64, 197)).astype(np.float32)
    expo = rng.randint(0, 33, (64, 197))
    t = (mant * 2.0**expo).astype(np.float32)
    # rows summing past 2^63: terms in [1.5·2^55, 2^56)
    t[:8] = (rng.randint(3 << 22, 1 << 24, (8, 197)) * 2.0**32).astype(np.float32)
    got = attention_lis.exact_sum_f32(T(t)).numpy()[:, 0]
    want = np.array([_exact_f32(sum(int(v) for v in row)) for row in t], np.float32)
    np.testing.assert_array_equal(got, want)
    assert (want[:8] > 2.0**63).all()


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


def test_fused_patch_embed_plain_vs_jax(converted):
    """Against the JAX fused kernel (interpret, int8 patches) and the staged
    ``embed_codes(use_pallas=False)`` path, on a converted TINY state."""
    js, ts, tcfg, x = converted
    h_t, xc_t = tserving.embed_codes(ts, tcfg, T(x), use_kernels=False)
    h_s, xc_s = jserving.embed_codes(js, TINY, jnp.asarray(x), use_pallas=False)
    k = jserving._embed_fused_consts(js, TINY)
    patches = extract_patches(jserving._input_codes(js, jnp.asarray(x)), TINY.patch_size)
    xc_j, h_j = j_embed(patches, js["patch"]["w_q"], interpret=True, **k)
    for a, b in ((h_s, h_t), (xc_s, xc_t), (h_j, h_t), (xc_j, xc_t)):
        assert n_diff(a, b) == 0
    assert h_t.shape == xc_t.shape == (3, 17, 32)


def test_wrappers_dispatch_plain_on_cpu_and_count_no_launches():
    x, w, r, b = _mm_inputs(8)
    before = matmul_int8.int8_matmul_requant.launches
    out = matmul_int8.int8_matmul_requant(T(x), T(w), T(r), T(b))
    torch.testing.assert_close(out, matmul_int8.int8_matmul_requant_plain(T(x), T(w), T(r), T(b)),
                               rtol=0, atol=0)
    assert matmul_int8.int8_matmul_requant.launches == before
    args = _res_ln_inputs(9, 16, 32, 32)
    got = matmul_ln.int8_matmul_res_ln(*map(T, args))
    want = matmul_ln.int8_matmul_res_ln_plain(*map(T, args))
    assert all(torch.equal(g, w_) for g, w_ in zip(got, want))
    # nothing was built or loaded for CPU tensors
    assert _lib.library.cache_info().currsize == 0


def test_wrappers_reject_mixed_devices():
    x, w, r, b = _mm_inputs(10)
    with pytest.raises(ValueError, match="different devices"):
        matmul_int8.int8_matmul_requant(T(x), T(w).to("meta"), T(r), T(b))
    h, wq, rv, bv, heads = _attn_inputs(11)
    with pytest.raises(ValueError, match="different devices"):
        attention_lis.lis_attention_qkv_fused(T(h), T(wq).to("meta"), T(rv), T(bv), heads, 1.0, 1.0, 1.0)


def test_check_lis_scale_bound():
    attention_lis.check_lis_scale(2.0**-20)
    with pytest.raises(ValueError, match="2\\^-20"):
        attention_lis.check_lis_scale(2.0**-21)


def test_embed_consts_match_between_kernel_and_plain(converted):
    """The kernel wrapper and the plain version form their constants in one function."""
    _, ts, tcfg, _ = converted
    k = tserving._embed_fused_consts(ts, tcfg)
    vecs, scal = embed_fused.embed_consts(32, torch.device("cpu"), k["patch_requant"], k["patch_bias"],
                                          k["s_qact1"], k["ln_mask"], k["ln_w_os"], k["ln_b_os"],
                                          k["embed_requant"], k["s_embed"], k["ln_s1"])
    assert vecs.shape == (6, 32) and scal.shape == (3,)
    assert set(np.unique(vecs[3].numpy())) <= {1.0, 2.0, 4.0, 8.0}  # PTF mask row

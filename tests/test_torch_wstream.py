"""The weight-streaming bf16 matmul: the port's packers and the plain version
of ``wstream_matmul`` against the JAX package's, on the same inputs (the
Pallas kernel in interpret mode, and its jnp twin ``wstream_ref``).

The port's numerics contract (ops/matmul_wstream.py): each panel's sum exact
(float64), rounded once to float32, the panels added in order. JAX sums in
float32 in XLA's order, so the two agree within JAX's own envelope, ≤ 1 bf16
ulp without GELU and ≤ 2 with it. Measured on JAX's own draws
(tests/test_wstream.py ``_case``): max 1 against the JAX kernel, against
the panel-matched twin and against the single-dot twin, in every format,
with and without GELU; 0 at (5, 200, 70) and, without GELU, at
(197, 384, 1152).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.ops import matmul_wstream as jws
from p2vit_tpu_torch.ops import matmul_wstream as tws

FORMATS = (("bf16", 1), ("i8", 1), ("w8p", 4), ("w4p", 8))
J_PACK = {"bf16": lambda a: jnp.asarray(a).astype(jnp.bfloat16), "i8": jnp.asarray,
          "w8p": lambda a: jws.pack_w8(jnp.asarray(a)), "w4p": lambda a: jws.pack_w4(jnp.asarray(a))}
T_PACK = {"bf16": lambda a: torch.from_numpy(np.array(a)).to(torch.bfloat16), "i8": lambda a: torch.from_numpy(np.array(a)),
          "w8p": lambda a: tws.pack_w8(torch.from_numpy(np.array(a))),
          "w4p": lambda a: tws.pack_w4(torch.from_numpy(np.array(a)))}


def _key(x):
    u = np.asarray(x).view(np.uint16).astype(np.int32)
    return np.where(u & 0x8000, 0x8000 - (u & 0x7FFF) - 1, u + 0x8000)


def _ulp(a, b):
    """Per-element bf16 ulp distance (0 == bitwise)."""
    return np.abs(_key(a) - _key(b))


def _np_bf16(t: torch.Tensor):
    return t.view(torch.int16).numpy().view(np.uint16).view(jnp.bfloat16)


def _jax_case(seed, m, k, n):
    """tests/test_wstream.py's draws, as numpy arrays for both packages."""
    kx, kw, kr, kb = jax.random.split(jax.random.PRNGKey(seed), 4)
    x = jax.random.normal(kx, (m, k), jnp.float32).astype(jnp.bfloat16)
    w = jax.random.randint(kw, (n, k), -8, 8, jnp.int8)
    r = 2.0 ** jax.random.randint(kr, (n,), -9, -5).astype(jnp.float32)
    b = jax.random.normal(kb, (n,), jnp.float32)
    return np.asarray(x.astype(jnp.float32)), np.asarray(w), np.asarray(r), np.asarray(b)


def _port(x, w, r, b, fmt, gelu):
    xt = torch.from_numpy(np.array(x)).to(torch.bfloat16)
    return _np_bf16(tws.wstream_matmul_plain(xt, T_PACK[fmt](w), torch.from_numpy(r),
                                             torch.from_numpy(b), w_format=fmt, gelu=gelu))


@pytest.mark.parametrize("k", [384, 1536, 200, 3072])
def test_packers_bitwise_vs_jax(k):
    """pack_w8 on full-range int8 codes, pack_w4 on int4 codes, with the
    panel pad at K = 200 and 384."""
    rng = np.random.RandomState(k)
    w8 = rng.randint(-128, 128, (40, k)).astype(np.int8)
    w4 = rng.randint(-8, 8, (40, k)).astype(np.int8)
    for fn_t, fn_j, w in ((tws.pack_w8, jws.pack_w8, w8), (tws.pack_w4, jws.pack_w4, w4)):
        got = fn_t(torch.from_numpy(w))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(fn_j(jnp.asarray(w))))
    for fmt, w in (("w8p", w8), ("w4p", w4)):
        codes = tws.unpack_store(T_PACK[fmt](w), fmt)
        np.testing.assert_array_equal(codes[:, :k].numpy(), w.astype(np.float64))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n", [(197, 384, 1152), (197, 1536, 384), (5, 200, 70)])
def test_plain_vs_jax_kernel_and_twins(m, k, n, gelu):
    x, w, r, b = _jax_case(k * n + m, m, k, n)
    jx, jr, jb = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(r), jnp.asarray(b)
    single = jws.wstream_ref(jx, jnp.asarray(w), jr, jb, gelu=gelu)
    tol = 1  # measured max, every format: 1 (module docstring); JAX allows 2 with GELU
    for fmt, panels in FORMATS:
        got = _port(x, w, r, b, fmt, gelu)
        assert got.shape == (m, n)
        kern = jws.wstream_matmul(jx, J_PACK[fmt](w), jr, jb, w_format=fmt, gelu=gelu, interpret=True)
        twin = jws.wstream_ref(jx, jnp.asarray(w), jr, jb, gelu=gelu, panels=panels)
        for name, want in (("kernel", kern), ("twin", twin), ("single", single)):
            assert _ulp(got, want).max() <= tol, (fmt, name)


def test_w8p_full_range_codes_vs_jax():
    """w8p carries full int8 codes (JAX's own case, tests/test_wstream.py,
    where the JAX kernel equals its panel twin bit for bit): the port's exact
    panel sums differ from JAX's float32 ones at 1 of 8,448 outputs, by 1
    ulp."""
    kx, kw = jax.random.split(jax.random.PRNGKey(7))
    x = np.asarray(jax.random.normal(kx, (33, 384), jnp.float32).astype(jnp.bfloat16).astype(jnp.float32))
    w = np.asarray(jax.random.randint(kw, (256, 384), -128, 128, jnp.int8))
    r = np.full((256,), 2.0 ** -7, np.float32)
    b = np.zeros((256,), np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    got = _port(x, w, r, b, "w8p", False)
    kern = jws.wstream_matmul(jx, jws.pack_w8(jnp.asarray(w)), jnp.asarray(r), jnp.asarray(b),
                              w_format="w8p", interpret=True)
    twin = jws.wstream_ref(jx, jnp.asarray(w), jnp.asarray(r), jnp.asarray(b), panels=4)
    np.testing.assert_array_equal(_key(kern), _key(twin))
    d = _ulp(got, kern)
    assert int((d != 0).sum()) == 1 and d.max() == 1


def test_near_zero_outputs_on_a_numpy_draw():
    """Where S·r + b nearly cancels, a bf16 ulp is small and float32 order
    error shows: on this numpy draw at (197, 1536, 384) the single-panel
    stores (bf16, i8) sit 2 ulp from the JAX kernel at 1 output, whose value
    is -6.02e-6 (the JAX packed kernels are themselves 2 ulp from JAX's
    single-dot twin on this draw, and equal the port's). Everywhere else
    ≤ 1."""
    m, k, n = 197, 1536, 384
    rng = np.random.RandomState(k * n + m)
    x = rng.randn(m, k).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    x = np.asarray(jx.astype(jnp.float32))
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    r = (2.0 ** rng.randint(-9, -5, n)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    for fmt, _ in FORMATS:
        got = _port(x, w, r, b, fmt, False)
        kern = jws.wstream_matmul(jx, J_PACK[fmt](w), jnp.asarray(r), jnp.asarray(b), w_format=fmt,
                                  interpret=True)
        d = _ulp(got, kern)
        far = d > 1
        assert int(far.sum()) == (1 if fmt in ("bf16", "i8") else 0), fmt
        assert d.max() <= 2
        assert (np.abs(np.asarray(got, np.float32))[far] < 2.0 ** -16).all()


def test_pack_w4_rejects_out_of_range():
    with pytest.raises(ValueError, match=r"\[-8, 7\]"):
        tws.pack_w4(torch.full((4, 256), 100, dtype=torch.int8))


def test_rejects_bad_format_and_store_width():
    """The JAX wrapper's checks and messages (tests/test_wstream.py)."""
    x, w, r, b = (torch.from_numpy(a) for a in _jax_case(0, 8, 1536, 32))
    x = x.to(torch.bfloat16)
    for fn in (tws.wstream_matmul, tws.wstream_matmul_plain):
        with pytest.raises(ValueError, match="unknown w_format"):
            fn(x, w, r, b, w_format="nope")
        with pytest.raises(ValueError, match="words/row"):
            fn(x, tws.pack_w8(w), r, b, w_format="w4p")
        with pytest.raises(ValueError, match="cols; x has K"):
            fn(x, w[:, :384], r, b, w_format="i8")
        with pytest.raises(ValueError, match="rows; row_scale"):
            fn(x, w[:16], r, b, w_format="i8")


def test_panel_len_lane_quantum():
    assert tws.panel_len(384, 4) == 128
    assert tws.panel_len(1536, 4) == 384
    assert tws.panel_len(1536, 8) == 256
    assert tws.panel_len(3072, 8) == 384
    for k, p in ((384, 4), (1536, 4), (1536, 8), (3072, 8), (200, 1)):
        assert tws.panel_len(k, p) == jws._panel_len(k, p)


def test_wrapper_takes_the_plain_version_on_cpu():
    x, w, r, b = (torch.from_numpy(a) for a in _jax_case(1, 12, 384, 96))
    tws.wstream_matmul.launches = 0
    for fmt, _ in FORMATS:
        store = T_PACK[fmt](w.numpy())
        got = tws.wstream_matmul(x, store, r, b, w_format=fmt, gelu=True)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.view(torch.int16),
                           tws.wstream_matmul_plain(x, store, r, b, fmt, True).view(torch.int16))
    assert tws.wstream_matmul.launches == 0

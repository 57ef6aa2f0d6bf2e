"""The int4-packed weight store: the port's ``pack_int4`` and the plain
version of ``int4_matmul_requant`` against the JAX package's, on the same
seeded numpy inputs (the Pallas kernel in interpret mode).

The accumulation is exact integer arithmetic, so every comparison is bit for
bit, including K = 260, where the JAX wrapper pads each half-K panel (130)
to its lane width and the port's CUDA wrapper to 16 codes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from p2vit_tpu.ops.matmul_int8 import int4_matmul_requant as j_int4
from p2vit_tpu.ops.matmul_int8 import int8_matmul_requant_ref
from p2vit_tpu.ops.matmul_int8 import pack_int4 as j_pack_int4
from p2vit_tpu_torch.ops import matmul_int8


def _case(seed, m, k, n):
    rng = np.random.RandomState(seed)
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    w = rng.randint(-8, 8, (n, k)).astype(np.int8)
    r = (2.0 ** rng.randint(-12, -6, n)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    return x, w, r, b


@pytest.mark.parametrize("k", [96, 260, 384, 1536])
def test_pack_int4_bitwise_vs_jax(k):
    w = np.random.RandomState(k).randint(-8, 8, (33, k)).astype(np.int8)
    got = matmul_int8.pack_int4(torch.from_numpy(w))
    assert got.dtype == torch.int8 and got.shape == (33, k // 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_pack_int4(jnp.asarray(w))))
    np.testing.assert_array_equal(matmul_int8.unpack_int4(got).numpy(), w)


def test_pack_int4_rejects_what_it_cannot_pack():
    with pytest.raises(ValueError, match="int4 codes"):
        matmul_int8.pack_int4(torch.full((4, 8), -100, dtype=torch.int8))
    with pytest.raises(ValueError, match="int4 codes"):
        matmul_int8.pack_int4(torch.full((4, 8), 8, dtype=torch.int8))
    with pytest.raises(ValueError, match="even K"):
        matmul_int8.pack_int4(torch.zeros((4, 7), dtype=torch.int8))


@pytest.mark.parametrize("gelu", [False, True])
@pytest.mark.parametrize("m,k,n", [(64, 96, 48), (70, 260, 33)])
def test_int4_matmul_requant_plain_bitwise_vs_jax_kernel(m, k, n, gelu):
    """JAX's own cases (tests/test_serving.py): the plain version equals the
    JAX kernel (interpret) and the int8-store reference, plain and with the
    GELU epilogue at out_inv = 16."""
    x, w, r, b = _case(3 + k, m, k, n)
    kw = dict(out_inv=16.0, gelu=True) if gelu else {}
    jx, jw, jr, jb = map(jnp.asarray, (x, w, r, b))
    want = np.asarray(j_int4(jx, j_pack_int4(jw), jr, jb, interpret=True, **kw))
    np.testing.assert_array_equal(want, np.asarray(int8_matmul_requant_ref(jx, jw, jr, jb, **kw)))
    packed = matmul_int8.pack_int4(torch.from_numpy(w))
    got = matmul_int8.int4_matmul_requant_plain(torch.from_numpy(x), packed, torch.from_numpy(r),
                                                torch.from_numpy(b), **kw)
    assert got.dtype == torch.int8 and got.shape == (m, n)
    np.testing.assert_array_equal(got.numpy(), want)


def test_int4_wrapper_takes_the_plain_version_on_cpu():
    x, w, r, b = map(torch.from_numpy, _case(5, 40, 384, 72))
    packed = matmul_int8.pack_int4(w)
    matmul_int8.int4_matmul_requant.launches = 0
    got = matmul_int8.int4_matmul_requant(x, packed, r, b, out_inv=8.0, gelu=True)
    assert torch.equal(got, matmul_int8.int8_matmul_requant(x, w, r, b, out_inv=8.0, gelu=True))
    assert matmul_int8.int4_matmul_requant.launches == 0
    with pytest.raises(ValueError, match="K/2 bytes"):
        matmul_int8.int4_matmul_requant(x, packed[:, :100], r, b)

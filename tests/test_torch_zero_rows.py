"""Rows of zero codes through the port's LN junction, against the JAX
package.

A row of zero residual codes has LN constants 0/0, so its LN value is NaN;
JAX's kernel (in interpret mode) and its jnp twin cast it to code 0, and the
plain ``int8_matmul_res_ln`` must do the same, bit for bit: the CUDA
junction and ``fused_vit_layer`` are held against it on the card
(``tests/test_torch_cuda_kernels.py::test_int8_matmul_res_ln_kernel``'s
``zero_rows`` case, ``::test_serving_forward_synthetic_state``).
"""

import numpy as np
import pytest
import torch

from p2vit_tpu.ops.matmul_ln import int8_matmul_res_ln as j_resln
from p2vit_tpu.ops.matmul_ln import int8_matmul_res_ln_ref
from p2vit_tpu_torch.ops import matmul_ln

ZERO = [0, 31, 63]


def _inputs(seed, m, k, n):
    rng = np.random.RandomState(seed)
    pot = lambda lo, hi: (2.0 ** rng.randint(lo, hi, n)).astype(np.float32)  # noqa: E731
    x = rng.randint(-128, 128, (m, k)).astype(np.int8)
    res = rng.randint(-128, 128, (m, n)).astype(np.int8)
    x[ZERO], res[ZERO] = 0, 0
    return (x, rng.randint(-8, 8, (n, k)).astype(np.int8), pot(-10, -6), np.zeros(n, np.float32), res,
            (np.abs(rng.randn(n)) * 0.02 + 0.01).astype(np.float32), (0.011 * pot(0, 4)).astype(np.float32),
            (0.013 * pot(0, 4)).astype(np.float32), rng.randn(n).astype(np.float32),
            (rng.randn(n) * 0.1).astype(np.float32), (np.abs(rng.randn(n)) * 0.03 + 0.01).astype(np.float32),
            pot(-1, 2))


@pytest.mark.parametrize("n", [128, 384])
def test_res_ln_zero_rows_vs_jax(n):
    """Three rows of zero x and residual codes under a zero bias: zero
    residual codes and LN codes 0 in all three packages' versions; every
    code equal."""
    args = _inputs(n, 64, 32, n)
    got = matmul_ln.int8_matmul_res_ln_plain(*(torch.from_numpy(a) for a in args))
    for want in (j_resln(*args, interpret=True), int8_matmul_res_ln_ref(*args)):
        for g, w in zip(got, want):
            assert g.dtype == torch.int8
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not got[0][ZERO].any() and not got[1][ZERO].any()

"""The port's LU slice held against the JAX package on the CPU (its
Pallas kernels in interpret mode): lu_decomp on square and rectangular
shapes over one and two panels, lu_solve with leading-dim broadcasting,
and lu_solve_fused on both of its branches and on singular systems.
Inputs come from numpy with a fixed seed.

LU and P are unique under the pivot rule, so they are compared directly:
P exactly, LU to 1e-10·max|A|·max(M, N) in float64 and 1e-4·max|A|·N in
float32 (the packages sum in different orders); x within the
forward-error bound of the solve and its backward error within N·eps
and 8× the JAX package's (``assert_x_close``). The JAX references run
jitted: eager, their interpret-mode panels take seconds a call."""
import jax
import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla

from nd4js_tpu_torch import la
from tests.test_torch_chol_lu_slice import _close
from tests.test_torch_qr_slice import CPU, _t, assert_x_close

jlu_decomp = jax.jit(jla.lu_decomp)
jlu_solve = jax.jit(jla.lu_solve)
jlu_solve_fused = jax.jit(jla.lu_solve_fused)


@pytest.mark.parametrize("shape", [(2, 9, 9), (7, 3), (3, 7), (150, 40),
                                   (40, 150), (129, 131)])
def test_lu_decomp_matches_jax(shape):
    """LU to 1e-10·max|A| and P equal, over one to two panels of 128."""
    a = np.random.default_rng(95).standard_normal(shape)
    jlu, jp = jlu_decomp(a)
    lu, p = la.lu_decomp(a, device=CPU)
    assert p.dtype == torch.int32 and p.shape == shape[:-1]
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    _close(lu, jlu, np.abs(a).max() * max(shape[-2:]), np.float64)


def test_lu_decomp_float32_and_integer_input():
    rng = np.random.default_rng(96)
    a = rng.standard_normal((2, 24, 24)).astype(np.float32)
    jlu, jp = jlu_decomp(a)
    lu, p = la.lu_decomp(_t(a))
    assert lu.dtype == torch.float32
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    _close(lu, jlu, np.abs(a).max() * 24, np.float32)
    ai = rng.integers(-5, 5, (6, 6))
    lu, _ = la.lu_decomp(ai, device=CPU)
    assert lu.dtype == torch.float64
    _close(lu, jlu_decomp(ai)[0], 5 * 6, np.float64)


def test_lu_solve_matches_jax_with_broadcasting():
    """(LU, P) of a (2, 3) batch against one right-hand side block."""
    rng = np.random.default_rng(97)
    a = rng.standard_normal((2, 3, 12, 12))
    y = rng.standard_normal((12, 2))
    jlu, jp = jlu_decomp(a)
    want = np.asarray(jlu_solve(jlu, jp, y))
    lu, p = la.lu_decomp(_t(a))
    got = la.lu_solve(lu, p, _t(y))
    assert got.shape == (2, 3, 12, 2)
    assert_x_close(got, want, a, np.float64, np.broadcast_to(y, want.shape))


@pytest.mark.parametrize("n,k", [(24, 3), (128, 1)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_lu_solve_fused_matches_jax(n, k, dtype):
    """N ≤ 128: one lu_gesv launch."""
    rng = np.random.default_rng(98 + n)
    a = rng.standard_normal((2, n, n)).astype(dtype)
    y = rng.standard_normal((2, n, k)).astype(dtype)
    want = np.asarray(jlu_solve_fused(a, y))
    got = la.lu_solve_fused(_t(a), _t(y))
    assert got.dtype == torch.from_numpy(a).dtype
    assert_x_close(got, want, a, dtype, y)


def test_lu_solve_fused_falls_back_above_128_like_jax():
    """N = 136: lu_decomp (two lu_panel panels, 128 and 8) + lu_solve."""
    rng = np.random.default_rng(234)
    a = rng.standard_normal((136, 136))
    y = rng.standard_normal((136, 2))
    want = np.asarray(jlu_solve_fused(a, y))
    got = la.lu_solve_fused(_t(a), _t(y))
    assert_x_close(got, want, a, np.float64, y)


def test_lu_solve_fused_vector_rhs_permutation_and_singular():
    """A vector right-hand side comes back a vector; the 2×2 permutation
    needs the pivot swap; an all-zero system gives inf/nan, as in JAX."""
    p = np.array([[0.0, 1.0], [1.0, 0.0]])
    x = la.lu_solve_fused(p, np.array([2.0, 3.0]), device=CPU)
    np.testing.assert_array_equal(x.numpy(), [3.0, 2.0])
    np.testing.assert_array_equal(
        x.numpy(), np.asarray(jlu_solve_fused(p, np.array([2.0, 3.0]))))
    z = la.lu_solve_fused(np.zeros((3, 3)), np.ones((3, 1)), device=CPU)
    assert not np.isfinite(z.numpy()).all()
    assert not np.isfinite(np.asarray(
        jlu_solve_fused(np.zeros((3, 3)), np.ones((3, 1))))).all()
    with pytest.raises(ValueError, match="square"):
        la.lu_solve_fused(np.zeros((3, 4)), np.ones(3), device=CPU)

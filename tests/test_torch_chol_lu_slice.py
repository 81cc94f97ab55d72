"""The port's Cholesky slice, with the triangular solves and the
determinants, held against the JAX package on the CPU (its Pallas
kernels in interpret mode): tril_solve and its transposed forms,
cholesky_decomp and cholesky_solve, det and slogdet, leading-dim
broadcasting, and bench.py's config 2 end to end at a small size.
Inputs come from numpy with a fixed seed. (lu_decomp, lu_solve and
lu_solve_fused are in test_torch_lu_slice.py, qr_decomp's cholqr2 and
auto methods in test_torch_qr_auto.py.)

L, L⁻¹, LU, P and the determinants are unique, so they are compared
directly: 1e-10·max|A| in float64 and 1e-4·max|A| in float32 (the
packages sum in different orders); x within the forward-error bound of
the solve and, for a square system, its backward error within N·eps and
8× the JAX package's (``assert_x_close``). The JAX package's Cholesky
compiles slowly on the CPU, so each of its results that several tests
share is computed once, in float64; the port's float32 results are held
to it with the float32 tolerance."""
import functools

import jax
import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla
from nd4js_tpu.la import cholesky as jchol

from nd4js_tpu_torch import la
from nd4js_tpu_torch.la import cholesky
from tests.test_torch_chol_lu_kernels import _spd
from tests.test_torch_qr_slice import CPU, TOL, _np, _t, assert_x_close


def _close(got, want, scale, dtype):
    np.testing.assert_allclose(_np(got), np.asarray(want),
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("fn", ["tril_solve", "tril_t_solve", "triu_t_solve"])
def test_triangular_solves_match_jax_with_broadcasting(fn):
    """Leading dims (2, 1) × (3,), over 40 rows (two blocks of 32)."""
    rng = np.random.default_rng(90)
    t = rng.standard_normal((2, 1, 40, 40)) * 0.1 + 4 * np.eye(40)
    t = np.tril(t) if fn != "triu_t_solve" else np.triu(t)
    y = rng.standard_normal((3, 40, 4))
    want = np.asarray(getattr(jla, fn)(t, y))
    got = getattr(la, fn)(_t(t), _t(y))
    assert got.shape == want.shape == (2, 3, 40, 4)
    _close(got, want, np.abs(want).max(), np.float64)
    np.testing.assert_array_equal(la.tril(_t(t)).numpy(), np.tril(t))
    np.testing.assert_array_equal(la.triu(_t(t), 1).numpy(), np.triu(t, 1))
    # the row-by-row and explicit-inverse methods, ported with the opt slice
    for method in ("scan", "inv"):
        want = np.asarray(getattr(jla, fn)(t, y, method=method))
        got = getattr(la, fn)(_t(t), _t(y), method=method)
        assert got.shape == want.shape
        _close(got, want, np.abs(want).max(), np.float64)
    with pytest.raises(ValueError):
        getattr(la, fn)(_t(t), _t(y), method="nope")


@functools.lru_cache(maxsize=None)
def _jax_chol_inv_core(n: int, base: int):
    a = _spd(np.random.default_rng(91 + n), (2, n, n))
    return a, [np.asarray(r) for r in jax.jit(
        jchol._chol_inv_core, static_argnames="base")(a, base=base)]


@functools.lru_cache(maxsize=None)
def _jax_cholesky():
    """A (2, 3, 50, 50) SPD batch and the JAX package's (L, L⁻¹)."""
    a = _spd(np.random.default_rng(92), (2, 3, 50, 50))
    f = jax.jit(jla.cholesky_decomp, static_argnames="inv")
    return a, [np.asarray(r) for r in f(a, inv=True)]


@pytest.mark.parametrize("base,n", [(16, 40), (64, 66)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_inv_core_matches_jax_at_both_leaf_widths(base, n, dtype):
    """L and L⁻¹ of the recursion against the JAX package's own
    _chol_inv_core(a, base=…): base 16 is the CPU's default (leaves of 10
    at n = 40), 64 the card's (leaves of 33 at n = 66)."""
    a, (jl, jli) = _jax_chol_inv_core(n, base)
    l, li = cholesky._chol_inv_core(_t(a.astype(dtype)), base=base)
    _close(l, jl, np.abs(a).max(), dtype)
    _close(li, jli, np.abs(jli).max(), dtype)


@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_cholesky_decomp_matches_jax(inv, dtype):
    """Leading dims (2, 3); with inv the recursion carries L⁻¹ and the
    right spine's inverses too. JAX's L does not depend on inv."""
    a, want = _jax_cholesky()
    got = la.cholesky_decomp(a.astype(dtype), inv=inv, device=CPU)
    got = got if inv else (got,)
    assert got[0].dtype == torch.from_numpy(a.astype(dtype)).dtype
    for g, w in zip(got, want):
        assert g.shape == (2, 3, 50, 50)
        _close(g, w, np.abs(w).max(), dtype)


def test_cholesky_decomp_reads_only_the_lower_triangle():
    """An upper triangle of garbage changes neither L nor L⁻¹."""
    a, want = _jax_cholesky()
    rng = np.random.default_rng(93)
    garbage = np.tril(a) + np.triu(rng.standard_normal(a.shape) * 1e6, 1)
    got = la.cholesky_decomp(garbage, inv=True, device=CPU)
    for g, w, s in zip(got, want, la.cholesky_decomp(a, inv=True, device=CPU)):
        torch.testing.assert_close(g, s, rtol=0, atol=0)
        _close(g, w, np.abs(w).max(), np.float64)


@pytest.mark.parametrize("with_inv", [False, True])
def test_cholesky_solve_matches_jax(with_inv):
    """Both forms, with one right-hand side block broadcast over the
    (2, 3) batch."""
    a, (jl, jli) = _jax_cholesky()
    y = np.random.default_rng(94).standard_normal((50, 2))
    want = np.asarray(jla.cholesky_solve(jl, y, l_inv=jli if with_inv
                                         else None))
    l, li = la.cholesky_decomp(_t(a), inv=True)
    got = la.cholesky_solve(l, _t(y), l_inv=li if with_inv else None)
    assert got.shape == (2, 3, 50, 2)
    assert_x_close(got, want, a, np.float64, np.broadcast_to(y, want.shape))


def test_det_and_slogdet_match_jax():
    rng = np.random.default_rng(99)
    a = rng.standard_normal((2, 3, 12, 12))
    for name in ("det", "slogdet", "det_tri", "slogdet_tri"):
        arg = np.triu(a) if name.endswith("_tri") else a
        want = getattr(jla, name)(arg)
        got = getattr(la, name)(arg, device=CPU)
        for g, w in zip(*((got, want) if isinstance(got, tuple)
                          else ((got,), (want,)))):
            w = np.asarray(w)
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10, atol=0)
    # a row swap flips the sign; a singular matrix has det 0
    perm = np.eye(5)[[1, 0, 2, 3, 4]]
    assert float(la.det(perm, device=CPU)) == -1.0
    assert float(la.det(np.ones((4, 4)), device=CPU)) == 0.0


def test_config2_end_to_end_small():
    """bench.py's config 2 (lu_solve_fused, cholesky_decomp(inv=True),
    cholesky_solve with l_inv) at (8, 32, 32) in float32, against the JAX
    package on the same input and held to bench.py's gate."""
    rng = np.random.default_rng(102)
    n = 32
    a = rng.standard_normal((8, n, n)).astype(np.float32)
    spd = (a @ np.swapaxes(a, -1, -2) / n + 2 * np.eye(n)).astype(np.float32)
    y = rng.standard_normal((8, n, 1)).astype(np.float32)
    jxl = np.asarray(jax.jit(jla.lu_solve_fused)(spd, y))
    jL, jLi = jax.jit(jla.cholesky_decomp, static_argnames="inv")(spd,
                                                                  inv=True)
    jxc = np.asarray(jax.jit(jla.cholesky_solve)(jL, y, l_inv=jLi))
    xl = la.lu_solve_fused(_t(spd), _t(y))
    L, Li = la.cholesky_decomp(_t(spd), inv=True)
    xc = la.cholesky_solve(L, _t(y), l_inv=Li)
    tol = 1e-4 * np.abs(spd).max() * n ** 0.5
    for got, want in ((xl, jxl), (xc, jxc)):
        assert_x_close(got, want, spd, np.float32, y)
        resid = np.abs(spd.astype(np.float64) @ _np(got) - y).max()
        assert resid <= tol
    _close(L, jL, np.abs(spd).max(), np.float32)
    _close(Li, jLi, np.abs(np.asarray(jLi)).max(), np.float32)

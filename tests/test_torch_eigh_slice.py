"""The port's symmetric eigen slice held against the JAX package on the
CPU: eigh_jacobi (even and odd n, batched, degenerate spectra),
tridiag_eigh_dc (recursive and level-batched), eigh_tridiag_dc and eigh
on both sides of its n = 128 switch, float32 and integer input. Inputs
come from numpy with a fixed seed.

w is unique and compared with the JAX package directly; V is compared by
its contract, as ``tests/test_eigh_hessenberg.py:10-23,112-123`` hold the
JAX package's own: orthogonality ≤ 4·eps·n and reconstruction
≤ 1e-10·max|A|·n for Jacobi, 1e-9·n and 1e-9·n·max(1, max|A|) for the
divide-and-conquer path, whose eps-scale jitter of close poles leaves
more. The JAX package's divide-and-conquer compiles slowly on the CPU,
so it is called once at n > 64 (a (2, 128, 128) batch) and its results
are cached; its references run jitted (eager, its interpret-mode
kernels take several times as long)."""
import functools

import jax
import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla
from nd4js_tpu.la import sytrd as jsytrd
from nd4js_tpu.la import tridiag_dc as jtd

from nd4js_tpu_torch import la
from nd4js_tpu_torch.ops import sytrd_panel as sp
from tests.test_torch_gpu import _sym

CPU = "cpu"
EPS64 = np.finfo(np.float64).eps
EPS32 = np.finfo(np.float32).eps


def _np(x):
    return x.double().numpy()


def assert_eigh_contract(w, v, a, orth_tol, rec_tol):
    """w ascending, VᵀV = I and V·diag(w)·Vᵀ = A to the given bounds."""
    w, v = _np(w), _np(v)
    n = a.shape[-1]
    vt = np.swapaxes(v, -1, -2)
    assert (np.diff(w, axis=-1) >= 0).all()
    assert np.abs(vt @ v - np.eye(n)).max() <= orth_tol
    assert np.abs((v * w[..., None, :]) @ vt - a).max() <= rec_tol


def _tridiag(d, e):
    n = d.shape[-1]
    t = np.zeros(d.shape + (n,))
    i = np.arange(n)
    t[..., i, i] = d
    t[..., i[1:], i[:-1]] = e
    t[..., i[:-1], i[1:]] = e
    return t


@functools.lru_cache(maxsize=None)
def _jax_jacobi(shape):
    a = _sym(np.random.default_rng(70 + shape[-1]), shape)
    return a, [np.asarray(x) for x in jax.jit(jla.eigh_jacobi)(a)]


@pytest.mark.parametrize("shape", [(6, 6), (7, 7), (2, 3, 16, 16),
                                   (2, 3, 17, 17), (33, 33)])
def test_eigh_jacobi_matches_jax(shape):
    """Even and odd n (odd pads to n + 1 and drops the pad pair) and a
    (2, 3) batch in which the matrices converge after different numbers of
    sweeps: w to the JAX test's own rtol 1e-9, atol 1e-10."""
    a, (jw, _) = _jax_jacobi(shape)
    w, v = la.eigh_jacobi(a, device=CPU)
    n = shape[-1]
    assert w.shape == jw.shape and v.shape == a.shape
    np.testing.assert_allclose(_np(w), jw, rtol=1e-9, atol=1e-10)
    assert_eigh_contract(w, v, a, max(4 * EPS64 * n, 1e-14),
                         1e-10 * max(1.0, np.abs(a).max()) * n)


@pytest.mark.parametrize("diag", [[2.0, 2.0, 2.0, 1.0],
                                  [2.0, 2.0, 1.0, 2.0, 3.0]])
def test_eigh_jacobi_degenerate_spectrum_matches_jax_exactly(diag):
    """No rotation changes a diagonal input, so both packages return a
    permutation of I, chosen by their sorts: the pad column's removal
    (every other column is exactly 0 in the pad row) and the equal
    eigenvalues. Stable sorts pick the same permutation."""
    a = np.diag(diag)
    jw, jv = (np.asarray(x) for x in jla.eigh_jacobi(a))
    w, v = la.eigh_jacobi(a, device=CPU)
    np.testing.assert_array_equal(w.numpy(), jw)
    np.testing.assert_array_equal(v.numpy(), jv)


def test_eigh_jacobi_degenerate_rotated_spectrum():
    """The JAX test's [1, 2, 2, 2] spectrum in a rotated basis: V is not
    unique there, so it is held to the contract."""
    q = np.linalg.qr(np.random.default_rng(71).standard_normal((4, 4)))[0]
    a = q @ np.diag([2.0, 2.0, 2.0, 1.0]) @ q.T
    w, v = la.eigh_jacobi(a, device=CPU)
    np.testing.assert_allclose(w.numpy(), [1.0, 2.0, 2.0, 2.0], atol=1e-12)
    assert_eigh_contract(w, v, a, 1e-12, 1e-12)


@functools.lru_cache(maxsize=None)
def _jax_tridiag_recursive():
    rng = np.random.default_rng(72)
    d, e = rng.standard_normal((2, 40)), rng.standard_normal((2, 39))
    return d, e, [np.asarray(x) for x in jax.jit(functools.partial(
        jtd.tridiag_eigh_dc, method="recursive"))(d, e)]


def test_tridiag_eigh_dc_recursive_matches_jax():
    """n = 40: leaves of 10, two levels of merges, per matrix of a batch;
    'batched' takes the same recursion up to n = 64."""
    d, e, (jw, _) = _jax_tridiag_recursive()
    t = _tridiag(d, e)
    w, v = la.tridiag_eigh_dc(d, e, method="recursive", device=CPU)
    scale = max(1.0, np.abs(t).max())
    np.testing.assert_allclose(_np(w), jw, rtol=0, atol=1e-12 * 40 * scale)
    assert_eigh_contract(w, v, t, 1e-9 * 40, 1e-9 * 40 * scale)
    wb, vb = la.tridiag_eigh_dc(d, e, device=CPU)
    assert torch.equal(wb, w) and torch.equal(vb, v)


@functools.lru_cache(maxsize=None)
def _jax_dc_128():
    """One (2, 128, 128) batch: the JAX package's sytrd (d, e) and its
    eigh_tridiag_dc, the one call of its divide-and-conquer at n > 64."""
    a = _sym(np.random.default_rng(73), (2, 128, 128))
    d, e, _ = (np.asarray(x) for x in jax.jit(jsytrd.sytrd)(a))
    jw, jv = (np.asarray(x) for x in jax.jit(jla.eigh_tridiag_dc)(a))
    return a, d, e, jw, jv


def test_tridiag_eigh_dc_level_batched_matches_jax():
    """n = 128 > 64: the level-batched solver (8 leaves of 16, three levels
    of merges, the batch and each level's merges on one axis), on the JAX
    package's own (d, e), whose eigenvalues are its eigh_tridiag_dc's w."""
    _, d, e, jw, _ = _jax_dc_128()
    t = _tridiag(d, e)
    w, v = la.tridiag_eigh_dc(d, e, device=CPU)
    scale = max(1.0, np.abs(t).max())
    np.testing.assert_allclose(_np(w), jw, rtol=0, atol=1e-12 * 128 * scale)
    assert_eigh_contract(w, v, t, 1e-9 * 128, 1e-9 * 128 * scale)


def test_tridiag_eigh_dc_level_batched_pads_above_the_spectrum():
    """n = 100 is padded to 128 with decoupled entries above the spectrum,
    which the solver drops; held to the recursion's eigenvalues."""
    rng = np.random.default_rng(74)
    d, e = rng.standard_normal((2, 100)), rng.standard_normal((2, 99))
    t = _tridiag(d, e)
    w, v = la.tridiag_eigh_dc(d, e, device=CPU)
    wr, _ = la.tridiag_eigh_dc(d, e, method="recursive", device=CPU)
    scale = max(1.0, np.abs(t).max())
    np.testing.assert_allclose(_np(w), _np(wr), rtol=0, atol=1e-12 * 100)
    assert_eigh_contract(w, v, t, 1e-9 * 100, 1e-9 * 100 * scale)


def test_eigh_at_128_takes_dc_and_matches_jax():
    a, _, _, jw, _ = _jax_dc_128()
    before = sp.launches
    w, v = la.eigh(a, device=CPU)
    assert sp.launches == before          # the CPU runs the plain panel
    wd, vd = la.eigh_tridiag_dc(a, device=CPU)
    assert torch.equal(w, wd) and torch.equal(v, vd)
    amax = max(1.0, np.abs(a).max())
    np.testing.assert_allclose(_np(w), jw, rtol=0, atol=1e-12 * 128 * amax)
    assert_eigh_contract(w, v, a, 1e-9 * 128, 1e-9 * 128 * amax)


def test_eigh_below_128_takes_jacobi_and_matches_jax():
    a = _sym(np.random.default_rng(75), (127, 127))
    w, v = la.eigh(a, device=CPU)
    wj, vj = la.eigh_jacobi(a, device=CPU)
    assert torch.equal(w, wj) and torch.equal(v, vj)
    jw = np.asarray(jax.jit(jla.eigh)(a)[0])
    np.testing.assert_allclose(_np(w), jw, rtol=1e-9, atol=1e-10)
    assert_eigh_contract(w, v, a, 4 * EPS64 * 127,
                         1e-10 * max(1.0, np.abs(a).max()) * 127)


def test_eigh_float32_holds_the_contract_with_its_own_eps():
    """float32 in, float32 out, on both paths: w within 100·eps·n·max|A|
    of the JAX package's float64 w, orthogonality ≤ 4·eps·n and
    reconstruction ≤ 8·eps·n·max|A|."""
    a, _, _, jw, _ = _jax_dc_128()
    small, (sw, _) = _jax_jacobi((33, 33))
    for x, want in ((a, jw), (small, sw)):
        n = x.shape[-1]
        amax = np.abs(x).max()
        w, v = la.eigh(x.astype(np.float32), device=CPU)
        assert w.dtype == v.dtype == torch.float32
        np.testing.assert_allclose(_np(w), want, rtol=0,
                                   atol=100 * EPS32 * n * amax)
        assert_eigh_contract(w, v, x, 4 * EPS32 * n, 8 * EPS32 * n * amax)


@pytest.mark.parametrize("fn", ["eigh", "eigh_jacobi", "eigh_tridiag_dc"])
def test_integer_input_promotes_to_float64(fn):
    a = np.round(_sym(np.random.default_rng(76), (10, 10)) * 4).astype(
        np.int64)
    w, v = getattr(la, fn)(a, device=CPU)
    wf, vf = getattr(la, fn)(a.astype(np.float64), device=CPU)
    assert w.dtype == v.dtype == torch.float64
    assert torch.equal(w, wf) and torch.equal(v, vf)


def test_eigh_methods_not_ported_or_unknown_raise():
    """Every method of the JAX package's eigh is ported now ('via_svd'
    with the SVD slice: the identity's eigenpairs within 8·eps·n·‖A‖_F,
    the bound of its shift); an unknown method raises."""
    a = np.eye(3)
    w, v = la.eigh(a, method="via_svd", device=CPU)
    assert np.abs(w.numpy() - 1.0).max() <= 8 * EPS64 * 3 * np.sqrt(3)
    assert np.abs((v.mT @ v).numpy() - a).max() <= 4 * EPS64 * 3
    with pytest.raises(ValueError, match="unknown"):
        la.eigh(a, method="qr", device=CPU)


def test_eigh_tridiag_dc_of_a_1x1_matrix():
    a = np.full((3, 1, 1), -2.5)
    w, v = la.eigh_tridiag_dc(a, device=CPU)
    np.testing.assert_array_equal(w.numpy(), [[-2.5]] * 3)
    np.testing.assert_array_equal(v.numpy(), np.ones((3, 1, 1)))

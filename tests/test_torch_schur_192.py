"""The port's general eigen at n = 192 held against the JAX package on the
CPU: the smallest size that takes every route of the windowed Schur loop
(AED with the multishift sweep, ``small_win``) and the ``trevc_solve``
route of ``schur_eigen`` (n > 128, n % 64 == 0), whose plain version runs
here. Inputs come from numpy with a fixed seed, in float64.

``schur_decomp`` is held to the contract of ``tests/test_schur_eigen.py``
(orthogonality ≤ 4·eps·n, quasi-triangular, reconstruction
≤ 1e-11·n·max|A|) and its eigenvalues matched nearest to nearest with the
JAX package's and numpy's within 1e-9·n·max|A| (a Schur form is not
unique: its trajectory depends on rounding). ``schur_eigen`` of the JAX
package's own (Q, T): eigenvalues within 64·eps·max|T| and eigenvectors
within 1e-9·max|A|/gap after aligning their phase, where the gap to the
nearest other eigenvalue is ≥ 1e-3·max|A|; and the eigenpair residual
‖A·v − λ·v‖ ≤ 1e-10·n·max|A|.
"""
import functools

import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla

from nd4js_tpu_torch import convert, la
from nd4js_tpu_torch.la import schur as pschur
from nd4js_tpu_torch.ops import trevc_solve as tv

from tests.test_torch_schur_slice import (_aligned_vectors, _match_eigvals,
                                          _schur_contract)

EPS64 = np.finfo(np.float64).eps
CPU = "cpu"
N = 192


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of tiny torch ops; under pytest-xdist
    several workers share the cores, and a multi-threaded intra-op pool
    for each tiny op makes them many times slower. One thread per worker
    for this module's tests; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@functools.lru_cache(maxsize=None)
def _jax_schur():
    a = np.random.default_rng(192).standard_normal((N, N))
    q, t = jla.schur_decomp(a)
    return a, np.asarray(q), np.asarray(t)


def test_schur_decomp_192_takes_aed_the_sweep_and_small_win():
    a, _, jt = _jax_schur()
    for k in pschur.branches:
        pschur.branches[k] = 0
    q, t = la.schur_decomp(a, device=CPU)
    q, t = q.numpy(), t.numpy()
    assert pschur.branches["aed"] > 0 and pschur.branches["sweep"] > 0
    assert pschur.branches["small_win"] > 0
    _schur_contract(a, q, t)
    tol = 1e-9 * max(1, np.abs(a).max()) * N
    lam = la.schur_eigenvals(t, device=CPU).numpy()
    _match_eigvals(lam, np.asarray(jla.schur_eigenvals(jt)), tol)
    _match_eigvals(lam, np.linalg.eigvals(a), tol)


def test_schur_eigen_192_of_the_jax_packages_schur_form():
    a, jq, jt = _jax_schur()
    calls = []
    real = tv.trevc_solve_ref

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return real(*args, **kwargs)

    tv.trevc_solve_ref = spy
    try:
        (lr, li), (vr, vi) = la.schur_eigen(convert.from_numpy(jq, CPU),
                                            convert.from_numpy(jt, CPU),
                                            split=True)
    finally:
        tv.trevc_solve_ref = real
    # the kernel's route: its wrapper ran its plain version on the CPU
    assert calls == [(1, N, N)]
    jlam, jv = (np.asarray(x) for x in jla.schur_eigen(jq, jt))
    lam = lr.numpy() + 1j * li.numpy()
    v = vr.numpy() + 1j * vi.numpy()
    assert np.abs(lam - jlam).max() <= 64 * EPS64 * np.abs(jt).max()
    scale = max(1, np.abs(a).max())
    assert _aligned_vectors(v, jv, jlam, scale) > N // 2
    assert np.abs(a @ v - v * lam[None, :]).max() <= 1e-10 * scale * N
    assert np.allclose(np.linalg.norm(v, axis=0), 1.0, atol=1e-12)


def test_eigen_192_float32_meets_the_bench_gate():
    """The slice end to end in float32, config 4's dtype, under bench.py's
    gate max‖A·v − λ·v‖ ≤ 1e-4·max|A|·√N (bench.py:446-455)."""
    a = np.random.default_rng(193).standard_normal((N, N)).astype(np.float32)
    (lr, li), (vr, vi) = la.eigen(torch.from_numpy(a), split=True)
    lr, li, vr, vi = (x.double().numpy() for x in (lr, li, vr, vi))
    a64 = a.astype(np.float64)
    er = a64 @ vr - (vr * lr[None, :] - vi * li[None, :])
    ei = a64 @ vi - (vr * li[None, :] + vi * lr[None, :])
    resid = np.sqrt(er ** 2 + ei ** 2).max()
    assert resid <= 1e-4 * np.abs(a).max() * N ** 0.5

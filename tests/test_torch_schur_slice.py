"""The port's general-eigen slice held against the JAX package on the CPU:
``hessenberg_decomp``, ``schur_decomp``, ``schur_eigenvals``,
``schur_eigen`` fed the JAX package's own (Q, T), and ``eigen``,
``eigenvals`` and ``eigen_balance_pre`` on a (3, 10) batch. Inputs come
from numpy with fixed seeds, in float64.

* Hessenberg reduction is unique with the Householder sign convention:
  Q and H entry by entry within 32·eps·n·max|A|.
* A Schur form is not unique (the order of the eigenvalues along the
  diagonal depends on the trajectory, which rounding may change), so
  ``schur_decomp`` is held to the contract of ``tests/test_schur_eigen.py``
  (orthogonality ≤ 4·eps·n, nothing below the subdiagonal, no two adjacent
  nonzero subdiagonals, reconstruction ≤ 1e-11·n·max|A|) and its
  eigenvalues matched nearest to nearest with the JAX package's within
  1e-9·n·max|A|.
* ``schur_eigen`` of the same (Q, T): eigenvalues within 64·eps·max|T|;
  eigenvectors, unit columns defined up to a phase, within
  1e-9·max|A|/gap after aligning the phase, where gap is the distance of
  the column's eigenvalue to the nearest other one and ≥ 1e-3·max|A|
  (an eigenvector moves by about eps·‖A‖/gap under rounding).
* The split-complex helpers agree with the JAX package's exactly
  (elementwise float64 arithmetic in the same order), Smith's division
  included on both of its branches and at a zero divisor; ``cabs``
  within 2·eps (relative: two hypot implementations) and the complex
  GEMM within 8·eps·k·max|a|·max|b|.
* Balancing scales by powers of two, which the port's D is exactly
  (B = D⁻¹·A·D then holds exactly); the JAX package's ``jnp.exp2`` is
  within an ulp of them on the CPU, so D within 4·eps (relative) and B
  within 8·eps·max|B|.
"""
import functools

import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla
from nd4js_tpu.core import cpx as jcpx

from nd4js_tpu_torch import convert, la
from nd4js_tpu_torch.core import cpx

EPS64 = np.finfo(np.float64).eps
CPU = "cpu"


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


def _match_eigvals(lam, ref, tol):
    """Greedy nearest matching of two multisets."""
    lam = list(np.asarray(lam))
    for w in np.asarray(ref):
        d = [abs(x - w) for x in lam]
        i = int(np.argmin(d))
        assert d[i] <= tol, f"eigenvalue {w} unmatched (best {d[i]})"
        lam.pop(i)


def _schur_contract(a, q, t):
    n = a.shape[-1]
    assert np.abs(q.T @ q - np.eye(n)).max() <= 4 * EPS64 * max(2, n)
    assert np.abs(np.tril(t, -2)).max() == 0.0
    s = np.abs(np.diag(t, -1)) > 0
    assert not np.any(s[:-1] & s[1:])
    assert np.abs(q @ t @ q.T - a).max() <= \
        1e-11 * max(1, np.abs(a).max()) * max(1, n)


def _aligned_vectors(v, vref, lam, tol_scale):
    """Columns of v and vref (unit, complex) agree after a phase, where
    their eigenvalue is separated from the others."""
    n = v.shape[-1]
    gaps = np.array([np.min(np.abs(np.delete(lam, k) - lam[k]))
                     for k in range(n)])
    checked = 0
    for k in range(n):
        if gaps[k] < 1e-3 * tol_scale:
            continue
        ph = np.vdot(vref[:, k], v[:, k])
        ph = ph / abs(ph)
        assert np.abs(v[:, k] - ph * vref[:, k]).max() <= \
            1e-9 * tol_scale / gaps[k]
        checked += 1
    return checked


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div", "conj", "abs2",
                                "cabs", "scale", "where", "complex"])
def test_cpx_matches_the_jax_package(op):
    rng = np.random.default_rng(11)
    a = (rng.standard_normal(40), rng.standard_normal(40))
    b = [rng.standard_normal(40), rng.standard_normal(40)]
    # Smith's two branches, a zero divisor, and a huge and a tiny one
    b[0][:4], b[1][:4] = [0.0, 1e-300, 3.0, 1e300], [0.0, 2.0, 1e-300, 1.0]
    ta, tb = tuple(map(torch.from_numpy, a)), tuple(map(torch.from_numpy, b))
    ja, jb = tuple(map(np.asarray, a)), tuple(map(np.asarray, b))
    pred = a[0] > 0
    if op in ("add", "sub", "mul", "div"):
        got, want = getattr(cpx, op)(ta, tb), getattr(jcpx, op)(ja, jb)
    elif op in ("conj", "abs2", "cabs"):
        got, want = getattr(cpx, op)(ta), getattr(jcpx, op)(ja)
    elif op == "scale":
        got, want = cpx.scale(ta, tb[0]), jcpx.scale(ja, jb[0])
    elif op == "where":
        got = cpx.where(torch.from_numpy(pred), ta, tb)
        want = jcpx.where(pred, ja, jb)
    else:
        z = cpx.to_complex(ta)
        assert z.dtype == torch.complex128
        got, want = cpx.from_complex(z), jcpx.from_complex(
            jcpx.to_complex(ja))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if op == "cabs":    # two hypot implementations: within an ulp
            assert np.all(np.abs(g - w) <= 2 * EPS64 * w)
        else:
            assert np.array_equal(g, w, equal_nan=True)


def test_cpx_matmul_matches_the_jax_package():
    rng = np.random.default_rng(12)
    a = tuple(rng.standard_normal((2, 5, 7)) for _ in range(2))
    b = tuple(rng.standard_normal((2, 7, 3)) for _ in range(2))
    got = cpx.matmul(tuple(map(torch.from_numpy, a)),
                     tuple(map(torch.from_numpy, b)))
    want = jcpx.matmul(a, b)
    tol = 8 * EPS64 * 7 * np.abs(a).max() * np.abs(b).max()
    for g, w in zip(got, want):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= tol


@pytest.mark.parametrize("n", [40, 100])
def test_hessenberg_matches_the_jax_package(n):
    """n = 40 runs the unblocked loop, n = 100 the blocked panels."""
    a = np.random.default_rng(n).standard_normal((2, n, n))
    q, h = la.hessenberg_decomp(a, device=CPU)
    jq, jh = (np.asarray(x) for x in jla.hessenberg_decomp(a))
    tol = 32 * EPS64 * n * np.abs(a).max()
    assert np.abs(q.numpy() - jq).max() <= tol
    assert np.abs(h.numpy() - jh).max() <= tol
    assert np.all(np.tril(h.numpy(), -2) == 0)
    assert np.abs(q.numpy() @ h.numpy() @ np.swapaxes(q.numpy(), -1, -2)
                  - a).max() <= tol


@functools.lru_cache(maxsize=None)
def _jax_schur(n):
    a = np.random.default_rng(500 + n).standard_normal((n, n))
    q, t = jla.schur_decomp(a)
    return a, np.asarray(q), np.asarray(t)


@pytest.mark.parametrize("n", [3, 5, 7, 40])
def test_schur_decomp_contract_and_eigenvalues(n):
    """n = 3..7 run the unwindowed chase, n = 40 the whole-matrix
    schur_small route."""
    a, jq, jt = _jax_schur(n)
    q, t = la.schur_decomp(a, device=CPU)
    q, t = q.numpy(), t.numpy()
    _schur_contract(a, q, t)
    tol = 1e-9 * max(1, np.abs(a).max()) * n
    lam = la.schur_eigenvals(t, device=CPU).numpy()
    _match_eigvals(lam, np.asarray(jla.schur_eigenvals(jt)), tol)
    _match_eigvals(lam, np.linalg.eigvals(a), tol)


@pytest.mark.parametrize("n", [5, 40])
def test_schur_eigen_of_the_jax_packages_schur_form(n):
    a, jq, jt = _jax_schur(n)
    (lr, li), (vr, vi) = la.schur_eigen(convert.from_numpy(jq, CPU),
                                        convert.from_numpy(jt, CPU),
                                        split=True)
    jlam, jv = (np.asarray(x) for x in jla.schur_eigen(jq, jt))
    lam = lr.numpy() + 1j * li.numpy()
    v = vr.numpy() + 1j * vi.numpy()
    assert np.abs(lam - jlam).max() <= 64 * EPS64 * np.abs(jt).max()
    scale = max(1, np.abs(a).max())
    assert _aligned_vectors(v, jv, jlam, scale) > 0
    assert np.abs(a @ v - v * lam[None, :]).max() <= 1e-10 * scale * n
    assert np.allclose(np.linalg.norm(v, axis=0), 1.0, atol=1e-12)


def test_schur_decomp_repeated_eigenvalues():
    """A 3×3 Jordan block in a random orthogonal frame
    (``tests/test_schur_eigen.py``): the unwindowed chase still converges
    to a valid Schur form."""
    j = np.array([[2.0, 1.0, 0.0], [0.0, 2.0, 1.0], [0.0, 0.0, 2.0]])
    p, _ = np.linalg.qr(np.random.default_rng(13).standard_normal((3, 3)))
    b = p @ j @ p.T
    q, t = la.schur_decomp(b, device=CPU)
    assert np.abs(q.numpy() @ t.numpy() @ q.numpy().T - b).max() <= 1e-10


@pytest.mark.parametrize("n", [130])
def test_schur_decomp_classic_windowed_chase(n):
    """129 ≤ n ≤ 191 takes the classic single-bulge chase through the
    128-wide window (``bulge_chase_steps`` with NB = 1) until the window
    fits small_win: the contract and numpy's eigenvalues."""
    from nd4js_tpu_torch.la import schur as pschur
    a = np.random.default_rng(n).standard_normal((n, n))
    for k in pschur.branches:
        pschur.branches[k] = 0
    q, t = la.schur_decomp(a, device=CPU)
    assert pschur.branches["chase"] > 0 and pschur.branches["slides"] > 0
    assert pschur.branches["aed"] == 0
    q, t = q.numpy(), t.numpy()
    _schur_contract(a, q, t)
    lam = la.schur_eigenvals(t, device=CPU).numpy()
    _match_eigvals(lam, np.linalg.eigvals(a), 1e-9 * np.abs(a).max() * n)


def test_schur_eigen_defective_matrix():
    """A 4×4 with a 2-chain at eigenvalue 2: the clamped pivot duplicates
    the eigenvector instead of blowing up (``tests/test_schur_eigen.py``)."""
    a = np.asarray([[2.0, 1.0, 3.0, 0.0], [0.0, 2.0, 1.0, 2.0],
                    [0.0, 0.0, 5.0, 1.0], [0.0, 0.0, 0.0, 7.0]])
    q, t = la.schur_decomp(a, device=CPU)
    (lr, li), (vr, vi) = la.schur_eigen(q, t, split=True)
    assert np.allclose(np.sort(lr.numpy()), [2.0, 2.0, 5.0, 7.0], atol=1e-8)
    v = vr.numpy() + 1j * vi.numpy()
    lam = lr.numpy() + 1j * li.numpy()
    assert np.abs(a @ v - v * lam[None, :]).max() < 1e-7
    assert np.abs(v).max() <= 1.0 + 1e-12


@functools.lru_cache(maxsize=None)
def _batch():
    return np.random.default_rng(77).standard_normal((3, 10, 10))


def test_eigen_balance_pre_matches_the_jax_package():
    a = _batch() * np.array([1e4, 1.0, 1e-3, 1.0, 1e2, 1, 1, 1e-2, 1, 1])
    d, b = la.eigen_balance_pre(a, device=CPU)
    d, b = d.numpy(), b.numpy()
    jd, jb = (np.asarray(x) for x in jla.eigen_balance_pre(a))
    # the port's factors are exact powers of two, so B = D⁻¹·A·D exactly
    assert np.array_equal(d, np.exp2(np.round(np.log2(d))))
    assert np.array_equal(b, a / d[..., :, None] * d[..., None, :])
    # jnp.exp2 on the CPU is within an ulp of the power of two
    assert np.abs(d / jd - 1).max() <= 4 * EPS64
    assert np.abs(b - jb).max() <= 8 * EPS64 * np.abs(jb).max()


def test_eigenvals_batched_matches_the_jax_package():
    a = _batch()
    lam = la.eigenvals(a, device=CPU).numpy()
    jlam = np.asarray(jla.eigenvals(a))
    assert lam.shape == (3, 10)
    for i in range(3):
        _match_eigvals(lam[i], jlam[i], 1e-8 * 10)
        _match_eigvals(lam[i], np.linalg.eigvals(a[i]), 1e-8 * 10)


@pytest.mark.parametrize("split", [False, True])
def test_eigen_batched_matches_the_jax_package(split):
    a = _batch()
    out = la.eigen(a, split=split, device=CPU)
    if split:
        (lr, li), (vr, vi) = out
        lam, v = lr.numpy() + 1j * li.numpy(), vr.numpy() + 1j * vi.numpy()
    else:
        lam, v = (x.numpy() for x in out)
    jlam, jv = (np.asarray(x) for x in jla.eigen(a))
    assert lam.shape == (3, 10) and v.shape == (3, 10, 10)
    for i in range(3):
        scale = max(1, np.abs(a[i]).max())
        _match_eigvals(lam[i], jlam[i], 1e-8 * 10)
        assert np.abs(a[i] @ v[i] - v[i] * lam[i][None, :]).max() <= \
            1e-10 * scale * 10
        assert np.allclose(np.linalg.norm(v[i], axis=0), 1.0, atol=1e-12)
        # the same eigenvalue order on both sides: compare the vectors
        if np.abs(lam[i] - jlam[i]).max() <= 1e-8 * 10:
            assert _aligned_vectors(v[i], jv[i], jlam[i], scale) > 0

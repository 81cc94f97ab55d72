"""The port's one-sided Jacobi SVD slice held against the JAX package on
the CPU: the ``jacobi_sweeps`` kernel's plain version against the Pallas
kernel in interpret mode, ``svd_jac_1sided``, ``svd_decomp``'s routing,
``svd_lstsq``, ``svd_solve``, ``svd_rank``, ``rank``, ``lstsq`` and
``eigh(method="via_svd")``, on tall, wide, square, odd-N and
rank-deficient batches. Inputs come from numpy with fixed seeds.

Unique outputs are compared directly: the sweep's W, V and off within
64·eps·n·max|W| (scale-free for V and off: the two sum in different
orders over n − 1 rounds), σ within 32·eps·max(M, N)·σ₀, x within
32·eps·max(M, N)·κ·max|x| where κ = σ₀/σ_min of the live part (two
backward-stable solves differ by κ times their rounding). U and V, which
are not unique under clustered σ or on a null space, are held to the
contract of ``tests/test_svd.py``: orthogonality ≤ 4·eps·max(M, N) and
reconstruction ≤ 32·eps·max(M, N)·max|A|. The JAX package's results are
cached per shape: its first call at a shape compiles (about 5 s).
"""
import functools
import importlib

import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla
from nd4js_tpu.ops.jacobi_sweep import jacobi_sweeps as jax_jacobi_sweeps

from nd4js_tpu_torch import la
from nd4js_tpu_torch.ops import jacobi_sweep as js

psg = importlib.import_module("nd4js_tpu_torch.la.svd_gram")

CPU = "cpu"
EPS64 = np.finfo(np.float64).eps


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rank_deficient(rng, shape, rank):
    """A batch of the given shape and rank: g1·g2 of seeded normals."""
    g1 = rng.standard_normal(shape[:-1] + (rank,))
    g2 = rng.standard_normal(shape[:-2] + (rank, shape[-1]))
    return g1 @ g2


# name → input; the rank-deficient batch (rank 7 of 12) fires the U repair
def _input(name):
    rng = np.random.default_rng(300 + sorted(CASES).index(name))
    if name == "rank_deficient":
        return rank_deficient(rng, (3, 12, 12), 7)
    return rng.standard_normal(CASES[name])


CASES = {"tall": (2, 24, 10), "wide": (2, 9, 13), "square": (3, 16, 16),
         "odd": (2, 11, 11), "rank_deficient": (3, 12, 12)}


@functools.lru_cache(maxsize=None)
def _jax_svd(name):
    a = _input(name)
    return a, [np.asarray(x) for x in jla.svd_decomp(a)]


def assert_svd_contract(a, u, sv, v, eps=EPS64, sv_ref=None):
    """Shapes, σ sorted and non-negative, U and V orthonormal to
    4·eps·max(M, N), U·diag(σ)·V = A to 32·eps·max(M, N)·max|A|, and σ
    within 32·eps·max(M, N)·σ₀ of ``sv_ref``."""
    u, sv, v = (x.double().numpy() for x in (u, sv, v))
    m, n = a.shape[-2:]
    k = min(m, n)
    assert u.shape == a.shape[:-2] + (m, k)
    assert sv.shape == a.shape[:-2] + (k,)
    assert v.shape == a.shape[:-2] + (k, n)
    assert (sv >= 0).all() and (np.diff(sv, axis=-1) <= 0).all()
    tol = 4 * eps * max(m, n)
    assert np.abs(np.swapaxes(u, -1, -2) @ u - np.eye(k)).max() <= tol
    assert np.abs(v @ np.swapaxes(v, -1, -2) - np.eye(k)).max() <= tol
    rec = np.abs((u * sv[..., None, :]) @ v - a).max()
    assert rec <= 32 * eps * max(m, n) * np.abs(a).max()
    if sv_ref is not None:
        scale = 32 * eps * max(m, n) * sv_ref[..., :1]
        assert (np.abs(sv - sv_ref) <= scale).all()


@pytest.mark.parametrize("shape", [(3, 16, 16), (2, 24, 10)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_jacobi_sweeps_plain_version_matches_the_pallas_kernel(shape, dtype):
    """One sweep from V = I: W within 64·eps·n·max|W|, V and off within
    64·eps·n."""
    rng = np.random.default_rng(310 + shape[-1])
    nb, _, n = shape
    w = rng.standard_normal(shape).astype(dtype)
    v = np.broadcast_to(np.eye(n, dtype=dtype), (nb, n, n)).copy()
    jw, jv, joff = (np.asarray(x) for x in
                    jax_jacobi_sweeps(w, v, 1, interpret=True))
    pw, pv, poff = js.jacobi_sweeps(_t(w), _t(v), 1)
    unit = 64 * np.finfo(dtype).eps * n
    assert pw.dtype == torch.from_numpy(w).dtype
    assert np.abs(pw.numpy() - jw).max() <= unit * np.abs(w).max()
    assert np.abs(pv.numpy() - jv).max() <= unit
    assert np.abs(poff.numpy() - joff[:, 0, 0]).max() <= unit


def test_jacobi_sweeps_plain_version_three_sweeps_and_zero_sweeps():
    """sweeps=3 in one call against the Pallas kernel's (off the max over
    all three), and sweeps=0 leaves W and V as they were with off = 0."""
    rng = np.random.default_rng(312)
    w = rng.standard_normal((2, 12, 8))
    v = np.broadcast_to(np.eye(8), (2, 8, 8)).copy()
    jw, jv, joff = (np.asarray(x) for x in
                    jax_jacobi_sweeps(w, v, 3, interpret=True))
    pw, pv, poff = js.jacobi_sweeps(_t(w), _t(v), 3)
    unit = 64 * EPS64 * 8 * 3
    assert np.abs(pw.numpy() - jw).max() <= unit * np.abs(w).max()
    assert np.abs(pv.numpy() - jv).max() <= unit
    assert np.abs(poff.numpy() - joff[:, 0, 0]).max() <= unit
    zw, zv, zoff = js.jacobi_sweeps(_t(w), _t(v), 0)
    assert torch.equal(zw, _t(w)) and torch.equal(zv, _t(v))
    assert float(zoff.abs().max()) == 0.0


def test_jacobi_sweeps_rejects_an_odd_width():
    with pytest.raises(ValueError):
        js.jacobi_sweeps(torch.zeros((1, 4, 3)), torch.zeros((1, 3, 3)))


@pytest.mark.parametrize("name", sorted(CASES))
def test_svd_jac_1sided_matches_jax(name):
    """svd_decomp's 'auto' (every case is below 128, so 'jacobi') and
    svd_jac_1sided itself: σ against the JAX package's, U and V by the
    contract; the sweeps run through the wrapper (one call per sweep)."""
    a, (_, jsv, _) = _jax_svd(name)
    before = js.launches
    u, sv, v = la.svd_decomp(a, device=CPU)
    assert js.launches == before        # the CPU runs the plain version
    assert_svd_contract(a, u, sv, v, sv_ref=jsv)
    u2, sv2, v2 = la.svd_jac_1sided(_t(a))
    assert torch.equal(sv, sv2) and torch.equal(u, u2) and torch.equal(v, v2)


def test_svd_jac_repairs_u_on_the_null_space_like_jax():
    """Rank 7 of 12: five σ at rounding level, and U still orthonormal,
    as the JAX package's repair leaves it."""
    a, (ju, jsv, _) = _jax_svd("rank_deficient")
    u, sv, _ = la.svd_decomp(_t(a))
    assert (sv[:, 7:] <= 1e-12 * sv[:, :1]).all()
    ju_orth = np.abs(np.swapaxes(ju, -1, -2) @ ju - np.eye(12)).max()
    u_orth = np.abs((u.mT @ u).numpy() - np.eye(12)).max()
    assert u_orth <= max(4 * EPS64 * 12, 2 * ju_orth)


def test_svd_float32_and_integer_input():
    """float32 keeps float32 and meets the float32 contract; integer
    input promotes to float64."""
    a, (_, jsv, _) = _jax_svd("square")
    u, sv, v = la.svd_decomp(_t(a.astype(np.float32)))
    assert sv.dtype == torch.float32
    assert_svd_contract(a, u, sv, v, eps=np.finfo(np.float32).eps,
                        sv_ref=jsv)
    ai = np.arange(1, 17).reshape(4, 4) % 5
    ui, svi, vi = la.svd_decomp(ai, device=CPU)
    assert svi.dtype == torch.float64
    assert_svd_contract(ai.astype(np.float64), ui, svi, vi,
                        sv_ref=np.linalg.svd(ai, compute_uv=False))


def test_svd_decomp_routing_and_unported_methods():
    """'auto' takes 'jacobi' below 128 and 'gram' from 128 (the JAX
    package's rule); 'blocked' and 'dc', once unported, now route to
    ``svd_jac_blocked`` and ``svd_dc``."""
    a = np.random.default_rng(313).standard_normal((2, 6, 5))
    ua, sa, va = la.svd_decomp(_t(a))
    uj, sj, vj = la.svd_decomp(_t(a), method="jacobi")
    assert torch.equal(sa, sj) and torch.equal(ua, uj)
    for method, direct in (("blocked", la.svd_jac_blocked),
                           ("dc", la.svd_dc)):
        for x, y in zip(la.svd_decomp(_t(a), method=method), direct(_t(a))):
            assert torch.equal(x, y)
    with pytest.raises(ValueError):
        la.svd_decomp(_t(a), method="nope")
    big = np.random.default_rng(314).standard_normal((1, 128, 128))
    before = dict(psg.branches)
    before_sweeps = js.launches
    la.svd_decomp(_t(big).float(), max_iters=1, finish_sweeps=0)
    assert psg.branches["exact"] + psg.branches["poly"] == \
        before["exact"] + before["poly"] + 1
    assert js.launches == before_sweeps


def _x_tol(sv, x_ref, m, n, rcond):
    """32·eps·max(M, N)·κ·max|x| per matrix, κ = σ₀/σ_min over the live σ
    (those above rcond·σ₀)."""
    live = np.where(sv > rcond * sv[..., :1], sv, np.inf).min(-1)
    kappa = sv[..., 0] / live
    return 32 * EPS64 * max(m, n) * kappa * np.abs(x_ref).max(axis=(-2, -1))


@pytest.mark.parametrize("name", sorted(CASES))
def test_svd_lstsq_matches_jax(name):
    """svd_lstsq from the port's own SVD against the JAX package's
    minimum-norm x (rank-truncated at √eps·σ₀), and lstsq(a, y)."""
    a, (ju, jsv, jv) = _jax_svd(name)
    m, n = a.shape[-2:]
    y = np.random.default_rng(320 + n).standard_normal(
        a.shape[:-2] + (m, 2))
    jx = np.asarray(jla.svd_lstsq(ju, jsv, jv, y))
    u, sv, v = la.svd_decomp(_t(a))
    x = la.svd_lstsq(u, sv, v, _t(y)).numpy()
    tol = _x_tol(jsv, jx, m, n, np.sqrt(EPS64))
    assert (np.abs(x - jx).max(axis=(-2, -1)) <= tol).all()
    x2 = la.lstsq(_t(a), _t(y)).numpy()
    assert np.array_equal(x, x2)


def test_svd_rank_rank_and_svd_solve():
    """svd_rank and rank as the JAX package counts them; svd_solve on a
    full-rank square batch, and on the rank-deficient one raising
    SingularMatrixSolveError whose .x equals the JAX package's (within
    the lstsq tolerance)."""
    a, (ju, jsv, jv) = _jax_svd("rank_deficient")
    u, sv, v = la.svd_decomp(_t(a))
    assert la.svd_rank(sv).tolist() == np.asarray(jla.svd_rank(jsv)).tolist()
    assert la.rank(_t(a)).tolist() == [7, 7, 7]
    assert la.rank(_t(a)).dtype == torch.int32
    y = np.random.default_rng(330).standard_normal((3, 12, 1))
    with pytest.raises(la.SingularMatrixSolveError) as err:
        la.svd_solve(u, sv, v, _t(y))
    with pytest.raises(ArithmeticError) as jerr:
        jla.svd_solve(ju, jsv, jv, y)
    jx = np.asarray(jerr.value.x)
    tol = _x_tol(jsv, jx, 12, 12, np.sqrt(EPS64))
    assert (np.abs(err.value.x.numpy() - jx).max(axis=(-2, -1))
            <= tol).all()
    sq, (su, ssv, sv_) = _jax_svd("square")
    ys = np.random.default_rng(331).standard_normal((3, 16, 2))
    x = la.svd_solve(*la.svd_decomp(_t(sq)), _t(ys)).numpy()
    jx = np.asarray(jla.svd_solve(su, ssv, sv_, ys))
    assert (np.abs(x - jx).max(axis=(-2, -1))
            <= _x_tol(ssv, jx, 16, 16, np.sqrt(EPS64))).all()


def test_lstsq_urv_is_not_ported_yet():
    """lstsq(method="urv") was refused until the opt slice ported la/urv;
    it now gives the minimum-norm solution, as the JAX package's does (a
    rank-deficient batch, against JAX and numpy's pseudo-inverse)."""
    rng = np.random.default_rng(341)
    a = rng.standard_normal((2, 9, 3)) @ rng.standard_normal((2, 3, 6))
    y = rng.standard_normal((2, 9, 2))
    x = la.lstsq(a, y, method="urv", device=CPU).numpy()
    jx = np.asarray(jla.lstsq(a, y, method="urv"))
    tol = 1e-10 * np.abs(jx).max()
    assert np.abs(x - jx).max() <= tol
    assert np.abs(x - np.linalg.pinv(a) @ y).max() <= tol


@functools.lru_cache(maxsize=None)
def _jax_via_svd():
    s = np.random.default_rng(340).standard_normal((2, 12, 12))
    s = s + np.swapaxes(s, -1, -2)
    return s, [np.asarray(x) for x in jla.eigh(s, method="via_svd")]


def test_eigh_via_svd_matches_jax():
    """w against the JAX package's within 32·eps·n·‖A‖_F (the shift c
    bounds its absolute accuracy), ascending; V orthonormal to 4·eps·n
    and V·diag(w)·Vᵀ = A to 32·eps·n·‖A‖_F."""
    s, (jw, _) = _jax_via_svd()
    w, v = la.eigh(_t(s), method="via_svd")
    w2, v2 = la.eigh_via_svd(_t(s))
    assert torch.equal(w, w2) and torch.equal(v, v2)
    w, v = w.numpy(), v.numpy()
    c = np.sqrt((s * s).sum(axis=(-2, -1)))[:, None]
    tol = 32 * EPS64 * 12 * c
    assert (np.abs(w - jw) <= tol).all()
    assert (np.diff(w, axis=-1) >= 0).all()
    vt = np.swapaxes(v, -1, -2)
    assert np.abs(vt @ v - np.eye(12)).max() <= 4 * EPS64 * 12
    assert np.abs((v * w[:, None, :]) @ vt - s).max() <= tol.max()

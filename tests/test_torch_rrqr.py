"""The port's rank-revealing QR slice held against the JAX package on the
CPU: the ``rrqr_kernel`` kernel's plain version against the Pallas kernel
in interpret mode, ``rrqr_decomp``, ``rrqr_decomp_full``, ``rrqr_rank``,
``rrqr_lstsq``, ``rrqr_solve``, ``solve`` and the permutations, with a
rank-deficient batch; and the JAX kernel's own factorisation carried in
through ``convert.rrqr_from_numpy``, so that the port's Q formation and
solves are held independently of its pivot choice. Inputs come from numpy
with fixed seeds.

The pivot order is compared exactly (the inputs have no near-ties, so the
downdated norms of both versions choose alike). With the same pivots the
factorisation is unique (the Householder sign convention), so R, V, τ and
Q are compared entry by entry within 32·eps·max(M, N)·max|A| (τ and Q
scale-free), and x within 32·eps·max(M, N)·κ(R)·max|x| (two
backward-stable solves differ by κ times their rounding). Q is also held
to the contract of ``tests/test_rrqr.py``: orthogonality ≤ 4·eps·max(M, N)
and A[:, P] = Q·R.
"""
import functools
import importlib

import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla
from nd4js_tpu.ops.rrqr_kernel import rrqr_kernel as jax_rrqr_kernel

from nd4js_tpu_torch import convert, la
from nd4js_tpu_torch.ops import rrqr_kernel as rk

prq = importlib.import_module("nd4js_tpu_torch.la.rrqr")

EPS64 = np.finfo(np.float64).eps


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def rank_deficient(rng, shape, rank):
    g1 = rng.standard_normal(shape[:-1] + (rank,))
    g2 = rng.standard_normal(shape[:-2] + (rank, shape[-1]))
    return g1 @ g2


CASES = {"tall": (3, 24, 16), "wide": (2, 16, 24), "square": (2, 12, 12),
         "rank_deficient": (3, 14, 14)}


def _input(name):
    rng = np.random.default_rng(500 + sorted(CASES).index(name))
    if name == "rank_deficient":      # rank 9 of 14
        return rank_deficient(rng, CASES[name], 9)
    return rng.standard_normal(CASES[name])


@functools.lru_cache(maxsize=None)
def _jax_rrqr(name, full=False):
    a = _input(name)
    fn = jla.rrqr_decomp_full if full else jla.rrqr_decomp
    return a, [np.asarray(x) for x in fn(a)]


@pytest.mark.parametrize("shape", [(3, 24, 16), (2, 16, 24), (2, 64, 64)])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_rrqr_kernel_plain_version_matches_the_pallas_kernel(shape, dtype):
    rng = np.random.default_rng(510 + shape[-1])
    a = rng.standard_normal(shape).astype(dtype)
    jr, jv, jt, jp = (np.asarray(x) for x in
                      jax_rrqr_kernel(a, interpret=True))
    r, v, t, p = rk.rrqr_kernel(_t(a))
    assert p.dtype == torch.int32 and np.array_equal(p.numpy(), jp)
    unit = 32 * np.finfo(dtype).eps * max(shape[1:])
    amax = np.abs(a).max()
    assert np.abs(r.numpy() - jr).max() <= unit * amax
    assert np.abs(v.numpy() - jv).max() <= unit
    assert np.abs(t.numpy() - jt).max() <= unit
    k = min(shape[1:])
    assert torch.equal(torch.diagonal(v, dim1=-2, dim2=-1),
                       torch.ones((shape[0], k), dtype=v.dtype))
    assert float(torch.triu(v, 1).abs().max()) == 0.0


def test_rrqr_kernel_plain_version_on_a_zero_column_and_ties():
    """A zero matrix pivots in order with τ = 0 everywhere; two equal
    columns pick the lower index first, as the Pallas kernel does."""
    a = np.zeros((1, 5, 4))
    jr, jv, jt, jp = (np.asarray(x) for x in
                      jax_rrqr_kernel(a, interpret=True))
    r, v, t, p = rk.rrqr_kernel(_t(a))
    assert p.tolist() == [[0, 1, 2, 3]] == jp.tolist()
    assert float(t.abs().max()) == 0.0 and float(np.abs(jt).max()) == 0.0
    b = np.random.default_rng(520).standard_normal((1, 5, 4))
    b[0, :, 3] = b[0, :, 1]
    jp = np.asarray(jax_rrqr_kernel(b, interpret=True)[3])
    assert np.array_equal(rk.rrqr_kernel(_t(b))[3].numpy(), jp)


def _assert_q_r_contract(a, q, r, perm):
    q, r = q.numpy(), r.numpy()
    m, n = a.shape[-2:]
    eps4 = 4 * EPS64 * max(m, n)
    qtq = np.swapaxes(q, -1, -2) @ q
    assert np.abs(qtq - np.eye(q.shape[-1])).max() <= eps4
    assert np.abs(np.tril(r, -1)).max() == 0.0
    ap = np.take_along_axis(a, perm.numpy()[..., None, :].astype(np.int64),
                            axis=-1)
    assert np.abs(q @ r - ap).max() <= 32 * EPS64 * max(m, n) * \
        np.abs(a).max()
    # |R_jj| non-increasing, up to the rounding of the downdated squared
    # norms that chose the pivots: each within max(M, N)·eps·‖a_c‖², so a
    # pivot's true norm² is within twice that of the largest
    d2 = np.diagonal(r, axis1=-2, axis2=-1) ** 2
    slack = 2 * max(m, n) * EPS64 * (a * a).sum(-2).max(-1)[..., None]
    assert (d2[..., 1:] <= d2[..., :-1] + slack).all()


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("name", sorted(CASES))
def test_rrqr_decomp_matches_jax(name, full):
    """On the rank-deficient batch only the first `rank` pivots are
    determined (the trailing norms are rounding noise, which two correct
    versions order differently): there the pivots, Q's and R's leading
    `rank` columns are compared, the rest by the contract."""
    a, (jq, jr, jp) = _jax_rrqr(name, full)
    fn = la.rrqr_decomp_full if full else la.rrqr_decomp
    q, r, p = fn(_t(a))
    k = int(np.asarray(jla.rrqr_rank(jr)).min())
    assert p.dtype == torch.int32
    assert np.array_equal(p.numpy()[:, :k], jp[:, :k])
    assert np.array_equal(np.sort(p.numpy(), -1), np.sort(jp, -1))
    m, n = a.shape[-2:]
    unit = 32 * EPS64 * max(m, n)
    assert q.shape == jq.shape and r.shape == jr.shape
    assert np.abs(q.numpy()[..., :k] - jq[..., :k]).max() <= unit
    assert np.abs(r.numpy()[..., :k] - jr[..., :k]).max() <= \
        unit * np.abs(a).max()
    if k == min(m, n):
        assert np.array_equal(p.numpy(), jp)
        assert np.abs(q.numpy() - jq).max() <= unit
        assert np.abs(r.numpy() - jr).max() <= unit * np.abs(a).max()
    _assert_q_r_contract(a, q, r, p)


def _x_tol(r, x_ref, m, n, rank):
    """32·eps·max(M, N)·κ(R[:rank, :rank])·max|x| per matrix."""
    out = []
    for rb, xb, kb in zip(r, x_ref, rank):
        s = np.linalg.svd(rb[:kb, :kb], compute_uv=False)
        out.append(32 * EPS64 * max(m, n) * s[0] / s[-1] * np.abs(xb).max())
    return np.asarray(out)


@pytest.mark.parametrize("name", sorted(CASES))
def test_rrqr_rank_and_lstsq_match_jax(name):
    a, (jq, jr, jp) = _jax_rrqr(name)
    m, n = a.shape[-2:]
    y = np.random.default_rng(530 + n).standard_normal(a.shape[:-2] + (m, 2))
    q, r, p = la.rrqr_decomp(_t(a))
    rank = la.rrqr_rank(r)
    jrank = np.asarray(jla.rrqr_rank(jr))
    assert rank.dtype == torch.int32 and rank.tolist() == jrank.tolist()
    if name == "rank_deficient":
        assert rank.tolist() == [9, 9, 9]
    x = la.rrqr_lstsq(q, r, p, _t(y)).numpy()
    jx = np.asarray(jla.rrqr_lstsq(jq, jr, jp, y))
    err = np.abs(x - jx).max(axis=(-2, -1))
    assert (err <= _x_tol(jr, jx, m, n, jrank)).all()
    tol = la.rrqr_rank(r, tol=1e-3).tolist()
    assert tol == np.asarray(jla.rrqr_rank(jr, tol=1e-3)).tolist()


def test_rrqr_solve_and_solve_match_jax():
    """rrqr_solve and solve on full-rank square batches against the JAX
    package; on a rank-deficient one both raise SingularMatrixSolveError,
    whose .x equals the JAX package's; solve refuses a non-square A."""
    a, (jq, jr, jp) = _jax_rrqr("square")
    y = np.random.default_rng(540).standard_normal((2, 12, 3))
    jx = np.asarray(jla.solve(a, y))
    x = la.rrqr_solve(*la.rrqr_decomp(_t(a)), _t(y)).numpy()
    tol = _x_tol(jr, jx, 12, 12, [12, 12])
    assert (np.abs(x - jx).max(axis=(-2, -1)) <= tol).all()
    x2 = la.solve(_t(a), _t(y)).numpy()
    assert np.array_equal(x, x2)
    b, (_, br, _) = _jax_rrqr("rank_deficient")
    yb = np.random.default_rng(541).standard_normal((3, 14, 1))
    with pytest.raises(la.SingularMatrixSolveError) as err:
        la.solve(_t(b), _t(yb))
    with pytest.raises(ArithmeticError) as jerr:
        jla.solve(b, yb)
    jx = np.asarray(jerr.value.x)
    tol = _x_tol(br, jx, 14, 14, [9, 9, 9])
    assert (np.abs(err.value.x.numpy() - jx).max(axis=(-2, -1))
            <= tol).all()
    with pytest.raises(ValueError):
        la.solve(_t(np.ones((2, 3, 4))), _t(np.ones((2, 3, 1))))
    with pytest.raises(ValueError):
        la.rrqr_solve(*la.rrqr_decomp(_t(np.ones((3, 5)))),
                      _t(np.ones((3, 1))))


@pytest.mark.parametrize("economic", [True, False])
def test_q_and_solves_from_the_jax_kernels_factorisation(economic):
    """The Pallas kernel's (R_packed, V, τ, perm), carried in as numpy,
    through the port's compact-WY Q build: Q and R equal the JAX
    package's; rrqr_lstsq from them equals its x."""
    a, (jq, jr, jp) = _jax_rrqr("rank_deficient", not economic)
    fac = [np.asarray(x) for x in jax_rrqr_kernel(a, interpret=True)]
    r_packed, v, taus, perm = convert.rrqr_from_numpy(*fac, device="cpu")
    assert perm.dtype == torch.int32 and r_packed.dtype == torch.float64
    q, r, p = prq._rrqr_assemble(r_packed, v, taus, perm, economic)
    assert np.array_equal(p.numpy(), jp)
    assert np.abs(q.numpy() - jq).max() <= 32 * EPS64 * 14
    assert np.abs(r.numpy() - jr).max() <= 32 * EPS64 * 14 * np.abs(a).max()
    y = np.random.default_rng(550).standard_normal((3, 14, 2))
    jx = np.asarray(jla.rrqr_lstsq(jq, jr, jp, y))
    x = la.rrqr_lstsq(q, r, p, _t(y)).numpy()
    assert (np.abs(x - jx).max(axis=(-2, -1))
            <= _x_tol(jr, jx, 14, 14, [9, 9, 9])).all()


def test_permutations_match_jax():
    """permute/unpermute of rows and columns and the inverse, on one
    matrix and on a batch with a permutation each; results exact, and the
    inverse keeps the permutation's integer dtype. One permutation also
    broadcasts over a batch (the JAX package's take_along_axis does not),
    against numpy's indexing."""
    rng = np.random.default_rng(560)
    p = rng.permutation(6).astype(np.int32)
    pb = np.stack([rng.permutation(6) for _ in range(2)]).astype(np.int32)
    a = rng.standard_normal((2, 6, 6))
    for name in ("permute_rows", "permute_cols", "unpermute_rows",
                 "unpermute_cols"):
        for arr, perm in ((a[0], p), (a, pb)):
            want = np.asarray(getattr(jla, name)(arr, perm))
            got = getattr(la, name)(_t(arr), _t(perm))
            assert np.array_equal(got.numpy(), want), name
    assert np.array_equal(la.permute_rows(_t(a), _t(p)).numpy(), a[:, p])
    assert np.array_equal(la.permute_cols(_t(a), _t(p)).numpy(), a[:, :, p])
    inv = la.invert_permutation(_t(pb))
    assert inv.dtype == torch.int32
    assert np.array_equal(inv.numpy(), np.asarray(jla.invert_permutation(pb)))
    assert np.array_equal(
        la.permute_rows(np.arange(6.0)[:, None], p, device="cpu").numpy(),
        np.arange(6.0)[p][:, None])

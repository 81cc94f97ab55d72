"""The port's ``dt`` and the single-matrix ``la/`` internals that ``opt/``
imports, held against the JAX package on the CPU, on the same numpy
inputs from fixed seeds, in float64.

``_qr_core`` and ``_rrqr_core`` are compared entry by entry: with equal
pivots (compared exactly; the inputs have no near-ties) the Householder
factorisation is unique, so R and Q within 1e-12 relative to max|A|.
``srrqr_decomp_full`` and ``urv_decomp_full`` on full-rank inputs the
same way; on rank-deficient ones Q's and V's trailing columns span a
null space that rounding chooses, so there they are held by contract
(orthogonal within 64·eps·n, the product within 1e-12·max|A|, R zero
outside its rank×rank block) with the rank and the leading pivots equal.
The minimum-norm solutions of ``urv_lstsq`` and ``lstsq(method="urv")``
are unique and are compared within 1e-10·max|x|; ``tri_inv`` and the
``scan``, ``inv`` and ``block`` solves within 1e-12.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu import dt as jdt
from nd4js_tpu import la as jla

from nd4js_tpu_torch import dt, la

jqr = importlib.import_module("nd4js_tpu.la.qr")
jrrqr = importlib.import_module("nd4js_tpu.la.rrqr")
jsrrqr = importlib.import_module("nd4js_tpu.la.srrqr")
jurv = importlib.import_module("nd4js_tpu.la.urv")
jtri = importlib.import_module("nd4js_tpu.la.tri")

# the JAX references, compiled (their eager loops dispatch op by op)
j_qr_core = jax.jit(jqr._qr_core, static_argnums=1)
j_rrqr_core = jax.jit(jrrqr._rrqr_core, static_argnums=1)
j_srrqr = jax.jit(jsrrqr.srrqr_decomp_full)
j_urv = jax.jit(jurv.urv_decomp_full)
j_lstsq_urv = jax.jit(lambda a, y: jla.lstsq(a, y, method="urv"))
pqr = importlib.import_module("nd4js_tpu_torch.la.qr")
prrqr = importlib.import_module("nd4js_tpu_torch.la.rrqr")
ptri = importlib.import_module("nd4js_tpu_torch.la.tri")

CPU = "cpu"
EPS64 = np.finfo(np.float64).eps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The single-matrix loops are many tiny torch ops; under pytest-xdist
    several workers share the cores, and a multi-threaded intra-op pool
    for each tiny op makes them slower. One thread per worker for this
    module's tests; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _rank_deficient(rng, m, n, r):
    return rng.standard_normal((m, r)) @ rng.standard_normal((r, n))


# ------------------------------------------------------------------- dt

def test_dt_array_types_and_promotion_match_the_jax_package():
    assert sorted(dt.ARRAY_TYPES) == sorted(jdt.ARRAY_TYPES)
    for name in set(dt.ARRAY_TYPES) - {"int32"}:
        assert dt.eps(name) == jdt.eps(name)
        assert dt.eps(dt.ARRAY_TYPES[name]) == jdt.eps(name)
    names = sorted(dt.ARRAY_TYPES)
    for a in names:
        for b in names:
            assert dt.is_subdtype(a, b) == jdt.is_subdtype(a, b)
            got = dt.super_dtype(a, dt.ARRAY_TYPES[b])
            assert str(got).removeprefix("torch.") == \
                jdt.super_dtype(a, b).name
    with pytest.raises(ValueError):
        dt.super_dtype()
    for bad in ("int8", "int32"):
        with pytest.raises(ValueError):
            jdt.eps(bad)
        with pytest.raises(ValueError):
            dt.eps(bad)


@pytest.mark.parametrize("value", [True, 3, 2 ** 40, -7, 1.5, 2 + 1j,
                                   np.float32(2.0), np.int64(5)])
def test_dt_dtypeof_matches_the_jax_package(value):
    assert dt.dtypeof(value) == jdt.dtypeof(value)


def test_dt_cast_scalar_and_the_float_tricks_match_the_jax_package():
    x = np.array([0.0, 1.0, -2.5, 1e-300, 3.4e38], np.float64)
    for dtype in ("float32", "float64"):
        xs = x.astype(dtype)
        for f, g in ((dt.next_up, jdt.next_up), (dt.next_down,
                                                 jdt.next_down)):
            assert np.array_equal(_np(f(xs, device=CPU)), np.asarray(g(xs)))
    y = np.array([1.0, 3.0, 1e308, -1e308, 0.5])
    assert np.array_equal(_np(dt.midl(x, y, device=CPU)),
                          np.asarray(jdt.midl(x, y)))
    got = dt.cast_scalar(2.5, "float32", device=CPU)
    assert got.dtype == torch.float32 and float(got) == 2.5


def test_dt_bit_count_matches_the_jax_package():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.integers(-2 ** 31, 2 ** 31, 200, dtype=np.int64),
                        [0, -1, 2 ** 31 - 1, -2 ** 31]]).astype(np.int32)
    got = dt.bit_count(x, device=CPU)
    assert got.dtype == torch.int32
    assert np.array_equal(_np(got), np.asarray(jdt.bit_count(x)))


# ------------------------------------------------- the single-matrix QRs

SHAPES = {"tall": (13, 7), "wide": (6, 11), "square": (9, 9),
          "panel_of_two": (150, 131)}


@pytest.mark.parametrize("economic", [True, False])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_qr_core_matches_the_jax_package(name, economic):
    """Equal R and Q (the Householder sign convention makes them unique);
    the 131 columns of ``panel_of_two`` take two panels of 128."""
    a = np.random.default_rng(10 + sorted(SHAPES).index(name)) \
        .standard_normal(SHAPES[name])
    q_ref, r_ref = j_qr_core(jnp.asarray(a), economic)
    q, r = pqr._qr_core(_t(a), economic)
    amax = np.abs(a).max()
    assert np.abs(_np(r) - np.asarray(r_ref)).max() <= 1e-12 * amax
    assert np.abs(_np(q) - np.asarray(q_ref)).max() <= 1e-12


@pytest.mark.parametrize("economic", [True, False])
@pytest.mark.parametrize("name", sorted(SHAPES))
def test_rrqr_core_matches_the_jax_package(name, economic):
    """Exact-norm pivots equal, R and Q within 1e-12."""
    a = np.random.default_rng(20 + sorted(SHAPES).index(name)) \
        .standard_normal(SHAPES[name])
    q_ref, r_ref, p_ref = j_rrqr_core(jnp.asarray(a), economic)
    q, r, p = prrqr._rrqr_core(_t(a), economic)
    assert p.dtype == torch.int32
    assert np.array_equal(_np(p), np.asarray(p_ref))
    amax = np.abs(a).max()
    assert np.abs(_np(r) - np.asarray(r_ref)).max() <= 1e-12 * amax
    assert np.abs(_np(q) - np.asarray(q_ref)).max() <= 1e-12


def test_rrqr_core_takes_the_first_of_equal_norms():
    """Tied column norms: both packages take the first index, as
    ``jnp.argmax`` does."""
    a = np.array([[3.0, 0.0, 4.0, 0.0], [4.0, 5.0, 3.0, 1.0],
                  [0.0, 0.0, 0.0, 2.0]])
    _, _, p_ref = j_rrqr_core(jnp.asarray(a), True)
    _, _, p = prrqr._rrqr_core(_t(a), True)
    assert np.array_equal(_np(p), np.asarray(p_ref))
    assert int(p[0]) == 0


def _orth_defect(q):
    q = _np(q)
    return np.abs(q.T @ q - np.eye(q.shape[-1])).max()


@pytest.mark.parametrize("shape", [(9, 6), (6, 9), (8, 8)])
def test_srrqr_full_rank_matches_the_jax_package(shape):
    a = np.random.default_rng(30 + shape[0]).standard_normal(shape)
    ref = j_srrqr(jnp.asarray(a))
    got = la.srrqr_decomp_full(a, device=CPU)
    amax = np.abs(a).max()
    assert int(got[3]) == int(ref[3]) == min(shape)
    assert np.array_equal(_np(got[2]), np.asarray(ref[2]))
    assert np.abs(_np(got[1]) - np.asarray(ref[1])).max() <= 1e-12 * amax
    assert np.abs(_np(got[0]) - np.asarray(ref[0])).max() <= 1e-12


@pytest.mark.parametrize("shape,rank", [((10, 8), 4), ((7, 9), 3),
                                        ((8, 8), 5)])
def test_srrqr_rank_deficient_by_contract(shape, rank):
    a = _rank_deficient(np.random.default_rng(40 + rank), *shape, rank)
    q_ref, r_ref, p_ref, k_ref = j_srrqr(jnp.asarray(a))
    q, r, p, k = la.srrqr_decomp_full(a, device=CPU)
    amax = np.abs(a).max()
    assert int(k) == int(k_ref) == rank
    assert int(la.srrqr_rank(r)) == rank
    assert np.array_equal(_np(p)[:rank], np.asarray(p_ref)[:rank])
    assert np.abs(_np(r)[:rank, :rank] - np.asarray(r_ref)[:rank, :rank]) \
        .max() <= 1e-12 * amax
    assert _orth_defect(q) <= 64 * EPS64 * shape[0]
    assert np.abs(_np(q) @ _np(r) - a[:, _np(p)]).max() <= 1e-12 * amax
    assert np.abs(_np(r)[rank:, rank:]).max() <= 1e-12 * amax


def _urv_contract(a, u, r, v, k):
    amax = np.abs(a).max()
    u, r, v = _np(u), _np(r), _np(v)
    assert _orth_defect(u) <= 64 * EPS64 * a.shape[0]
    assert _orth_defect(v) <= 64 * EPS64 * a.shape[1]
    assert np.abs(u @ r @ v - a).max() <= 1e-12 * amax
    outside = r.copy()
    outside[:k, :k] = np.tril(outside[:k, :k])
    outside[:k, :k] = 0
    assert np.abs(outside).max() <= 1e-12 * amax
    assert np.abs(np.triu(r[:k, :k], 1)).max() == 0.0


@pytest.mark.parametrize("shape,rank", [((9, 6), 6), ((6, 9), 6),
                                        ((10, 8), 4), ((7, 9), 3)])
def test_urv_decomp_full_and_its_lstsq(shape, rank):
    """The factors by contract and, on full-rank input, entry by entry;
    the minimum-norm solution against the JAX package's and numpy's."""
    rng = np.random.default_rng(50 + rank + shape[0])
    a = rng.standard_normal(shape) if rank == min(shape) \
        else _rank_deficient(rng, *shape, rank)
    y = rng.standard_normal((shape[0], 2))
    ref = j_urv(jnp.asarray(a))
    u, r, v, k = la.urv_decomp_full(a, device=CPU)
    assert int(k) == int(ref[3]) == rank
    _urv_contract(a, u, r, v, rank)
    if rank == min(shape):
        for got, want in zip((u, r, v), ref[:3]):
            assert np.abs(_np(got) - np.asarray(want)).max() <= \
                1e-12 * np.abs(a).max()
    x_ref = np.asarray(jurv.urv_lstsq(*ref, jnp.asarray(y)))
    x = _np(la.urv_lstsq(u, r, v, k, y))
    tol = 1e-10 * np.abs(x_ref).max()
    assert np.abs(x - x_ref).max() <= tol
    assert np.abs(x - np.linalg.pinv(a) @ y).max() <= tol
    x_l = _np(la.lstsq(a, y, method="urv", device=CPU))
    x_lref = np.asarray(j_lstsq_urv(jnp.asarray(a), jnp.asarray(y)))
    assert np.abs(x_l - x_lref).max() <= tol


def test_urv_decomp_full_is_batched():
    """A (2, 3) batch of full-rank and rank-deficient matrices, each
    swapping on its own, as under the JAX package's vmap."""
    rng = np.random.default_rng(60)
    a = rng.standard_normal((2, 3, 8, 6))
    a[1, 2] = _rank_deficient(rng, 8, 6, 2)
    ref = j_urv(jnp.asarray(a))
    u, r, v, k = la.urv_decomp_full(a, device=CPU)
    assert tuple(u.shape) == (2, 3, 8, 8) and tuple(v.shape) == (2, 3, 6, 6)
    assert np.array_equal(_np(k), np.asarray(ref[3]))
    for idx in np.ndindex(2, 3):
        _urv_contract(a[idx], u[idx], r[idx], v[idx], int(k[idx]))
    y = rng.standard_normal((2, 3, 8, 1))
    x_ref = np.asarray(jurv.urv_lstsq(*ref, jnp.asarray(y)))
    x = _np(la.urv_lstsq(u, r, v, k, y))
    assert np.abs(x - x_ref).max() <= 1e-10 * np.abs(x_ref).max()


# -------------------------------------------------- triangular inverses

def _lower(rng, shape):
    n = shape[-1]
    return np.tril(rng.standard_normal(shape)) + 4 * np.eye(n)


@pytest.mark.parametrize("n", [1, 5, 40, 150])
@pytest.mark.parametrize("lower", [True, False])
def test_tri_inv_matches_the_jax_package(n, lower):
    """n = 150 takes the blocked path (columns of 128)."""
    a = _lower(np.random.default_rng(70 + n), (2, n, n))
    if not lower:
        a = np.swapaxes(a, -1, -2)
    ref = np.asarray(jtri.tri_inv(jnp.asarray(a), lower=lower))
    got = _np(la.tri_inv(a, lower=lower, device=CPU))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("method", ["scan", "inv", "block"])
@pytest.mark.parametrize("lower", [True, False])
@pytest.mark.parametrize("batch", [(), (3,)])
def test_solves_by_every_method_match_the_jax_package(method, lower, batch):
    rng = np.random.default_rng(80)
    t = _lower(rng, batch + (12, 12))
    if not lower:
        t = np.swapaxes(t, -1, -2)
    y = rng.standard_normal(batch + (12, 3))
    jf, pf = (jtri.tril_solve, la.tril_solve) if lower \
        else (jtri.triu_solve, la.triu_solve)
    ref = np.asarray(jf(jnp.asarray(t), jnp.asarray(y), method=method))
    got = _np(pf(t, y, method=method, device=CPU))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    jt, pt = (jtri.tril_t_solve, la.tril_t_solve) if lower \
        else (jtri.triu_t_solve, la.triu_t_solve)
    ref = np.asarray(jt(jnp.asarray(t), jnp.asarray(y), method=method))
    got = _np(pt(t, y, method=method, device=CPU))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


def test_scan_solve_is_the_classical_substitution():
    """x_i = (y_i − Σ_{j<i} L_ij x_j) / L_ii in plain Python, against
    ``method="scan"``: equal to rounding."""
    rng = np.random.default_rng(81)
    L = _lower(rng, (7, 7))
    y = rng.standard_normal((7, 2))
    x = np.zeros_like(y)
    for i in range(7):
        x[i] = (y[i] - L[i, :i] @ x[:i]) / L[i, i]
    got = _np(la.tril_solve(L, y, method="scan", device=CPU))
    assert np.abs(got - x).max() <= 4 * EPS64 * np.abs(x).max()


def test_unknown_solve_method_raises():
    with pytest.raises(ValueError):
        la.tril_solve(np.eye(3), np.ones((3, 1)), method="lu", device=CPU)


def test_the_solves_core_entry_takes_tensors():
    """``_triu_solve.core``, the entry the trust region calls where the
    JAX package calls ``triu_solve.core``."""
    rng = np.random.default_rng(82)
    u = np.swapaxes(_lower(rng, (6, 6)), -1, -2)
    y = rng.standard_normal((6, 1))
    ref = np.asarray(jla.triu_solve.core(jnp.asarray(u), jnp.asarray(y),
                                         method="block"))
    got = _np(ptri._triu_solve.core(_t(u), _t(y), "block"))
    assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()

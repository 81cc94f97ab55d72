"""The rest of the port's ``la`` surface held against the JAX package on
the CPU, on the same numpy inputs from fixed seeds: ``eye``, ``diag``,
``diag_mat``, ``transpose_inplace``, ``norm``, ``safe_norm_2``, the n-ary
``matmul`` (its product and its parenthesisation), ``ldl_decomp`` and
``ldl_solve``, ``pldlp_decomp`` with its factors and solve, and
``bidiag_decomp``; and ``rand`` by contract.

Outputs that are unique are compared directly, in float64, within 1e-10
of the largest entry of the reference: the small surface, the matmul
product, L and d, LD, U, B and V. ``pldlp``'s P and ``blk`` must be equal
exactly, on an indefinite input that takes at least one 2×2 pivot. The
JAX package's (L, d) and (LD, P, blk), as numpy arrays, go into the
port's solves as they are and give the JAX solutions. The float32 cases
hold the port in float32 against the JAX package's float64 factors
within 1e-4 of the largest entry: the recursions amplify eps32 by at most
n·κ of these well-conditioned inputs. ``rand``'s streams are not JAX's,
so it is held by contract: reproducible from its seed, ``ortho``
orthonormal to 4·eps·max(M, N) in its shape, ``rankdef`` of the rank it
returns, and the deprecated functions warn.

Each JAX reference runs once per shape, jitted, in a module-scoped cache:
its first call compiles (about 2-6 s each).
"""
import functools
import importlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla

from nd4js_tpu_torch import la, rand

jmatmul = importlib.import_module("nd4js_tpu.la.matmul")
pmatmul = importlib.import_module("nd4js_tpu_torch.la.matmul")

CPU = "cpu"
RTOL = 1e-10
RTOL32 = 1e-4
EPS64 = np.finfo(np.float64).eps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Loops of small torch ops; one intra-op thread per xdist worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def close(x, ref, rtol=RTOL):
    """max |x − ref| ≤ rtol·max |ref| (exactly equal where ref is 0)."""
    x, ref = _np(x), _np(ref)
    assert x.shape == ref.shape
    scale = np.abs(ref).max() if ref.size else 0.0
    assert np.abs(x - ref).max(initial=0.0) <= rtol * scale


# ---------------------------------------------------------------- surface

@pytest.mark.parametrize("shape", [(3,), (2, 4), (2, 3, 4, 5)])
def test_eye(shape):
    got = la.eye(*shape, dtype=torch.float64, device=CPU)
    want = jla.eye(*shape, dtype=jnp.float64)
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(_np(got), np.asarray(want))


def test_eye_default_dtype_is_float32():
    assert la.eye(3, device=CPU).dtype == torch.float32


@pytest.mark.parametrize("offset", [-2, 0, 1, 3])
def test_diag(offset):
    a = np.random.default_rng(1).standard_normal((2, 3, 4, 5))
    np.testing.assert_array_equal(_np(la.diag(a, offset, device=CPU)),
                                  np.asarray(jla.diag(a, offset)))


def test_diag_mat_spreads_non_finite_entries_as_jax_does():
    d = np.random.default_rng(2).standard_normal((2, 3, 5))
    d[1, 2, 3] = np.inf
    np.testing.assert_array_equal(_np(la.diag_mat(d, device=CPU)),
                                  np.asarray(jla.diag_mat(d)))


def test_transpose_inplace():
    a = np.random.default_rng(3).standard_normal((2, 3, 4))
    np.testing.assert_array_equal(_np(la.transpose_inplace(a, device=CPU)),
                                  np.asarray(jla.transpose_inplace(a)))


@pytest.mark.parametrize("ord_, axes", [("fro", None), (None, None),
                                        ("fro", (0, 2)), (None, (1,))])
def test_norm(ord_, axes):
    a = np.random.default_rng(4).standard_normal((3, 4, 5)) * 1e200
    close(la.norm(a, ord_, axes, device=CPU), jla.norm(a, ord_, axes))


@pytest.mark.parametrize("ord_", [2, "nuc", 1])
def test_norm_other_orders_are_refused_by_both(ord_):
    a = np.ones((2, 2))
    with pytest.raises(NotImplementedError):
        jla.norm(a, ord_)
    with pytest.raises(NotImplementedError):
        la.norm(a, ord_, device=CPU)


@pytest.mark.parametrize("axis, keepdims", [(-1, False), (0, True),
                                            (1, False)])
def test_safe_norm_2_tiny_and_huge(axis, keepdims):
    x = np.random.default_rng(5).standard_normal((3, 4, 6))
    x[0] *= 1e-300
    x[1] *= 1e300
    close(la.safe_norm_2(x, axis, keepdims, device=CPU),
          jla.safe_norm_2(x, axis, keepdims))


# ---------------------------------------------------------------- matmul

CHAIN = [(2, 1, 10, 30), (3, 30, 5), (5, 60), (60, 8)]


def _chain_inputs(dtype=np.float64):
    rng = np.random.default_rng(6)
    return [rng.standard_normal(s).astype(dtype) for s in CHAIN]


def _products(monkeypatch, mod, mats, call):
    """The (left, right) shapes of each binary product ``mod.matmul``'s
    chain makes, in order, and its result."""
    seen = []
    inner = mod.matmul2

    def recording(a, b, *args, **kw):
        seen.append((tuple(a.shape), tuple(b.shape)))
        return inner(a, b, *args, **kw)

    monkeypatch.setattr(mod, "matmul2", recording)
    out = call(*mats)
    monkeypatch.setattr(mod, "matmul2", inner)
    return seen, out


def test_chain_order_tables_equal():
    dims = [10, 30, 5, 60, 8]
    assert pmatmul._chain_order(dims) == jmatmul._chain_order(dims)
    dims = [7, 3, 9, 2, 11, 4]
    assert pmatmul._chain_order(dims) == jmatmul._chain_order(dims)


def test_matmul_chain_product_and_order(monkeypatch):
    """A 4-matrix chain with unequal dims: the same binary products in
    the same order (so the same parenthesisation), the same result."""
    mats = _chain_inputs()
    jseen, want = _products(monkeypatch, jmatmul, mats, jla.matmul)
    pseen, got = _products(monkeypatch, pmatmul, mats,
                           lambda *m: la.matmul(*m, device=CPU))
    assert pseen == jseen
    assert len(pseen) == 3
    close(got, want)


@pytest.mark.parametrize("n", [1, 2])
def test_matmul_short_chains(n):
    mats = _chain_inputs()[-n:]
    close(la.matmul(*mats, device=CPU), jla.matmul(*mats))


def test_matmul_promotes_integers_to_float64():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    b = np.arange(12, dtype=np.int32).reshape(3, 4)
    c = np.ones((4, 2), np.int32)
    got = la.matmul(a, b, c, device=CPU)
    want = jla.matmul(a, b, c)
    assert got.dtype == torch.float64 and str(want.dtype) == "float64"
    close(got, want)


def test_matmul_errors():
    with pytest.raises(ValueError):
        la.matmul(device=CPU)
    with pytest.raises(ValueError):
        la.matmul(np.ones((2, 3)), np.ones((4, 5)), np.ones((5, 1)),
                  device=CPU)


# ---------------------------------------------------------------- ldl

def _ldl_input(n, batch=3, seed=7):
    """Symmetric, diagonally dominant with mixed-sign diagonal: every
    leading minor is nonsingular, and D has both signs."""
    rng = np.random.default_rng(seed)
    s = rng.standard_normal((batch, n, n))
    s = (s + np.swapaxes(s, -1, -2)) / 2
    sign = np.where(np.arange(n) % 3 == 1, -1.0, 1.0)
    return s + np.eye(n) * sign * (2 * n)


@functools.lru_cache(maxsize=None)
def _jax_ldl(n):
    a = _ldl_input(n)
    l, d = jax.jit(jla.ldl_decomp)(a)
    y = np.random.default_rng(n).standard_normal((3, n, 2))
    x = jax.jit(jla.ldl_solve)(l, d, y)
    return a, y, np.asarray(l), np.asarray(d), np.asarray(x)


@pytest.mark.parametrize("n", [12, 40])
def test_ldl_decomp(n):
    """n = 12 is the unrolled leaf, n = 40 two levels of the recursion."""
    a, _, l_ref, d_ref, _ = _jax_ldl(n)
    l, d = la.ldl_decomp(a, device=CPU)
    close(l, l_ref)
    close(d, d_ref)
    assert (d_ref < 0).any() and (d_ref > 0).any()


@pytest.mark.parametrize("n", [12, 40])
def test_ldl_solve_of_the_jax_factors(n):
    a, y, l_ref, d_ref, x_ref = _jax_ldl(n)
    close(la.ldl_solve(l_ref, d_ref, y, device=CPU), x_ref)
    l, d = la.ldl_decomp(a, device=CPU)
    close(la.ldl_solve(l, d, y), x_ref)


def test_ldl_float32():
    a, y, l_ref, d_ref, x_ref = _jax_ldl(40)
    l, d = la.ldl_decomp(torch.from_numpy(a).float())
    assert l.dtype == torch.float32
    close(l.double(), l_ref, RTOL32)
    close(d.double(), d_ref, RTOL32)
    x = la.ldl_solve(l, d, torch.from_numpy(y).float())
    close(x.double(), x_ref, RTOL32)


# ---------------------------------------------------------------- pldlp

def _pldlp_input():
    """Symmetric indefinite, with small diagonals so that Bunch-Kaufman
    swaps and takes 2×2 pivots."""
    rng = np.random.default_rng(8)
    s = rng.standard_normal((3, 24, 24))
    a = (s + np.swapaxes(s, -1, -2)) / 2
    a[:, np.arange(24), np.arange(24)] *= 0.05
    return a


@functools.lru_cache(maxsize=None)
def _jax_pldlp():
    a = _pldlp_input()
    ld, p, blk = jax.jit(jla.pldlp_decomp)(a)
    y = np.random.default_rng(9).standard_normal((3, 24, 3))
    x = jax.jit(jla.pldlp_solve)(ld, p, blk, y)
    factors = jax.jit(lambda ld, p, blk: (
        jla.pldlp_l(ld, blk), jla.pldlp_d(ld, blk),
        jla.pldlp_p(p, jnp.float64)))(ld, p, blk)
    return (a, y, np.asarray(ld), np.asarray(p), np.asarray(blk),
            np.asarray(x), [np.asarray(f) for f in factors])


def test_pldlp_decomp_pivots_equal_exactly():
    a, _, ld_ref, p_ref, blk_ref, _, _ = _jax_pldlp()
    assert blk_ref.any(), "the input takes a 2×2 pivot"
    assert (p_ref != np.arange(24)).any(), "the input swaps"
    ld, p, blk = la.pldlp_decomp(a, device=CPU)
    assert p.dtype == torch.int32 and blk.dtype == torch.bool
    np.testing.assert_array_equal(_np(p), p_ref)
    np.testing.assert_array_equal(_np(blk), blk_ref)
    close(ld, ld_ref)


def test_pldlp_factors():
    a, _, ld_ref, p_ref, blk_ref, _, (l_ref, d_ref, pm_ref) = _jax_pldlp()
    l = la.pldlp_l(ld_ref, blk_ref, device=CPU)
    d = la.pldlp_d(ld_ref, blk_ref, device=CPU)
    pm = la.pldlp_p(p_ref, torch.float64, device=CPU)
    np.testing.assert_array_equal(_np(l), l_ref)
    np.testing.assert_array_equal(_np(d), d_ref)
    np.testing.assert_array_equal(_np(pm), pm_ref)
    # A[P][:, P] = L·D·Lᵀ
    ap = np.take_along_axis(np.take_along_axis(
        a, p_ref[:, :, None].astype(np.int64), 1),
        p_ref[:, None, :].astype(np.int64), 2)
    rec = _np(l) @ _np(d) @ np.swapaxes(_np(l), -1, -2)
    assert np.abs(rec - ap).max() <= 1e3 * EPS64 * np.abs(a).max()


def test_pldlp_solve_of_the_jax_factors():
    a, y, ld_ref, p_ref, blk_ref, x_ref, _ = _jax_pldlp()
    assert p_ref.dtype == np.int32 and blk_ref.dtype == np.bool_
    close(la.pldlp_solve(ld_ref, p_ref, blk_ref, y, device=CPU), x_ref)
    close(la.pldlp_solve(*la.pldlp_decomp(a, device=CPU), y), x_ref)


def test_pldlp_solve_broadcasts_one_right_hand_side():
    a, y, ld_ref, p_ref, blk_ref, x_ref, _ = _jax_pldlp()
    x = la.pldlp_solve(ld_ref[1], p_ref[1], blk_ref[1], y[1], device=CPU)
    close(x, x_ref[1])


def test_pldlp_float32():
    a, y, ld_ref, p_ref, blk_ref, x_ref, _ = _jax_pldlp()
    ld, p, blk = la.pldlp_decomp(torch.from_numpy(a).float())
    assert ld.dtype == torch.float32
    np.testing.assert_array_equal(_np(p), p_ref)
    np.testing.assert_array_equal(_np(blk), blk_ref)
    close(ld.double(), ld_ref, RTOL32)
    x = la.pldlp_solve(ld, p, blk, torch.from_numpy(y).float())
    close(x.double(), x_ref, RTOL32)


# ---------------------------------------------------------------- bidiag

BIDIAG = {"tall": (3, 20, 14), "wide": (2, 9, 13), "square": (2, 6, 6)}


@functools.lru_cache(maxsize=None)
def _jax_bidiag(name):
    a = np.random.default_rng(10 + sorted(BIDIAG).index(name)) \
        .standard_normal(BIDIAG[name])
    return a, [np.asarray(x) for x in jax.jit(jla.bidiag_decomp)(a)]


@pytest.mark.parametrize("name", sorted(BIDIAG))
def test_bidiag_decomp(name):
    """U, B and V entry by entry; J = K for M ≥ N, K + 1 for M < N."""
    a, (u_ref, b_ref, v_ref) = _jax_bidiag(name)
    u, b, v = la.bidiag_decomp(a, device=CPU)
    m, n = a.shape[-2:]
    k = min(m, n)
    assert b.shape[-2:] == (k, k if m >= n else k + 1)
    for got, want in ((u, u_ref), (b, b_ref), (v, v_ref)):
        close(got, want)
    assert np.abs(_np(u) @ _np(b) @ _np(v) - a).max() \
        <= 32 * EPS64 * max(m, n) * np.abs(a).max()


def test_bidiag_float32():
    a, (u_ref, b_ref, v_ref) = _jax_bidiag("tall")
    u, b, v = la.bidiag_decomp(torch.from_numpy(a).float())
    for got, want in ((u, u_ref), (b, b_ref), (v, v_ref)):
        close(got.double(), want, RTOL32)


# ---------------------------------------------------------------- rand

def test_rng_is_reproducible_from_its_seed():
    for seed in (7, "seven"):
        one, two = rand.RNG(seed, CPU), rand.RNG(seed, CPU)
        for draw in (lambda r: r.normal(3, 4), lambda r: r.uniform(1, 2, 5),
                     lambda r: r.int(0, 9, 6), lambda r: r.bool(7),
                     lambda r: r.ortho(2, 5, 3),
                     lambda r: r.shuffle(np.arange(8))):
            np.testing.assert_array_equal(_np(draw(one)), _np(draw(two)))
    assert not torch.equal(rand.RNG(1, CPU).normal(4),
                           rand.RNG(2, CPU).normal(4))


def test_rng_draws():
    r = rand.RNG(11, CPU)
    assert isinstance(r.int(3, 5), int) and 3 <= r.int(3, 5) < 5
    i = r.int(-2, 3, 100)
    assert i.dtype == torch.int32 and int(i.min()) >= -2 and int(i.max()) < 3
    u = r.uniform(1.5, 2.5, 200, dtype=torch.float64)
    assert u.dtype == torch.float64
    assert float(u.min()) >= 1.5 and float(u.max()) < 2.5
    assert r.normal(2, 3).dtype == torch.float32
    assert isinstance(r.bool(), bool) and r.bool(4).dtype == torch.bool
    s = r.shuffle(np.arange(10).reshape(5, 2), axis=0)
    assert sorted(_np(s)[:, 0].tolist()) == [0, 2, 4, 6, 8]
    assert (_np(s)[:, 1] == _np(s)[:, 0] + 1).all()


@pytest.mark.parametrize("shape", [(5,), (3, 7, 4), (2, 4, 7), (6, 6)])
def test_ortho_is_orthonormal(shape):
    q = _np(rand.RNG(12, CPU).ortho(*shape, dtype=torch.float64))
    m, n = (shape[0], shape[0]) if len(shape) == 1 else shape[-2:]
    assert q.shape == tuple(shape[:-2]) + (m, n) if len(shape) > 1 \
        else q.shape == (m, n)
    k = min(m, n)
    g = np.swapaxes(q, -1, -2) @ q if m >= n else q @ np.swapaxes(q, -1, -2)
    assert np.abs(g - np.eye(k)).max() <= 4 * EPS64 * max(m, n)


def test_ortho_float32_and_jax_shapes():
    q = rand.RNG(13, CPU).ortho(2, 6, 4)
    assert q.dtype == torch.float32
    assert np.abs(_np(q.mT @ q) - np.eye(4)).max() \
        <= 4 * np.finfo(np.float32).eps * 6


@pytest.mark.parametrize("shape, rank", [((2, 6, 5), 3), ((7, 4), 4),
                                         ((3, 5, 8), 0)])
def test_rankdef_rank(shape, rank):
    a, r = rand.RNG(14, CPU).rankdef(*shape, rank=rank, dtype=torch.float64)
    assert r == rank and tuple(a.shape) == shape
    assert (np.linalg.matrix_rank(_np(a)) == rank).all()


def test_rankdef_draws_its_rank():
    a, r = rand.RNG(15, CPU).rankdef(2, 6, 5, dtype=torch.float64)
    assert isinstance(r, int) and 0 <= r <= 5
    assert (np.linalg.matrix_rank(_np(a)) == r).all()


@pytest.mark.parametrize("fn", [lambda: rand.rand_normal(3, device=CPU),
                                lambda: rand.rand_ortho(4, device=CPU),
                                lambda: la.rand_ortho(2, 4, 3, device=CPU)])
def test_deprecated_functions_warn(fn):
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        out = fn()
    assert any(issubclass(x.category, DeprecationWarning) for x in w)
    assert torch.isfinite(out).all()


def test_deprecated_functions_draw_a_fixed_stream():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        assert torch.equal(rand.rand_normal(4, device=CPU),
                           rand.rand_normal(4, device=CPU))
        np.testing.assert_array_equal(
            _np(rand.rand_ortho(3, device=CPU)),
            _np(rand.RNG(0xDECAF, CPU).ortho(3)))

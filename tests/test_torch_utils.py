"""The port's ``utils`` held against the JAX package's on the CPU, on the
same numpy inputs from fixed seeds, float64 with x64 on unless a test
says float32: ``regular_simplex`` (within 1e-15), ``linspace`` and the
iteration helpers (equal), ``KDTree`` (indices equal, ties included, the
distances within 1e-12·max(1, max dist); float32 within 1e-5),
``rk4_step``/``odeint_rk4`` (within 1e-12 relative over 100 Lorenz steps)
and the plain-array helpers (equal results; ``shuffle`` a permutation,
reproducible from an ``RNG`` seed; ``checked_array``'s bounds checks).
"""
import itertools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu import config as jconfig
from nd4js_tpu import utils as jutils

from nd4js_tpu_torch import config, rand, utils

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Loops of tiny torch ops: one intra-op thread per pytest worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _close(got, want, tol):
    """max|got − want| ≤ tol·max(1, max|want|)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, np.abs(want).max(initial=0.0))
    assert np.abs(got - want).max(initial=0.0) <= tol * scale


# ------------------------------------------------------------ geometry

@pytest.mark.parametrize("n", [1, 2, 3, 7])
def test_regular_simplex_matches_the_jax_package(n):
    """The JAX side jitted (eager, each of its ops compiles apart)."""
    got = utils.regular_simplex(n, torch.float64, CPU)
    want = jax.jit(jutils.regular_simplex, static_argnums=(0, 1))(
        n, jnp.float64)
    _close(got, want, 1e-15)
    d = torch.cdist(got, got)
    off = d[~torch.eye(n + 1, dtype=torch.bool)]
    assert torch.allclose(off, off[0], rtol=1e-12)
    default = utils.regular_simplex(n, device=CPU)
    assert default.dtype == config.default_float == torch.float32


# ----------------------------------------------------------- iteration

def test_linspace_and_the_iteration_helpers_match():
    got = utils.linspace(0.0, 1.0, 5, dtype=torch.float64, device=CPU)
    assert np.array_equal(got.numpy(), np.asarray(
        jutils.linspace(0.0, 1.0, 5, dtype=jnp.float64)))
    assert utils.linspace(-2, 3, 7, device=CPU).dtype == torch.float32
    assert list(utils.irange(2, 9, 3)) == list(jutils.irange(2, 9, 3))
    assert list(utils.cartesian_prod([1, 2], "ab")) \
        == list(jutils.cartesian_prod([1, 2], "ab"))
    assert list(utils.repeat(7, 3)) == list(jutils.repeat(7, 3))
    assert list(itertools.islice(utils.repeat("ab"), 5)) \
        == list(itertools.islice(jutils.repeat("ab"), 5))
    rng = np.random.default_rng(3)
    v = rng.standard_normal(9)
    for x in ([3, 1, 2, 1], v, v.reshape(3, 3)):
        for name in ("argmin", "argmax", "imin", "imax"):
            want = getattr(jutils, name)(x)
            for arg in (x, torch.from_numpy(np.asarray(x))):
                assert getattr(utils, name)(arg) == want, (name, x)
    assert utils.argmin([3, -4, 2], key=abs) == jutils.argmin([3, -4, 2],
                                                               key=abs)
    assert utils.imax(torch.tensor([2.0, 5.0, 1.0])) == 5.0


# ------------------------------------------------------------- spatial

def _nearest_both(pts, q, k, dtype=np.float64):
    jd, ji = jax.jit(lambda p, q: jutils.KDTree(p).nearest(q, k=k))(
        jnp.asarray(pts, dtype), jnp.asarray(q, dtype))
    pd, pi = utils.KDTree(torch.from_numpy(pts.astype(dtype))).nearest(
        torch.from_numpy(np.asarray(q, dtype)), k=k)
    return (np.asarray(jd), np.asarray(ji)), (pd.numpy(), pi.numpy())


def test_kdtree_nearest_matches_the_jax_package():
    rng = np.random.default_rng(11)
    pts, q = rng.standard_normal((200, 3)), rng.standard_normal((7, 3))
    (jd, ji), (pd, pi) = _nearest_both(pts, q, 5)
    assert np.array_equal(pi, ji)
    _close(pd, jd, 1e-12)
    # float32: the same points
    (jd, ji), (pd, pi) = _nearest_both(pts, q, 5, np.float32)
    assert pd.dtype == np.float32 and np.array_equal(pi, ji)
    _close(pd, jd, 1e-5)
    # one query as a vector
    (jd, ji), (pd, pi) = _nearest_both(pts, q[0], 3)
    assert pi.shape == (3,) and np.array_equal(pi, ji)


def test_kdtree_breaks_ties_by_the_lower_index_as_lax_top_k():
    """A 5×5 integer lattice, queried at lattice points, cell centres and
    edge midpoints: up to four points at one distance, and ties across
    the k-th place. Squared distances of these coordinates are exact in
    both packages, so the indices must be equal, lower index first (the
    distances within 1e-15: XLA's square root and PyTorch's may differ
    by an ulp)."""
    g = np.stack(np.meshgrid(np.arange(5.0), np.arange(5.0),
                             indexing="ij"), -1).reshape(-1, 2)
    pts = g[np.random.default_rng(5).permutation(len(g))]
    q = np.array([[2.0, 2.0], [1.5, 1.5], [2.0, 0.5], [0.0, 0.0],
                  [4.5, 4.5], [3.0, 1.5]])
    for k in (1, 2, 3, 5, 9, 25):
        (jd, ji), (pd, pi) = _nearest_both(pts, q, k)
        assert np.array_equal(pi, ji), (k, pi, ji)
        _close(pd, jd, 1e-15)
    gen = list(utils.KDTree(torch.from_numpy(pts)).nearest_gen(
        torch.tensor([1.5, 1.5], dtype=torch.float64)))
    jgen = list(jutils.KDTree(jnp.asarray(pts)).nearest_gen(
        jnp.asarray([1.5, 1.5])))
    assert [i for _, i in gen] == [i for _, i in jgen]
    assert [d for d, _ in gen] == pytest.approx([d for d, _ in jgen],
                                                abs=1e-12)
    with pytest.raises(ValueError):
        utils.KDTree(torch.zeros(3))


# ----------------------------------------------------------- integrate

def _lorenz(xp):
    def f(t, y):
        x, yy, z = y[..., 0], y[..., 1], y[..., 2]
        return xp.stack([10.0 * (yy - x), x * (28.0 - z) - yy,
                         x * yy - 8.0 / 3.0 * z], -1)
    return f


def test_odeint_rk4_matches_the_jax_package():
    """8 Lorenz systems over 100 steps of 0.005 (a trajectory, y0
    included), and one step of a scalar decay."""
    y0 = np.random.default_rng(2).uniform(-10.0, 10.0, (8, 3))
    ts = np.linspace(0.0, 0.5, 101)
    want = jax.jit(lambda y, t: jutils.odeint_rk4(_lorenz(jnp), y, t))(
        jnp.asarray(y0), jnp.asarray(ts))
    got = utils.odeint_rk4(_lorenz(torch), torch.from_numpy(y0), ts)
    assert got.shape == (101, 8, 3) and got.dtype == torch.float64
    assert torch.equal(got[0], torch.from_numpy(y0))
    _close(got, want, 1e-12)
    one = torch.tensor(1.0, dtype=torch.float64)
    step = utils.rk4_step(lambda t, y: -y, 0.0, one, 0.1)
    assert float(step) == pytest.approx(float(jutils.rk4_step(
        lambda t, y: -y, 0.0, jnp.asarray(1.0), 0.1)), abs=1e-15)
    decay = utils.odeint_rk4(lambda t, y: -y, one, np.linspace(0.0, 1.0, 51))
    assert abs(float(decay[-1]) - math.exp(-1.0)) < 1e-8


# -------------------------------------------------------------- arrays

def test_searches_sorts_and_comparators_match_the_jax_package():
    """On lists, as the JAX package's tests; the port's default comparator
    also takes numpy and tensor elements, where the JAX package's
    subtracts numpy booleans and raises TypeError."""
    a = [1, 3, 3, 3, 7, 9]
    for v in (3, 4, 0, 10, 9):
        want = jutils.binary_search(a, v), jutils.binary_rangesearch(a, v)
        for arr in (a, np.asarray(a), torch.tensor(a)):
            assert utils.binary_search(arr, v) == want[0]
            assert utils.binary_rangesearch(arr, v) == want[1]
    items = [5, 1, 4, 2, 8, 2]
    assert list(utils.heap_sort_gen(items)) \
        == list(jutils.heap_sort_gen(items))
    rev = utils.Comparator().reversed()
    assert list(utils.heap_sort_gen(items, rev)) \
        == list(jutils.heap_sort_gen(items, jutils.Comparator().reversed()))
    pairs = [(0, 5), (1, 3), (2, 5), (3, 1)]
    cmp = utils.Comparator().by_key(lambda p: p[1]).then(
        utils.Comparator().reversed().by_key(lambda p: p[0]))
    jcmp = jutils.Comparator().by_key(lambda p: p[1]).then(
        jutils.Comparator().reversed().by_key(lambda p: p[0]))
    assert list(utils.heap_sort_gen(pairs, cmp)) \
        == list(jutils.heap_sort_gen(pairs, jcmp))
    for x in ([1, 2], (1,), np.zeros(2), torch.zeros(3), "no", 3, None):
        assert utils.is_array(x) == (jutils.is_array(x)
                                     or isinstance(x, torch.Tensor))


def test_shuffle_is_a_permutation_reproducible_from_a_seed():
    x = torch.arange(20)
    a = utils.shuffle(x, rng=rand.RNG(7, device=CPU))
    b = utils.shuffle(x, rng=rand.RNG(7, device=CPU))
    assert torch.equal(a, b) and torch.equal(torch.sort(a).values, x)
    c = utils.shuffle([3, 1, 2])
    assert isinstance(c, list) and sorted(c) == [1, 2, 3]
    d = utils.shuffle(np.arange(5))
    assert sorted(int(v) for v in d) == list(range(5))


def test_checked_array_raises_where_the_jax_package_does(monkeypatch):
    a = np.arange(12.0).reshape(3, 4)
    monkeypatch.setattr(config, "debug_checks", False)
    assert utils.checked_array(a) is a
    monkeypatch.setattr(config, "debug_checks", True)
    monkeypatch.setattr(jconfig, "debug_checks", True)
    ca = utils.checked_array(a, device=CPU)
    jca = jutils.checked_array(a)
    assert len(ca) == len(jca) == 3 and ca.shape == (3, 4)
    for idx in (1, -3, (2, 3), (-1, -4), (slice(None), 0)):
        assert np.array_equal(ca[idx].numpy(), np.asarray(jca[idx]))
    for idx in (3, -4, (0, 4), (3, 0), (1, -5)):
        with pytest.raises(IndexError):
            ca[idx]
        with pytest.raises(IndexError):
            jca[idx]

"""The rest of the port's ``opt`` package held against the JAX package on
the CPU, on the same numpy inputs from fixed seeds, float64 with x64 on
unless a test says float32.

  * ``cauchy_point`` and ``subspace_step`` on compact states (m = 3,
    n = 6) over the edge cases of the breakpoint walk: x_cp, c and the
    subspace minimiser within 1e-12·max(1, |value|) of the JAX scan in
    float64 (1e-5 in float32), ``free`` equal. The port walks by prefix
    sums, so the number of aten ops of one Cauchy point must not grow
    with n: it is counted at n = 128 and n = 1024.
  * The first 1, 3 and 9 L-BFGS-B iterates against the JAX driver
    stopped there (x, f, ∇f within 1e-10 relative, a binding box), and
    ``lbfgsb_minimize``/``min_lbfgsb_gen`` on the four problems of
    ``tests/test_opt_odr_lbfgsb.py:79-120``: equal iteration counts on the
    short runs, x within 1e-10; the Rosenbrock run by contract. The JAX
    driver compiles once for each size, the problem its arguments.
  * ``root_newton``/``root_newton_gen`` (iterates within 1e-12, equal
    counts), ``fit_lin`` in both ``funcs`` forms, regularised (within
    1e-10·max(1, max|p|)), ``num_grad``/``num_grad_forward`` (within
    16·eps·|f|/h of the JAX differences: the packages round f apart),
    ``min1d_gss`` (both within 1e-7 of the minimiser, as the flat minimum
    allows), the three ``root1d_*`` (bisection to the same float), the
    first 50 iterates of Nelder-Mead (within 1e-12) and ``test_fn``'s
    values, gradients and Hessians (within 1e-12 relative).
"""
import functools
import importlib
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from nd4js_tpu import opt as jopt

from nd4js_tpu_torch import convert, opt
from nd4js_tpu_torch.core import host

from tests.test_torch_opt import _np, assert_trees_close, rosen

jsol = importlib.import_module("nd4js_tpu.opt._lbfgsb_solver")
jlb = importlib.import_module("nd4js_tpu.opt._lbfgs_solver")
psol = importlib.import_module("nd4js_tpu_torch.opt._lbfgsb_solver")
plb = importlib.import_module("nd4js_tpu_torch.opt._lbfgs_solver")

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
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, np.abs(want).max(initial=0.0))
    err = np.abs(got - want).max(initial=0.0)
    assert err <= tol * scale, (err, scale)


# ------------------------------------------------ Cauchy point, subspace

M_HIST, N_VARS = 3, 6


@functools.lru_cache(maxsize=None)
def _jupdate():
    return jax.jit(jlb.lbfgs_update)


@functools.lru_cache(maxsize=None)
def _jmodel():
    """The JAX package's compact form, Cauchy point and subspace step,
    compiled once."""
    def model(st, x, g, lo, hi):
        wk = jsol.compact_wk(st)
        x_cp, c, free = jsol.cauchy_point(wk, x, g, lo, hi)
        return x_cp, c, free, jsol.subspace_step(wk, x, g, x_cp, c, free,
                                                  lo, hi)
    return jax.jit(model)


def _memory(rng, pairs, n=N_VARS, m=M_HIST, dtype=np.float64):
    """A JAX ring buffer after ``pairs`` curvature pairs (it wraps past
    m)."""
    st = jlb.lbfgs_init(m, n, dtype)
    for _ in range(pairs):
        s = rng.standard_normal(n)
        y = s * rng.uniform(0.5, 2.0, n) + 0.1 * rng.standard_normal(n)
        st = _jupdate()(st, jnp.asarray(s, dtype), jnp.asarray(y, dtype))
    return st


def _cauchy_case(case, dtype=np.float64):
    rng = np.random.default_rng(["binding", "infinite", "zero_gradient",
                                 "t_break_zero", "empty_memory",
                                 "f2_under_min"].index(case) + 100)
    st = _memory(rng, 0 if case == "empty_memory" else 5, dtype=dtype)
    x = rng.standard_normal(N_VARS)
    g = rng.standard_normal(N_VARS)
    lo = x - rng.uniform(0.05, 0.6, N_VARS)
    hi = x + rng.uniform(0.05, 0.6, N_VARS)
    if case in ("infinite", "f2_under_min"):
        lo[:], hi[:] = -np.inf, np.inf
    if case == "zero_gradient":
        g[1] = 0.0
        lo[4], hi[4] = -np.inf, np.inf
    if case == "t_break_zero":
        x[2], g[2] = hi[2], -1.0
    if case == "f2_under_min":
        g *= 1e-10
    return st, tuple(v.astype(dtype) for v in (x, g, lo, hi))


CAUCHY_CASES = ["binding", "infinite", "zero_gradient", "t_break_zero",
                "empty_memory", "f2_under_min"]


@pytest.mark.parametrize("case", CAUCHY_CASES)
def test_cauchy_point_and_subspace_step_match_the_jax_scan(case):
    st, (x, g, lo, hi) = _cauchy_case(case)
    want = _jmodel()(st, *map(jnp.asarray, (x, g, lo, hi)))
    pst = convert.state_from_numpy(plb.LBFGSState, jax.tree.map(np.asarray,
                                                                st), CPU)
    wk = psol.compact_wk(pst)
    x, g, lo, hi = map(torch.from_numpy, (x, g, lo, hi))
    x_cp, c, free = psol.cauchy_point(wk, x, g, lo, hi)
    x_bar = psol.subspace_step(wk, x, g, x_cp, c, free, lo, hi)
    assert np.array_equal(free.numpy(), np.asarray(want[2]))
    for got, w in ((x_cp, want[0]), (c, want[1]), (x_bar, want[3])):
        _close(got, w, 1e-12)
    # each case reaches the part of the walk it is named for
    t_cp_free = free.numpy()
    if case == "binding":
        assert (~t_cp_free).any() and t_cp_free.any()
    if case in ("infinite", "f2_under_min"):
        assert t_cp_free.all()
    if case == "zero_gradient":
        assert x_cp[1] == x[1] and free[1] and free[4]
    if case == "t_break_zero":
        assert x_cp[2] == x[2] and not free[2]
    if case == "empty_memory":
        assert wk.w.abs().max() == 0
    if case == "f2_under_min":
        # dᵀBd for d = −g is far below f2_min = eps·max(‖d‖², 1) = eps
        f2_0 = torch.dot(g, psol.bv(wk, g))
        assert 0 < f2_0 < torch.finfo(torch.float64).eps / 1e3


def test_cauchy_point_and_subspace_step_in_float32():
    """The port in float32 on the binding case's state and inputs rounded
    to float32, against the JAX package in float64: within 1e-5 (the
    rounding of the inputs moves the result by about 1e-7)."""
    st, (x, g, lo, hi) = _cauchy_case("binding")
    f32 = [v.astype(np.float32).astype(np.float64) for v in (x, g, lo, hi)]
    want = _jmodel()(st, *map(jnp.asarray, f32))
    pst = convert.state_from_numpy(plb.LBFGSState, jax.tree.map(
        lambda v: np.asarray(v).astype(np.float32) if np.asarray(v).dtype
        == np.float64 else np.asarray(v), st), CPU)
    wk = psol.compact_wk(pst)
    x, g, lo, hi = (torch.from_numpy(v).float() for v in f32)
    x_cp, c, free = psol.cauchy_point(wk, x, g, lo, hi)
    x_bar = psol.subspace_step(wk, x, g, x_cp, c, free, lo, hi)
    assert x_cp.dtype == x_bar.dtype == torch.float32
    assert np.array_equal(free.numpy(), np.asarray(want[2]))
    for got, w in ((x_cp, want[0]), (c, want[1]), (x_bar, want[3])):
        _close(got, w, 1e-5)


class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        return func(*args, **(kwargs or {}))


def _cauchy_ops(n):
    """aten ops of one Cauchy point with a full buffer of 8 pairs, half
    the variables' bounds binding."""
    rng = np.random.default_rng(n)
    mem = plb.lbfgs_init(8, n, torch.float64, CPU)
    for _ in range(10):
        s = torch.from_numpy(rng.standard_normal(n))
        mem = plb.lbfgs_update(mem, s, s * 1.5 + 0.1)
    wk = psol.compact_wk(mem)
    x, g = (torch.from_numpy(rng.standard_normal(n)) for _ in range(2))
    lo = torch.where(torch.arange(n) % 2 == 0, x - 0.1, -math.inf)
    hi = torch.full((n,), math.inf, dtype=torch.float64)
    with _CountOps() as count:
        psol.cauchy_point(wk, x, g, lo, hi)
    return count.ops


def test_cauchy_point_ops_do_not_grow_with_n():
    """The walk is prefix sums and a masked argmax, not a host loop over
    the breakpoints: the same ops at n = 128 and n = 1024 (within 10%)."""
    small, big = _cauchy_ops(128), _cauchy_ops(1024)
    assert abs(big - small) < 0.1 * small, (small, big)
    assert small < 1000, small


# ------------------------------------------------------------ L-BFGS-B

def _problem_f(xp, c, e, v, w):
    """v·Σ((x − c)² + e) + w·rosen(x): the four problems with their data
    as arguments (v, w ∈ {0, 1}; a term times 0 adds an exact 0), so that
    the JAX package compiles one driver for each size."""
    return lambda x: v * xp.sum((x - c) ** 2 + e) + w * rosen(xp)(x)


# (c, e, v, w, x0, bounds, max_iter, short, solution):
# tests/test_opt_odr_lbfgsb.py:79-120, Σ(x² − x) written (x − ½)² − ¼
LBFGSB_PROBLEMS = {
    "bounds_active": (2.0, 0.0, 1.0, 0.0, [0.0, 0.0],
                      ([-5.0, -5.0], [1.0, 5.0]), 500, True, [1.0, 2.0]),
    "interior": (0.0, 0.0, 0.0, 1.0, [-1.2, 1.0], (-10.0, 10.0), 800, False,
                 [1.0, 1.0]),
    "start_outside_box": (0.0, 0.0, 1.0, 0.0, [9.0, 9.0, 9.0], (1.0, 5.0),
                          500, True, [1.0, 1.0, 1.0]),
    "x2_minus_x": (0.5, -0.25, 1.0, 0.0, [0.0, 0.0, 0.0], (0.2, 1.0), 500,
                   True, [0.5, 0.5, 0.5]),
}
# the Rosenbrock in [−2, 0.5]² from (−1.2, 1): the upper bound binds
ROSEN_BOX = (0.0, 0.0, 0.0, 1.0, [-1.2, 1.0], (-2.0, 0.5))


@functools.lru_cache(maxsize=None)
def _jlbfgsb_driver():
    """The JAX package's ``lbfgsb_minimize``, jitted with the problem's
    data and iteration cap as arguments."""
    return jax.jit(lambda x0, lo, hi, c, e, v, w, max_iter:
                   jopt.lbfgsb_minimize(_problem_f(jnp, c, e, v, w), x0,
                                        bounds=(lo, hi), max_iter=max_iter))


def _problem(name):
    c, e, v, w, x0, (lo, hi), max_iter, short, sol = LBFGSB_PROBLEMS[name]
    n = len(x0)
    lo, hi = (np.broadcast_to(np.asarray(b, np.float64), (n,))
              for b in (lo, hi))
    jout = _jlbfgsb_driver()(*map(jnp.asarray, (x0, lo, hi, c, e, v, w,
                                                max_iter)))
    return (_problem_f(torch, c, e, v, w), np.asarray(x0), (lo, hi),
            max_iter, short, sol, jout)


@pytest.mark.parametrize("box,k", [(True, 1), (True, 3), (False, 12)])
def test_lbfgsb_first_iterates_match_the_jax_driver(box, k):
    """The JAX driver stopped after k iterations (its cap an argument of
    its one compile) against the port's: x, f and ∇f within 1e-10
    relative. In a box whose upper bound binds (converged at 3), and in
    the interior problem's wide box after 12 iterations, past a full
    memory of 8 (the next iterate depends on all of it)."""
    c, e, v, w, x0, (lo, hi) = ROSEN_BOX if box else \
        LBFGSB_PROBLEMS["interior"][:6]
    lo2, hi2 = np.full(2, lo), np.full(2, hi)
    want = _jlbfgsb_driver()(*map(jnp.asarray, (x0, lo2, hi2, c, e, v, w,
                                                k)))
    got = opt.lbfgsb_minimize(_problem_f(torch, c, e, v, w), np.asarray(x0),
                              bounds=(lo, hi), max_iter=k, device=CPU)
    assert int(got[3]) == int(want[3]) == k
    assert_trees_close(got[:3], want[:3])
    if box:
        assert float(got[0].max()) == hi


@pytest.mark.parametrize("driver", ["lbfgsb_minimize", "min_lbfgsb_gen"])
@pytest.mark.parametrize("name", sorted(LBFGSB_PROBLEMS))
def test_lbfgsb_drivers_match_the_jax_package(name, driver):
    """The port's driver, or its generator taken for as many iterations as
    the JAX driver ran, against the JAX package's ``lbfgsb_minimize``."""
    f, x0, (lo, hi), max_iter, short, sol, (jx, jf, jg, jit_) = \
        _problem(name)
    if driver == "lbfgsb_minimize":
        x, fv, g, it = opt.lbfgsb_minimize(f, x0, bounds=(lo, hi),
                                           max_iter=max_iter, device=CPU)
        if short:
            assert int(it) == int(jit_)
        else:
            assert abs(int(it) - int(jit_)) <= 10, (int(it), int(jit_))
    else:
        gen = opt.min_lbfgsb_gen(f, x0, bounds=(lo, hi), device=CPU)
        for _, (x, fv, g) in zip(range(int(jit_) + 1), gen):
            pass
    if short:
        _close(x, jx, 1e-10)
        _close(fv, jf, 1e-10)
    tol = 1e-6 if short else 1e-4
    assert np.abs(_np(x) - sol).max() < tol
    assert np.abs(np.asarray(jx) - sol).max() < tol


def test_min_lbfgsb_gen_raises_once_it_makes_no_progress():
    """Past the minimiser of Σ(x² − x) on [0.2, 1]³ every search fails;
    the generator raises after more than five failures in a row, carrying
    its point."""
    gen = opt.min_lbfgsb_gen(lambda x: torch.sum(x ** 2 - x), np.zeros(3),
                             bounds=(0.2, 1.0), device=CPU)
    with pytest.raises(opt.OptimizationNoProgressError) as err:
        for _ in zip(range(60), gen):
            pass
    assert np.abs(_np(err.value.x) - 0.5).max() < 1e-6


# ------------------------------------------------------------- Newton

def _circle(xp):
    """x₀² + x₁² = 4, x₀ = x₁ (tests/test_opt_misc.py:41-53)."""
    def fJ(x):
        F = xp.stack([x[0] ** 2 + x[1] ** 2 - 4, x[0] - x[1]])
        J = xp.stack([xp.stack([2 * x[0], 2 * x[1]]),
                      xp.stack([x[0] * 0 + 1.0, x[0] * 0 - 1.0])])
        return F, J
    return fJ


def _bratu(xp, n):
    """−u″ = eᵘ on (0, 1), u = 0 at both ends, n interior points: the
    scaled residual F and its dense Jacobian."""
    h = 1.0 / (n + 1)

    def fJ(u):
        up = xp.concatenate([u[1:], u[:1] * 0])
        um = xp.concatenate([u[:1] * 0, u[:-1]])
        F = (2 * u - up - um) / h ** 2 - xp.exp(u)
        eye = xp.eye(n, dtype=u.dtype)
        off = xp.eye(n, k=1, dtype=u.dtype) if xp is jnp else \
            torch.diag(torch.ones(n - 1, dtype=u.dtype), 1)
        J = (2 * eye - off - off.T) / h ** 2 - eye * xp.exp(u)[None, :]
        return F, J
    return fJ


def test_root_newton_matches_the_jax_package():
    """The driver, its count, and the generator's first iterates, on the
    JAX package's test system; its driver runs jitted (eager, its LU
    compiles slowly)."""
    jfJ, pfJ, x0 = _circle(jnp), _circle(torch), np.array([1.0, 2.0])
    jx, jit_ = jax.jit(lambda z: jopt.root_newton(jfJ, z, tol=1e-9))(
        jnp.asarray(x0))
    x, it = opt.root_newton(pfJ, x0, tol=1e-9, device=CPU)
    assert int(it) == int(jit_) and x.dtype == torch.float64
    _close(x, jx, 1e-12)
    _close(x, [math.sqrt(2), math.sqrt(2)], 1e-10)
    jgen = jopt.root_newton_gen(jfJ, jnp.asarray(x0))
    pgen = opt.root_newton_gen(pfJ, x0, device=CPU)
    for _, j, p in zip(range(6), jgen, pgen):
        _close(p, j, 1e-12)


def test_root_newton_reads_one_flag_an_iteration_and_stops_at_max_iter():
    """A discretised Bratu problem (dense J): in float32 the default tol
    of 1e-12 is out of reach, so the loop runs to max_iter, as the JAX
    package's does; its residual reaches float32's rounding level."""
    before = host.reads
    x, it = opt.root_newton(_bratu(torch, 24), np.zeros(24, np.float32),
                            max_iter=7, device=CPU)
    assert int(it) == 7 and x.dtype == torch.float32
    assert host.reads - before == 7
    F, _ = _bratu(torch, 24)(x)
    assert F.abs().max() < 1e-2


# ------------------------------------------------------------- fit_lin

def _fit_data(m):
    rng = np.random.default_rng(m)
    x = np.linspace(-1.0, 1.0, m)
    return x, 0.5 - 2.0 * x + 3.0 * x ** 2 + 0.01 * rng.standard_normal(m)


def _basis(xp):
    return [lambda x: xp.ones_like(x), lambda x: x, lambda x: x ** 2]


@functools.lru_cache(maxsize=None)
def _jfit_lin():
    """The JAX package's regularised fit of 50 points against 1, x, x²,
    jitted (eager, its interpret-mode kernels take seconds a call)."""
    x, y = _fit_data(50)
    return x, y, np.asarray(jax.jit(lambda u, v: jopt.fit_lin(
        u, v, _basis(jnp), regularization=1e-3))(jnp.asarray(x),
                                                 jnp.asarray(y)))


@pytest.mark.parametrize("form", ["sequence", "design"])
def test_fit_lin_matches_the_jax_package(form):
    """Both forms of ``funcs``, a sequence of basis functions and one
    function giving the design matrix, with the Tikhonov stacking (3 rows
    of √λ·I on 50 points), against the JAX package's fit on the same
    data."""
    x, y, want = _jfit_lin()
    basis = _basis(torch)
    funcs = basis if form == "sequence" else \
        (lambda t: torch.stack([b(t) for b in basis], -1))
    got = opt.fit_lin(x, y, funcs, regularization=1e-3, device=CPU)
    assert got.shape == (3,) and got.dtype == torch.float64
    _close(got, want, 1e-10)


# ------------------------------------------------------------ num_grad

def _cubic(xp):
    return lambda x: xp.sum(x ** 3) + xp.prod(x)


def _fd_tol(kind, f, x, dtype):
    """The packages round f differently, by a few eps·|f|, and a
    difference quotient amplifies that by about 1/h, h its step: 16·eps·
    max(1, |f(x)|)/h, relative to max(1, |∇f|)."""
    eps = float(np.finfo(dtype).eps)
    h = eps ** (1 / 3) if kind == "num_grad" else math.sqrt(eps)
    return 16 * eps * max(1.0, abs(float(f(x)))) / h


@pytest.mark.parametrize("fn", ["cubic", "rosen"])
@pytest.mark.parametrize("kind", ["num_grad", "num_grad_forward"])
def test_num_grad_matches_the_jax_package(fn, kind):
    make = {"cubic": _cubic, "rosen": rosen}[fn]
    x = np.linspace(0.3, 2.1, 5)
    for dtype in (np.float64, np.float32)[:2 if fn == "rosen" else 1]:
        xd = x.astype(dtype)
        want = jax.jit(getattr(jopt, kind)(make(jnp)))(jnp.asarray(xd))
        got = getattr(opt, kind)(make(torch))(torch.from_numpy(xd))
        assert got.dtype == torch.from_numpy(xd).dtype
        _close(got, want, _fd_tol(kind, make(np), xd, dtype))
    # an integer input promotes to float64
    gi = getattr(opt, kind)(make(torch))(torch.tensor([1, 2, 3]))
    assert gi.dtype == torch.float64


# -------------------------------------------------------- 1-D solvers

def test_min1d_gss_matches_the_jax_package():
    f = lambda x: (x - 1.234) ** 2 + 0.5           # noqa: E731
    want = float(jax.jit(lambda a, b: jopt.min1d_gss(f, a, b))(-10.0, 10.0))
    got = opt.min1d_gss(f, -10.0, 10.0, device=CPU)
    assert got.dtype == torch.float64
    assert abs(float(got) - 1.234) < 1e-7 and abs(want - 1.234) < 1e-7
    assert abs(float(got) - want) < 1e-7


@pytest.mark.parametrize("finder", ["root1d_bisect", "root1d_brent",
                                    "root1d_illinois"])
def test_root1d_matches_the_jax_package(finder):
    """A linear f, whose sign is exact, brings bisection to the same
    float; the cubic of tests/test_opt_basic.py:13 to within 4 ulps."""
    for f, a, b in ((lambda x: x - 0.7321, 0.0, 2.0),
                    (lambda x: x ** 3 - 2 * x - 5, 2.0, 3.0)):
        want = float(jax.jit(lambda u, v: getattr(jopt, finder)(f, u, v))(
            a, b))
        got = getattr(opt, finder)(f, a, b, device=CPU)
        assert got.dtype == torch.float64
        if finder == "root1d_bisect" and a == 0.0:
            assert float(got) == want
        assert abs(float(got) - want) <= 4 * np.spacing(abs(want))
        assert abs(float(f(got))) < 1e-10
    with pytest.raises(ValueError):
        getattr(opt, finder)(lambda x: x ** 3 - 2 * x - 5, 3.0, 4.0,
                             device=CPU)


# --------------------------------------------------------- Nelder-Mead

def test_nelder_mead_first_50_iterates_match():
    """Beale from (1, 1) with scale 0.5 (tests/test_opt_misc.py:26)."""
    jgen = jopt.min_nelder_mead_gen(jopt.test_fn.beale,
                                    jnp.asarray([1.0, 1.0]), scale=0.5)
    pgen = opt.min_nelder_mead_gen(opt.test_fn.beale, np.array([1.0, 1.0]),
                                   scale=0.5, device=CPU)
    for _, (jx, jf), (px, pf) in zip(range(50), jgen, pgen):
        _close(px, jx, 1e-12)
        _close(pf, jf, 1e-12)


def test_min_nelder_mead_matches_the_jax_package():
    """The helical valley from its classic start (−1, 0, 0), the JAX
    package's driver jitted: the same count, x within 1e-10; the port
    reads the driver's flag and the shrink's branch, two a step."""
    x0 = np.array([-1.0, 0.0, 0.0])
    jx, jf, jit_ = jax.jit(lambda z: jopt.min_nelder_mead(
        jopt.test_fn.helical_valley, z, max_iter=400))(jnp.asarray(x0))
    before = host.reads
    x, fv, it = opt.min_nelder_mead(opt.test_fn.helical_valley, x0,
                                    max_iter=400, device=CPU)
    assert int(it) == int(jit_)
    _close(x, jx, 1e-10)
    assert host.reads - before == 2 * int(it) + 1


# ------------------------------------------------------------ test_fn

@functools.lru_cache(maxsize=None)
def _jfn(name):
    """f, ∇f and the Hessian of the JAX package's function, one jit."""
    fn = getattr(jopt.test_fn, name)
    return jax.jit(lambda x: (fn(x), fn.grad(x), fn.hess(x)))


@pytest.mark.parametrize("name", [f.name for f in jopt.test_fn.TEST_FNS])
def test_test_fn_values_gradients_and_hessians_match(name):
    """At a seeded point and at the listed minimum, each within 1e-12 of
    its rounding scale: max(1, |f|, |∇f|·|x|) for f, max(1, |∇f|,
    |H|·|x|) for ∇f (near a minimum the gradient cancels terms of that
    size) and max(1, |H|) for H."""
    jfn = getattr(jopt.test_fn, name)
    pfn = getattr(opt.test_fn, name)
    assert (pfn.minima, pfn.ndim, pfn.name) == (jfn.minima, jfn.ndim,
                                                jfn.name)
    rng = np.random.default_rng(len(name))
    for x in (rng.uniform(0.1, 1.0, jfn.ndim or 2),
              np.asarray(jfn.minima[0])):
        f, g, h = (np.asarray(v) for v in _jfn(name)(jnp.asarray(x)))
        ax, ag, ah = (np.abs(v).max() for v in (x, g, h))
        xt = torch.from_numpy(x)
        for got, want, scale in ((pfn(xt), f, max(abs(f), ag * ax)),
                                 (pfn.grad(xt), g, max(ag, ah * ax)),
                                 (pfn.hess(xt), h, ah)):
            _close(got, want, 1e-12 * max(1.0, scale))
    assert opt.test_fn.TestFn.__test__ is False

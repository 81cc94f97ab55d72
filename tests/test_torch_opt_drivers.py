"""The port's ``opt`` drivers and generators held against the JAX package
on the CPU by contract, on the same numpy inputs from fixed seeds: whole
runs diverge by rounding over hundreds of iterations, so they are held to
convergence, monotone loss and the no-progress error (single steps from a
shared state, the binding checks, are in ``test_torch_opt.py``); and
config 5 (``bench.py:461-516``) through bench.py's gate in float32 in both
packages: max|p − p_true| < 0.05 and f < 1e-4.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu import opt as jopt

from nd4js_tpu_torch import opt
from nd4js_tpu_torch.core import host

from tests.test_torch_opt import (_both_exp_fJ, _exp_data, _np, _odr_data,
                                  assert_trees_close, poly4, rosen, rosen_fg)

CPU = "cpu"


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solvers are loops of tiny torch ops; under pytest-xdist several
    workers share the cores, and a multi-threaded intra-op pool for each
    tiny op makes them slower. One thread per worker; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_lbfgs_minimize_by_contract():
    x, f, g, it = opt.lbfgs_minimize(rosen(torch), [-1.2, 1.0], device=CPU,
                                     max_iter=200)
    jx, jf, _, jit_ = jopt.lbfgs_minimize(jax.value_and_grad(rosen(jnp)),
                                          jnp.asarray([-1.2, 1.0]),
                                          max_iter=200)
    assert np.abs(_np(x) - 1.0).max() < 1e-6
    assert np.abs(np.asarray(jx) - 1.0).max() < 1e-6
    assert float(f) < 1e-12 and float(g.abs().max()) <= 1e-8
    assert abs(int(it) - int(jit_)) <= 10


def test_lbfgs_accepts_fg_and_f_and_counts_one_read_an_iteration():
    """fg (value and hand-written gradient) and f alone (the gradient by
    torch.func) give the same run; the driver reads once an iteration, the
    line search once a trial and once to stop."""
    runs = []
    for fn in (rosen_fg(torch), rosen(torch)):
        before = host.reads
        x, f, g, it = opt.lbfgs_minimize(fn, [-1.2, 1.0, 0.7], device=CPU,
                                         max_iter=60)
        runs.append((x, f, int(it), host.reads - before))
    assert_trees_close(runs[0][:2], [np.asarray(v) for v in runs[1][:2]],
                       rtol=1e-12)
    it, reads = runs[0][2], runs[0][3]
    assert it == runs[1][2] and reads == runs[1][3] >= 1 + 3 * it


def _closure_data():
    rng = np.random.default_rng(20261018)
    return rng.standard_normal((20, 5)), rng.standard_normal(20)


@pytest.mark.parametrize("driver", ["lbfgs_minimize", "min_lbfgs_gen",
                                    "min_dogleg"])
def test_f_closing_over_a_tensor_is_taken_as_f(driver):
    """An f that closes over tensors of data and reads a value from one
    (0.5·‖A·z − b‖²·s) is taken as f, not as fg, and the drivers reach the
    least-squares solution, as the JAX package's do."""
    a, b = _closure_data()
    at, bt = torch.from_numpy(a), torch.from_numpy(b)
    scale = torch.tensor(1.0, dtype=torch.float64)

    def f(z):
        r = at @ z - bt
        return 0.5 * float(scale) * (r * r).sum()

    def jf(z):
        r = jnp.asarray(a) @ z - jnp.asarray(b)
        return 0.5 * (r * r).sum()

    want = np.linalg.lstsq(a, b, rcond=None)[0]
    z0 = np.zeros(5)
    if driver == "min_lbfgs_gen":
        gen = opt.min_lbfgs_gen(f, z0, device=CPU)
        x = [next(gen) for _ in range(40)][-1][0]
        jgen = jopt.min_lbfgs_gen(jax.value_and_grad(jf), jnp.asarray(z0))
        jx = [next(jgen) for _ in range(40)][-1][0]
    else:
        x = getattr(opt, driver)(f, z0, device=CPU, max_iter=200)[0]
        jx = getattr(jopt, driver)(jax.value_and_grad(jf), jnp.asarray(z0),
                                   max_iter=200)[0]
    assert np.abs(_np(x) - want).max() < 1e-6
    assert np.abs(np.asarray(jx) - want).max() < 1e-6


def test_lbfgs_generators():
    gen = opt.min_lbfgs_gen(rosen(torch), [-1.2, 1.0], device=CPU)
    fs = [float(next(gen)[1]) for _ in range(40)]
    assert fs[-1] < fs[0] and all(b <= a for a, b in zip(fs, fs[1:]))
    xs, ys = _exp_data()

    def model(p, x):
        return p[0] * torch.exp(p[1] * x) + p[2]

    gen = opt.fit_lbfgs_gen(xs, ys, model, [1.0, 0.0, 0.0], device=CPU)
    mse = [float(next(gen)[1]) for _ in range(25)]
    assert mse[-1] < 0.1 * mse[0]
    _, pfJ = _both_exp_fJ()
    gen = opt.lsq_lbfgs_gen(pfJ, [1.0, 0.0, 0.0], device=CPU)
    assert float([next(gen) for _ in range(25)][-1][1]) < 0.1 * mse[0]


def test_lsq_lm_and_dogleg_by_contract():
    jfJ, pfJ = _both_exp_fJ()
    for pdrive, jdrive in ((opt.lsq_lm, jopt.lsq_lm),
                           (opt.lsq_dogleg, jopt.lsq_dogleg)):
        x, mse, g, it = pdrive(pfJ, [1.0, 0.0, 0.0], device=CPU,
                               max_iter=100)
        jx, jmse, _, _ = jdrive(jfJ, jnp.asarray([1.0, 0.0, 0.0]),
                                max_iter=100)
        assert np.abs(_np(x) - np.asarray(jx)).max() < 1e-6
        assert abs(float(mse) - float(jmse)) <= 1e-8 * float(jmse)


def test_fit_lm_and_the_lm_generators_by_contract():
    xs, ys = _exp_data()

    def model(p, x):
        return p[0] * torch.exp(p[1] * x) + p[2]

    p, mse, g, it = opt.fit_lm(xs, ys, model, [1.0, 0.0, 0.0], device=CPU)
    jp, jmse, _, _ = jopt.fit_lm(jnp.asarray(xs), jnp.asarray(ys),
                                 lambda p, x: p[0] * jnp.exp(p[1] * x) + p[2],
                                 jnp.asarray([1.0, 0.0, 0.0]))
    assert np.abs(_np(p) - np.asarray(jp)).max() < 1e-6
    for gen in (opt.fit_lm_gen(xs, ys, model, [1.0, 0.0, 0.0], device=CPU),
                opt.fit_dogleg_gen(xs, ys, model, [1.0, 0.0, 0.0],
                                   device=CPU)):
        prev = math.inf
        try:
            for i, (p, mse, g) in enumerate(gen):
                assert float(mse) <= prev + 1e-12
                prev = float(mse)
                if i > 40:
                    break
        except opt.OptimizationNoProgressError:
            pass       # the noise floor, as in the JAX package
        assert np.abs(_np(p) - np.asarray(jp)).max() < 1e-4


def test_lm_rank_deficient_jacobian():
    """A dead column: the URV branch keeps the unused parameter at 0."""
    def fJ(x):
        F = torch.stack([x[0] - 1, x[1] - 2, x[0] + x[1] - 3])
        J = torch.tensor([[1.0, 0, 0], [0, 1, 0], [1, 1, 0]],
                         dtype=x.dtype)
        return F, J
    x, mse, g, it = opt.lsq_lm(fJ, np.zeros(3), max_iter=60, device=CPU)
    assert float(mse) < 1e-12 and abs(float(x[2])) < 1e-6


def test_min_dogleg_by_contract():
    x, f, g, it = opt.min_dogleg(rosen(torch), [-1.2, 1.0], max_iter=600,
                                 device=CPU)
    assert np.abs(_np(x) - 1.0).max() < 1e-4
    gen = opt.min_dogleg_gen(rosen(torch), [-1.2, 1.0], device=CPU)
    fs = [float(next(gen)[1]) for _ in range(30)]
    assert all(b <= a for a, b in zip(fs, fs[1:])) and fs[-1] < fs[0]


def test_the_generators_raise_no_progress_and_the_drivers_stop():
    """A loss that no step lowers: every step is rejected. The generators
    raise OptimizationNoProgressError after stuckLimit + 1 rejections, as
    the JAX package's; the drivers stop at the same count."""
    def fJ(x):
        return torch.ones(1, dtype=x.dtype) + 0 * x[:1], \
            torch.ones((1, 1), dtype=x.dtype)

    def jfJ(x):
        return jnp.ones(1) + 0 * x[:1], jnp.ones((1, 1))

    for pgen, jgen, pdrive, jdrive in (
            (opt.lsq_lm_gen, jopt.lsq_lm_gen, opt.lsq_lm, jopt.lsq_lm),
            (opt.lsq_dogleg_gen, jopt.lsq_dogleg_gen, opt.lsq_dogleg,
             jopt.lsq_dogleg)):
        counts = []
        for gen in (pgen(fJ, [0.0], device=CPU, stuckLimit=4),
                    jgen(jfJ, jnp.asarray([0.0]), stuckLimit=4)):
            n = 0
            with pytest.raises((opt.OptimizationNoProgressError,
                                jopt.OptimizationNoProgressError)):
                for _ in gen:
                    n += 1
            counts.append(n)
        assert counts[0] == counts[1] == 5
        it = pdrive(fJ, [0.0], device=CPU, stuckLimit=4)[3]
        assert int(it) == int(jdrive(jfJ, jnp.asarray([0.0]),
                                     stuckLimit=4)[3]) == 5


@pytest.mark.parametrize("method", ["schur", "dense"])
def test_odr_lm_by_contract(method):
    """Both mechanisms against the JAX package's ODR on noisy data."""
    x, y, p_true = _odr_data(m=25, seed=7)
    (p, dx), mse, g, it = opt.odr_lm(x, y, poly4, np.zeros(4),
                                     method=method, max_iter=60, device=CPU)
    (jp, jdx), jmse, _, _ = jopt.odr_lm(jnp.asarray(x), jnp.asarray(y),
                                        poly4, jnp.zeros(4), method=method,
                                        max_iter=60)
    assert tuple(dx.shape) == x.shape
    assert np.abs(_np(p) - np.asarray(jp)).max() < 1e-6
    assert np.abs(_np(dx) - np.asarray(jdx)).max() < 1e-6
    assert abs(float(mse) - float(jmse)) <= 1e-6 * float(jmse)
    assert np.abs(_np(p) - p_true).max() < 0.05


def test_odr_generators_and_dogleg_and_multidim_x():
    p_true = np.array([0.7, 1.2])
    xs = np.linspace(0, 1, 15)

    def model(p, x):
        return p[0] * x ** 2 + p[1] * x

    ys = model(p_true, xs)
    for gen in (opt.odr_dogleg_gen(xs, ys, model, [0.0, 0.0], device=CPU),
                opt.odr_lm_gen(xs, ys, model, [0.0, 0.0], device=CPU),
                opt.tls_lm_gen(xs, ys, model, [0.0, 0.0], method="dense",
                               device=CPU)):
        try:
            for i, ((p, dx), mse, g) in enumerate(gen):
                if float(mse) < 1e-16 or i > 100:
                    break
        except opt.OptimizationNoProgressError:
            pass
        assert np.abs(_np(p) - p_true).max() < 1e-4
    (p, dx), mse, g, it = opt.odr_dogleg(xs, ys, model, [0.0, 0.0],
                                         device=CPU)
    assert np.abs(_np(p) - p_true).max() < 1e-4
    X = np.random.default_rng(8).uniform(-1, 1, (25, 2))

    def lin(p, x):
        return p[0] * x[..., 0] + p[1] * x[..., 1] + p[2]

    (p, dx), mse, g, it = opt.odr_lm(X, lin(np.array([1.0, -2.0, 0.5]), X),
                                     lin, np.zeros(3), max_iter=80,
                                     device=CPU)
    assert np.abs(_np(p) - [1.0, -2.0, 0.5]).max() < 1e-5
    assert tuple(dx.shape) == (25, 2)


# ---------------------------------------------------------------- config 5

def test_config5_through_the_bench_gate_in_float32_in_both_packages():
    """bench.py's config 5 at full size in float32: the 4096-point poly-4
    ODR fit, 40 LM iterations, and the 128-d Rosenbrock by L-BFGS (800
    iterations at most); inputs from numpy at bench.py's shapes and
    scales. The JAX package runs it with x64 off, as on the TPU (its
    structured solve adds a float64 identity to S under x64)."""
    rng = np.random.default_rng(9)
    p_true = np.array([0.5, -1.0, 0.25, 2.0], np.float32)
    x = rng.uniform(-2.0, 2.0, 4096).astype(np.float32)
    y = (poly4(p_true, x) + 0.01 * rng.standard_normal(4096)) \
        .astype(np.float32)
    p0, z0 = np.zeros(4, np.float32), -np.ones(128, np.float32)
    before = host.reads
    (p, dx), mse, g, it = opt.odr_lm(x, y, poly4, p0, max_iter=40,
                                     device=CPU)
    odr_reads = host.reads - before
    z, fz, gz, itz = opt.lbfgs_minimize(rosen(torch), z0, max_iter=800,
                                        device=CPU)
    assert p.dtype == z.dtype == torch.float32
    assert int(it) == 40 and odr_reads < 40 * 36
    assert np.abs(_np(p) - p_true).max() < 0.05 and float(fz) < 1e-4
    with jax.enable_x64(False):
        (jp, _), jmse, _, _ = jax.jit(lambda x, y: jopt.odr_lm(
            x, y, poly4, jnp.asarray(p0), max_iter=40))(x, y)
        _, jfz, _, _ = jax.jit(lambda z: jopt.lbfgs_minimize(
            jax.value_and_grad(rosen(jnp)), z, max_iter=800))(
                jnp.asarray(z0))
        assert np.abs(np.asarray(jp) - p_true).max() < 0.05
        assert float(jfz) < 1e-4
    # the same fit: p within the float32 rounding of 40 normal-equation
    # iterations
    assert np.abs(_np(p) - np.asarray(jp)).max() < 1e-3

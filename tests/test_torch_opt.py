"""The port's ``opt`` package held against the JAX package on the CPU, on
the same numpy inputs from fixed seeds.

Single steps are the binding checks: a solver state of the JAX package,
a few iterations in, is carried into the port by the ``convert``
functions, and one step of each package from it (L-BFGS, LM, dogleg on
each of its three legs, ``min_dogleg``, the structured ODR step, the
regularised TLS step, the URV Newton branch) must agree field by field
within 1e-10 relative in float64. Each line-search variant from one start
must give the same x, f, g, α and status. The drivers, the ``*_gen``
forms and config 5 are in ``test_torch_opt_drivers.py``.
"""
import functools
import importlib
import math
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu import opt as jopt

from nd4js_tpu_torch import convert, opt
from nd4js_tpu_torch.core import host

jlbfgs = importlib.import_module("nd4js_tpu.opt.lbfgs")
jlm = importlib.import_module("nd4js_tpu.opt.lm")
jdogleg = importlib.import_module("nd4js_tpu.opt.dogleg")
jodr = importlib.import_module("nd4js_tpu.opt.odr")
jtr = importlib.import_module("nd4js_tpu.opt._trust_region")
jtls = importlib.import_module("nd4js_tpu.opt._trust_region_tls")
jengine = importlib.import_module("nd4js_tpu.opt.line_search._engine")
plbfgs = importlib.import_module("nd4js_tpu_torch.opt.lbfgs")
plm = importlib.import_module("nd4js_tpu_torch.opt.lm")
pdogleg = importlib.import_module("nd4js_tpu_torch.opt.dogleg")
podr = importlib.import_module("nd4js_tpu_torch.opt.odr")
ptr = importlib.import_module("nd4js_tpu_torch.opt._trust_region")
ptls = importlib.import_module("nd4js_tpu_torch.opt._trust_region_tls")
pengine = importlib.import_module("nd4js_tpu_torch.opt.line_search._engine")

CPU = "cpu"
STEP_RTOL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The solvers are loops of tiny torch ops; under pytest-xdist several
    workers share the cores, and a multi-threaded intra-op pool for each
    tiny op makes them slower. One thread per worker; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def assert_trees_close(got, want, rtol=STEP_RTOL):
    """Every leaf within rtol of the largest |value| of its JAX
    counterpart (exactly equal for integer leaves)."""
    got, want = _leaves(got), _leaves(want)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), np.asarray(w)
        assert g.shape == w.shape, (i, g.shape, w.shape)
        if w.dtype.kind in "iub":
            assert np.array_equal(g, w), (i, g, w)
        else:
            scale = max(np.abs(w).max(initial=0.0), 1e-300)
            err = np.abs(g - w).max(initial=0.0)
            assert err <= rtol * scale, (i, err, scale)


def _to_np(tree):
    return jax.tree.map(np.asarray, tree)


# ----------------------------------------------------------- test problems

def rosen(xp):
    def f(z):
        return xp.sum(100.0 * (z[1:] - z[:-1] ** 2) ** 2 + (1.0 - z[:-1]) ** 2)
    return f


def rosen_fg(xp):
    """Rosenbrock with its hand-written gradient."""
    def fg(z):
        d = z[1:] - z[:-1] ** 2
        f = xp.sum(100.0 * d ** 2 + (1.0 - z[:-1]) ** 2)
        g = xp.concatenate([-400.0 * z[:-1] * d - 2.0 * (1.0 - z[:-1]),
                            xp.zeros_like(z[:1])]) \
            + xp.concatenate([xp.zeros_like(z[:1]), 200.0 * d])
        return f, g
    return fg


def exp_fit(xp, xs, ys):
    """Residuals p0·exp(p1·x) + p2 − y and their Jacobian."""
    def fJ(p):
        e = xp.exp(p[1] * xs)
        F = p[0] * e + p[2] - ys
        J = xp.stack([e, p[0] * xs * e, xp.ones_like(xs)], 1)
        return F, J
    return fJ


def _exp_data(n=30, seed=3):
    rng = np.random.default_rng(seed)
    xs = np.linspace(0.0, 2.0, n)
    ys = 1.7 * np.exp(-0.9 * xs) + 0.3 + 0.01 * rng.standard_normal(n)
    return xs, ys


@functools.lru_cache(maxsize=None)
def _both_exp_fJ():
    xs, ys = _exp_data()
    return (exp_fit(jnp, jnp.asarray(xs), jnp.asarray(ys)),
            exp_fit(torch, torch.from_numpy(xs), torch.from_numpy(ys)))


def poly4(p, x):
    return p[0] + x * (p[1] + x * (p[2] + x * p[3]))


def _odr_data(m=40, seed=5, dtype=np.float64):
    rng = np.random.default_rng(seed)
    p_true = np.array([0.5, -1.0, 0.25, 2.0])
    x = rng.uniform(-2, 2, m)
    y = poly4(p_true, x) + 0.01 * rng.standard_normal(m)
    return x.astype(dtype), y.astype(dtype), p_true


# ---------------------------------------------------------- polyquad

def test_roots1d_polyquad_matches_the_jax_package():
    c = np.array([[2.0, -3.0, 1.0], [1.0, 2.0, 1.0], [1.0, 0.0, 1.0],
                  [-4.0, 0.0, 1.0], [3.0, 2.0, 0.0], [3.0, 0.0, 0.0],
                  [1e-8, 1.0, 1e8], [0.0, 0.0, 2.0]]).T
    want = jopt.roots1d_polyquad(*(jnp.asarray(v) for v in c))
    got = opt.roots1d_polyquad(*c, device=CPU)
    for g, w in zip(got, want):
        assert np.allclose(_np(g), np.asarray(w), rtol=1e-14,
                           equal_nan=True)


# ---------------------------------------------------------- line searches

LS_START = np.array([-1.2, 1.0, 0.5, -0.3])


def _ls_inputs(direction="gradient"):
    f0, g0 = rosen_fg(np)(LS_START)
    neg_dir = g0 / np.abs(g0).max() if direction == "gradient" else -g0
    return f0, g0, neg_dir


LS_VARIANTS = {
    "abc": dict(fRed=1e-2, gRed=0.9, growMin=math.pi / 3,
                growMax=math.e - 1.5, shrinkLeast=0.1),
    "u123": dict(fRed=1e-2, gRed=0.9, growMin=math.pi / 3,
                 growMax=math.e - 1.5, shrinkLeast=0.1),
    "af": dict(fRed=0.1, gRed=0.9, growMin=math.pi / 3,
               growMax=math.pi / 3, shrinkLeast=0.2),
}


@pytest.mark.parametrize("alpha0", [None, 3.0, 1e-3])
@pytest.mark.parametrize("variant", sorted(LS_VARIANTS))
def test_line_search_engine_matches_the_jax_package(variant, alpha0):
    """From one start: x, f, g, α, the status and the evaluations equal
    (α0 = 3 forces the zoom, α0 = 1e-3 several bracketing steps)."""
    f0, g0, neg_dir = _ls_inputs()
    kw = dict(LS_VARIANTS[variant], variant=variant, alpha0=alpha0,
              max_iter=40)
    want = jengine.line_search_engine(
        rosen_fg(jnp), jnp.asarray(LS_START), jnp.asarray(f0),
        jnp.asarray(g0), jnp.asarray(neg_dir), **kw)
    got = pengine.line_search_engine(
        rosen_fg(torch), torch.from_numpy(LS_START), torch.tensor(f0),
        torch.from_numpy(g0), torch.from_numpy(neg_dir), **kw)
    assert int(got[4]) == int(want[4])
    assert_trees_close(got, want)


def test_line_search_bound_and_max_iter_statuses_match():
    """u123 against a small αMax (bound reached) and abc cut at two trials
    (max_iter), in both packages."""
    f0, g0, neg_dir = _ls_inputs()
    args = (LS_START, f0, g0, neg_dir)
    for variant, extra in (("u123", dict(alpha_max=1e-3)),
                           ("abc", dict(max_iter=2, alpha0=1e-4))):
        kw = dict(LS_VARIANTS[variant], variant=variant) | extra
        want = jengine.line_search_engine(
            rosen_fg(jnp), *(jnp.asarray(a) for a in args), **kw)
        got = pengine.line_search_engine(
            rosen_fg(torch), *(torch.tensor(a) for a in args), **kw)
        assert int(got[4]) == int(want[4]) != jengine.OK
        assert_trees_close(got, want)


@pytest.mark.parametrize("name", ["more_thuente_abc", "more_thuente_u123",
                                  "albaali_fletcher", "strong_wolfe"])
def test_line_search_factories_match_and_raise_alike(name):
    f0, g0, neg_dir = _ls_inputs()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jsearch = getattr(jopt.line_search, name)()(rosen_fg(jnp))
        psearch = getattr(opt.line_search, name)()(rosen_fg(torch))
    want = jsearch(jnp.asarray(LS_START), jnp.asarray(f0), jnp.asarray(g0),
                   jnp.asarray(neg_dir))
    got = psearch(LS_START, f0, g0, neg_dir, device=CPU)
    assert_trees_close(got, want)
    # an ascent direction: no progress, the same error class in both
    with pytest.raises(jopt.line_search.LineSearchNoProgressError):
        jsearch(jnp.asarray(LS_START), jnp.asarray(f0), jnp.asarray(g0),
                -jnp.asarray(neg_dir))
    with pytest.raises(opt.line_search.LineSearchNoProgressError) as err:
        psearch(LS_START, f0, g0, -neg_dir, device=CPU)
    assert np.array_equal(_np(err.value.x), LS_START)


def test_line_search_factories_check_their_options():
    for bad in ({"fRed": 0.95}, {"growMin": 0.9}, {"shrinkLeast": 0.7},
                {"growMin": 2.0, "growMax": 1.5}):
        with pytest.raises(ValueError):
            opt.more_thuente_abc(bad)
    with pytest.warns(UserWarning):
        opt.more_thuente_abc({"bogus": 1})
    with pytest.warns(DeprecationWarning):
        opt.strong_wolfe()
    search = opt.albaali_fletcher()(rosen_fg(torch))
    with pytest.raises(ValueError):
        search(LS_START, *_ls_inputs(), alpha_min=0.1, device=CPU)


# ------------------------------------------------------------ single steps

@functools.lru_cache(maxsize=None)
def _jlbfgs_step():
    """One compiled L-BFGS step of the JAX package (buffer of 8) on the
    6-d Rosenbrock, shared by the tests."""
    fg = jax.value_and_grad(rosen(jnp))
    return fg, jax.jit(functools.partial(jlbfgs._lbfgs_step, fg, m=8))


def _jax_lbfgs_state(n_steps):
    fg, step = _jlbfgs_step()
    x0 = jnp.asarray(np.linspace(-1.2, 0.8, 6))
    f0, g0 = fg(x0)
    st = jlbfgs._MinState(x=x0, f=f0, g=g0,
                          mem=jlbfgs.lbfgs_init(8, 6, x0.dtype),
                          it=jnp.zeros((), jnp.int32),
                          fails=jnp.zeros((), jnp.int32))
    for _ in range(n_steps):
        st = step(st)
    return fg, step, st


@pytest.mark.parametrize("n_steps", [0, 5, 11])
def test_lbfgs_step_from_a_shared_state(n_steps):
    """An empty buffer, a partly filled one and a full one that wrapped
    (11 pairs in a ring of 8)."""
    _, step, st = _jax_lbfgs_state(n_steps)
    assert int(st.mem.count) == min(n_steps, 8)
    pst = convert.state_from_numpy(plbfgs._MinState, _to_np(st), CPU)
    got = plbfgs._lbfgs_step(plbfgs._grad_and_value(rosen(torch)), pst, 8)
    assert_trees_close(got, step(st))


@functools.lru_cache(maxsize=None)
def _jsteps():
    """The JAX package's LM and dogleg steps on the exponential fit,
    compiled once for the tests."""
    jfJ, _ = _both_exp_fJ()
    opts = dict(jlm._DEFAULTS)
    return (jax.jit(functools.partial(jlm._lm_step, jfJ, opts)),
            jax.jit(functools.partial(jdogleg._dogleg_step, jfJ, opts)))


def _jax_lm_state(n_steps):
    jfJ, pfJ = _both_exp_fJ()
    opts = dict(jlm._DEFAULTS)
    s = jlm._init(jfJ, jnp.asarray([1.0, 0.0, 0.0]), opts)
    for _ in range(n_steps):
        s = _jsteps()[0](s)
    return jfJ, pfJ, opts, s


@pytest.mark.parametrize("n_steps", [0, 3])
def test_lm_step_from_a_shared_state(n_steps):
    jfJ, pfJ, opts, s = _jax_lm_state(n_steps)
    ps = convert.state_from_numpy(plm._LMState, _to_np(s), CPU)
    got = plm._lm_step(pfJ, opts, ps)
    assert_trees_close(got, _jsteps()[0](s))


def _dogleg_radii(s):
    """Radii that put the dogleg step on each of its legs: beyond the
    Gauss-Newton step, inside the Cauchy point, and between."""
    st = s.st
    _, r_gn, _ = jax.jit(jtr.newton_step)(st)
    jg = st.j @ st.g
    t = (st.g @ st.g) / (jg @ jg)
    r_c = float(jnp.sqrt(jnp.sum((st.d * t * st.g) ** 2)))
    r_gn = float(r_gn)
    assert r_c < r_gn
    return {"newton": 2 * r_gn, "cauchy": 0.5 * r_c,
            "leg": 0.5 * (r_c + r_gn)}


@pytest.mark.parametrize("leg", ["newton", "cauchy", "leg"])
def test_dogleg_step_from_a_shared_state_on_each_leg(leg):
    jfJ, pfJ, opts, s = _jax_lm_state(1)
    s = s._replace(radius=jnp.asarray(_dogleg_radii(s)[leg]))
    ps = convert.state_from_numpy(plm._LMState, _to_np(s), CPU)
    before = host.reads
    got = pdogleg._dogleg_step(pfJ, opts, ps)
    # the rank branch and the leg: two reads
    assert host.reads - before == 2
    assert_trees_close(got, _jsteps()[1](s))


def test_min_dogleg_step_from_a_shared_state():
    fg = jax.value_and_grad(rosen(jnp))
    opts = dict(jlm._DEFAULTS)
    x0 = jnp.asarray(np.linspace(-1.2, 0.8, 5))
    f0, g0 = fg(x0)
    zero = jnp.zeros((), jnp.int32)
    s = jdogleg._MinDLState(x=x0, f=f0, g=g0,
                            mem=jlbfgs.lbfgs_init(8, 5, x0.dtype),
                            radius=jnp.asarray(1.0), it=zero, stuck=zero)
    step = jax.jit(functools.partial(jdogleg._min_dogleg_step, fg, opts))
    for _ in range(4):
        s = step(s)
    ps = convert.state_from_numpy(pdogleg._MinDLState, _to_np(s), CPU)
    got = pdogleg._min_dogleg_step(plbfgs._grad_and_value(rosen(torch)), opts, ps)
    assert_trees_close(got, step(s))


@functools.lru_cache(maxsize=None)
def _odr_problem():
    """Both packages' Jacobian blocks on one ODR problem, and the JAX
    package's step compiled once."""
    x, y, _ = _odr_data()
    x2, y2 = jnp.asarray(x)[:, None], jnp.asarray(y)[:, None]
    jev = jodr._odr_blocks(x2, y2, poly4, x.shape)
    pev = podr._odr_blocks(torch.from_numpy(x)[:, None],
                           torch.from_numpy(y)[:, None], poly4, x.shape)
    opts = dict(jodr._ODR_DEFAULTS)
    step = jax.jit(functools.partial(jodr._odr_lm_step, jev, opts))
    return jev, pev, opts, step, jnp.zeros_like(x2)


def _jax_odr_state(n_steps):
    jev, pev, opts, step, dx0 = _odr_problem()
    s = jodr._odr_init(jev, jnp.zeros(4), dx0, opts)
    for _ in range(n_steps):
        s = step(s)
    return jev, pev, opts, step, s


def test_odr_blocks_match_the_jax_package():
    """The residuals and Jacobian blocks from torch.func against
    jax.jacfwd and jax.jvp."""
    jev, pev, _, _, _ = _jax_odr_state(0)
    rng = np.random.default_rng(6)
    p, dx = rng.standard_normal(4), 0.1 * rng.standard_normal((40, 1))
    assert_trees_close(pev(torch.from_numpy(p), torch.from_numpy(dx)),
                       jev(jnp.asarray(p), jnp.asarray(dx)), rtol=1e-14)


@pytest.mark.parametrize("n_steps", [0, 2])
def test_structured_odr_step_from_a_shared_state(n_steps):
    jev, pev, opts, step, s = _jax_odr_state(n_steps)
    ps = convert.state_from_numpy(podr._OdrLMState, _to_np(s), CPU)
    assert_trees_close(podr._odr_lm_step(pev, opts, ps), step(s))


@pytest.mark.parametrize("lam", [0.0, 1e-3, 10.0])
def test_tls_regularized_step_from_a_shared_state(lam):
    """The Schur-eliminated solve, and Moré's φ' from its second solve."""
    _, _, _, _, s = _jax_odr_state(1)
    pst = convert.state_from_numpy(ptls.TlsState, _to_np(s.st), CPU)
    got = ptls.tls_regularized_step(pst, torch.tensor(lam,
                                                      dtype=torch.float64))
    assert_trees_close(got, jtls.tls_regularized_step(s.st,
                                                      jnp.asarray(lam)))


@pytest.mark.parametrize("m,n,r", [(8, 5, 3), (12, 6, 2), (5, 5, 4),
                                   (4, 7, 3)])
def test_newton_step_urv_branch_for_a_rank_deficient_jacobian(m, n, r):
    """The minimum-‖D·dx‖ Gauss-Newton step (the URV branch), its norm and
    φ'(0), from the same LsqState; m < n takes the branch without a read."""
    rng = np.random.default_rng(100 + m + n + r)
    j = rng.standard_normal((m, r)) @ rng.standard_normal((r, n))
    f = rng.standard_normal(m)
    st = jtr.lsq_state(jnp.zeros(n), jnp.asarray(f), jnp.asarray(j))
    want = jax.jit(jtr.newton_step)(st)
    pst = convert.state_from_numpy(ptr.LsqState, _to_np(st), CPU)
    before = host.reads
    got = ptr.newton_step(pst)
    assert_trees_close(got, want)
    # the branch read, and one read a strong-swap round of the URV's RRQR
    assert host.reads - before >= (1 if m >= n else 0) + 1
    # the residual of numpy's minimum-norm solution
    x_np = np.linalg.lstsq(j, -f, rcond=1e-10)[0]
    assert np.linalg.norm(j @ _np(got[0]) + f) <= \
        np.linalg.norm(j @ x_np + f) + 1e-8


def test_regularized_step_and_more_lambda_step_match():
    jfJ, _, _, s = _jax_lm_state(2)
    pst = convert.state_from_numpy(ptr.LsqState, _to_np(s.st), CPU)
    lam = 0.37
    assert_trees_close(
        ptr.regularized_step(pst, torch.tensor(lam, dtype=torch.float64)),
        jax.jit(jtr.regularized_step)(s.st, jnp.asarray(lam)))
    radius = 0.01
    assert_trees_close(
        ptr.more_lambda_step(pst, torch.tensor(radius, dtype=torch.float64)),
        jax.jit(jtr.more_lambda_step)(s.st, jnp.asarray(radius)))

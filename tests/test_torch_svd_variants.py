"""The port's other SVD methods held against the JAX package on the CPU:
divide and conquer (``svd_dc``), block Jacobi (``svd_jac_blocked``),
Kogbetliantz (``svd_jac_2sided``) and classic Jacobi
(``svd_jac_classic``), the U completion's ``force``, the wrappers and
``svd_decomp``'s routing to 'blocked' and 'dc'. Inputs come from numpy
with fixed seeds; each batch holds a random matrix and rank-deficient
ones.

σ is unique and is compared directly, in float64, within 1e-10·σ₀ of
each matrix. U and V are not unique (a σ ≈ 0 cluster, and the sign of a
pair of columns, which the Jacobi methods leave to rounding) and are held
to the contract of ``tests/test_svd.py``: orthonormal to
4·eps·max(M, N), and U·diag(σ)·V = A within 32·eps·max(M, N)·max|A|.
The wide case of each method is the transpose of its tall batch, whose σ
are the same. The float32 case holds the port in float32 to the JAX
package's float64 σ within 32·eps32·max(M, N)·σ₀ and to the contract in
eps32.

The loop rules: Kogbetliantz freezes each matrix once its sweep's off
measure is within tolerance, and the sweeps each matrix runs equal its
JAX lane's (found by capping the JAX lane's sweeps: a cap at or above its
count leaves its result unchanged, bit for bit). Classic Jacobi freezes
each matrix once its largest pair is within tolerance: its rotation
count is held equal to its JAX lane's on near-diagonal matrices that
converge after different numbers of rotations. On random matrices the
last rotations act on pairs at the rounding level, where XLA's and
PyTorch's arithmetic differ (counts within ±2 of JAX's at n = 12 in
float64, equal on 12 of 16 matrices), so there the rule is held by
running each matrix alone: it performs the same rotations as in its
batch. The JAX references run jitted, once per shape, cached per module
(about 2-5 s each to compile).
"""
import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla

from nd4js_tpu_torch import la

jsj = importlib.import_module("nd4js_tpu.la.svd_jac")
jbj = importlib.import_module("nd4js_tpu.la.svd_block_jac")
jkog = importlib.import_module("nd4js_tpu.la.svd_kogbetliantz")
jcl = importlib.import_module("nd4js_tpu.la.svd_classic")
psj = importlib.import_module("nd4js_tpu_torch.la.svd_jac")
pbj = importlib.import_module("nd4js_tpu_torch.la.svd_block_jac")
pkog = importlib.import_module("nd4js_tpu_torch.la.svd_kogbetliantz")
pcl = importlib.import_module("nd4js_tpu_torch.la.svd_classic")
pdc = importlib.import_module("nd4js_tpu_torch.la.svd_dc")

CPU = "cpu"
EPS64 = np.finfo(np.float64).eps
EPS32 = np.finfo(np.float32).eps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Loops of small torch ops; one intra-op thread per xdist worker."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.double().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rank_deficient(rng, shape, rank):
    return rng.standard_normal(shape[:-1] + (rank,)) \
        @ rng.standard_normal(shape[:-2] + (rank, shape[-1]))


def _input(shape, seed):
    """A tall batch of 3: random, rank 4, and zero below row 5."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape)
    a[1] = rank_deficient(rng, shape[1:], 4)
    a[2, 5:] = 0.0
    return a


METHODS = {
    "dc": (jla.svd_dc, la.svd_dc, (3, 14, 10)),
    "blocked": (lambda a: jla.svd_jac_blocked(a, block=4),
                lambda a, device=None: la.svd_jac_blocked(a, block=4,
                                                          device=device),
                (3, 20, 12)),
    "2sided": (jla.svd_jac_2sided, la.svd_jac_2sided, (3, 9, 6)),
    "classic": (jla.svd_jac_classic, la.svd_jac_classic, (3, 9, 6)),
}


@functools.lru_cache(maxsize=None)
def _jax_svd(name):
    jf, _, shape = METHODS[name]
    a = _input(shape, 30 + sorted(METHODS).index(name))
    return a, [np.asarray(x) for x in jax.jit(jf)(a)]


def sv_close(sv, sv_ref, rtol=1e-10):
    """Per matrix, max |σ − σ_ref| ≤ rtol·σ₀."""
    sv, sv_ref = _np(sv), _np(sv_ref)
    assert sv.shape == sv_ref.shape
    scale = sv_ref[..., :1]
    assert (np.abs(sv - sv_ref) <= rtol * scale).all()


def assert_contract(a, u, sv, v, eps=EPS64):
    u, sv, v = _np(u), _np(sv), _np(v)
    m, n = a.shape[-2:]
    k = min(m, n)
    assert u.shape == a.shape[:-2] + (m, k)
    assert v.shape == a.shape[:-2] + (k, n)
    assert (sv >= 0).all() and (np.diff(sv, axis=-1) <= 0).all()
    tol = 4 * eps * max(m, n)
    assert np.abs(np.swapaxes(u, -1, -2) @ u - np.eye(k)).max() <= tol
    assert np.abs(v @ np.swapaxes(v, -1, -2) - np.eye(k)).max() <= tol
    assert np.abs((u * sv[..., None, :]) @ v - a).max() \
        <= 32 * eps * max(m, n) * np.abs(a).max()


@pytest.mark.parametrize("name", sorted(METHODS))
def test_sigma_against_jax(name):
    a, (_, sv_ref, _) = _jax_svd(name)
    _, sv, _ = METHODS[name][1](a, device=CPU)
    sv_close(sv, sv_ref)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_contract(name):
    a, _ = _jax_svd(name)
    assert_contract(a, *METHODS[name][1](a, device=CPU))


@pytest.mark.parametrize("name", sorted(METHODS))
def test_wide_is_the_transpose(name):
    """M < N: the transposed batch, whose σ are the JAX package's of the
    tall one."""
    a, (_, sv_ref, _) = _jax_svd(name)
    at = np.swapaxes(a, -1, -2).copy()
    u, sv, v = METHODS[name][1](at, device=CPU)
    sv_close(sv, sv_ref)
    assert_contract(at, u, sv, v)


def test_float32():
    a, (_, sv_ref, _) = _jax_svd("dc")
    u, sv, v = la.svd_dc(torch.from_numpy(a).float())
    assert sv.dtype == torch.float32
    sv_close(sv, sv_ref, 32 * EPS32 * max(a.shape[-2:]))
    assert_contract(a, u, sv, v, EPS32)


def test_svd_dc_forces_the_completion_on_a_rank_deficient_input(
        monkeypatch):
    """The rank-4 matrix's σ ≈ 0 cluster and the zero rows leave
    unbalanced TGK halves, which force the completion of U or V; the
    random matrix's halves are balanced."""
    a, _ = _jax_svd("dc")
    forced = []
    inner = pdc._complete_u

    def recording(u, sv, tol, force=False):
        forced.append(_np(torch.as_tensor(force)).astype(bool).tolist())
        return inner(u, sv, tol, force=force)

    monkeypatch.setattr(pdc, "_complete_u", recording)
    la.svd_dc(a, device=CPU)
    assert len(forced) == 2
    assert not any(f[0] for f in forced)
    assert any(f[1] for f in forced) and any(f[2] for f in forced)


def test_svd_dc_float32_rank_deficient_stays_finite():
    """Float32 rank-36 matrices of 48²: the σ ≈ 0 cluster's TGK halves are
    balanced but near duplicates, and the JAX package's CholeskyQR polish
    breaks on them (NaN in U and V of matrices 0 and 4). The port also
    forces the completion where a factor is not orthonormal within √eps:
    U and V orthonormal to 4·eps32·N, and σ and the reconstruction no
    further from a float64 SVD and from A than the JAX package's are on
    the matrices where it is finite (this rank-deficient float32 input
    costs both about 1e-4 of max|A|)."""
    rng = np.random.default_rng(0)
    a = (rng.standard_normal((8, 48, 36)) @ rng.standard_normal((8, 36, 48))
         / 48).astype(np.float32)[:5]
    ju, js, jv = (np.asarray(x).astype(np.float64)
                  for x in jax.jit(jla.svd_dc)(a))
    finite = np.isfinite(ju).all((1, 2)) & np.isfinite(jv).all((1, 2))
    assert np.nonzero(~finite)[0].tolist() == [0, 4]
    a64 = a.astype(np.float64)
    sv64 = np.linalg.svd(a64, compute_uv=False)
    u, sv, v = (_np(x) for x in la.svd_dc(a, device=CPU))
    assert np.isfinite(u).all() and np.isfinite(v).all()
    tol = 4 * EPS32 * 48
    assert np.abs(np.swapaxes(u, -1, -2) @ u - np.eye(48)).max() <= tol
    assert np.abs(v @ np.swapaxes(v, -1, -2) - np.eye(48)).max() <= tol
    assert (np.diff(sv, axis=-1) <= 0).all() and (sv >= 0).all()
    jrec = np.abs((ju * js[..., None, :]) @ jv - a64)[finite].max()
    rec = np.abs((u * sv[..., None, :]) @ v - a64).max()
    assert rec <= jrec
    assert np.abs(sv - sv64).max() <= np.abs(js - sv64)[finite].max()


def test_complete_u_force_against_jax():
    """``force`` repairs a matrix whose σ pass the rank test, per matrix,
    as the JAX package's ``_complete_u`` under vmap does."""
    rng = np.random.default_rng(40)
    u = np.linalg.qr(rng.standard_normal((3, 8, 5)))[0]
    u[:, :, 3] = 0.0
    sv = np.ones((3, 5))
    force = np.array([True, False, True])
    want = jax.jit(jax.vmap(lambda u, s, f: jsj._complete_u(
        u, s, 1e-12, force=f)))(u, sv, force)
    got = psj._complete_u(torch.from_numpy(u), torch.from_numpy(sv), 1e-12,
                          force=torch.from_numpy(force))
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-10)
    np.testing.assert_array_equal(_np(got)[1], u[1])
    assert np.abs(np.swapaxes(_np(got)[0], -1, -2) @ _np(got)[0]
                  - np.eye(5)).max() <= 4 * EPS64 * 8


def test_complete_u_without_need_returns_its_input():
    u = torch.eye(4, dtype=torch.float64)[None, :, :3]
    assert psj._complete_u(u, torch.ones(1, 3, dtype=torch.float64),
                           1e-12) is u


# ---------------------------------------------------------------- blocked

@pytest.mark.parametrize("nb", [2, 4, 6, 8])
def test_round_robin_schedule(nb):
    assert pbj._round_robin_schedule(nb) == jbj._round_robin_schedule(nb)


def test_inner_rotation_sweep_against_jax():
    rng = np.random.default_rng(41)
    w = rng.standard_normal((2, 3, 12, 8))
    g = np.swapaxes(w, -1, -2) @ w
    want = jax.jit(lambda g: jbj._inner_rotation_sweep(g, 2))(g)
    got = pbj._inner_rotation_sweep(torch.from_numpy(g), 2)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=0,
                               atol=1e-10)


# ---------------------------------------------------------------- loops

def _loop_batch(n, scales, seed):
    """Near-diagonal n×n matrices, diag(1..n) plus a perturbation of each
    scale, then random ones for the scales that are None."""
    rng = np.random.default_rng(seed)
    out = []
    for s in scales:
        if s is None:
            out.append(rng.standard_normal((n, n)))
        else:
            out.append(np.diag(np.arange(1.0, n + 1))
                       + s * rng.standard_normal((n, n)))
    return np.stack(out)


def _lane_counts(run, a, cap, full):
    """Per lane, the least cap c ≤ ``cap`` whose result equals the
    uncapped one bit for bit: the iterations the lane performs."""
    ref = [np.asarray(x) for x in run(a, jnp.full(len(a), full))]
    lo = np.zeros(len(a), np.int64)
    hi = np.full(len(a), cap)
    while (hi - lo > 1).any():
        mid = (lo + hi) // 2
        got = [np.asarray(x) for x in run(a, jnp.asarray(mid))]
        same = np.array([all(np.array_equal(g[b], r[b])
                             for g, r in zip(got, ref))
                         for b in range(len(a))])
        hi = np.where(same, mid, hi)
        lo = np.where(same, lo, mid)
    return hi


@functools.lru_cache(maxsize=None)
def _kog_lanes():
    n = 6
    a = _loop_batch(n, [1e-3, 1e-6, None, None], 42)
    tol = EPS64 * n
    run = jax.jit(jax.vmap(lambda x, c: jkog._kog_core(x, c, tol)))
    full = [np.asarray(x) for x in run(a, jnp.full(len(a), 30))]
    return a, tol, full, _lane_counts(run, a, 30, 30)


def test_kogbetliantz_sweeps_per_matrix_equal_the_jax_lanes():
    a, tol, (s_ref, _, _), lanes = _kog_lanes()
    assert len(set(lanes.tolist())) >= 3, "the matrices converge apart"
    s, u, v, sweeps = pkog._kog_core(torch.from_numpy(a), 30, tol)
    assert sweeps.tolist() == lanes.tolist()
    np.testing.assert_allclose(_np(s), s_ref, rtol=0,
                               atol=1e-10 * np.abs(s_ref).max())
    rec = _np(u) @ _np(s) @ np.swapaxes(_np(v), -1, -2)
    assert np.abs(rec - a).max() <= 32 * EPS64 * 6 * np.abs(a).max()


def test_kogbetliantz_sweep_cap():
    a, tol, _, lanes = _kog_lanes()
    *_, sweeps = pkog._kog_core(torch.from_numpy(a), 2, tol)
    assert sweeps.tolist() == np.minimum(lanes, 2).tolist()


@functools.lru_cache(maxsize=None)
def _classic_lanes():
    n = 6
    a = _loop_batch(n, [1e-2, 1e-5, 1e-9, None], 43)
    tol = EPS64 * np.sqrt((a * a).sum((-2, -1)))
    cap = 60 * n * (n - 1) // 2
    run = jax.jit(jax.vmap(lambda x, c, t: jcl._classic_core(x, c, t)))
    full = [np.asarray(x) for x in run(a, jnp.full(len(a), cap), tol)]
    lanes = _lane_counts(lambda x, c: run(x, c, tol), a, cap, cap)
    return a, tol, cap, full, lanes


def test_classic_rotations_per_matrix_equal_the_jax_lanes():
    a, tol, cap, (s_ref, _, _), lanes = _classic_lanes()
    near = slice(0, 3)
    assert len(set(lanes[near].tolist())) == 3, "they converge apart"
    s, u, v, rot = pcl._classic_core(torch.from_numpy(a), cap,
                                     torch.from_numpy(tol))
    assert rot[near].tolist() == lanes[near].tolist()
    d, d_ref = np.diagonal(_np(s), 0, -2, -1), np.diagonal(s_ref, 0, -2, -1)
    np.testing.assert_allclose(np.sort(np.abs(d)), np.sort(np.abs(d_ref)),
                               rtol=0, atol=1e-10 * np.abs(d_ref).max())
    rec = _np(u) @ _np(s) @ np.swapaxes(_np(v), -1, -2)
    assert np.abs(rec - a).max() <= 32 * EPS64 * 6 * np.abs(a).max()


def test_classic_freezes_each_matrix_alone():
    """Each matrix run alone performs the rotations it performs in its
    batch, and ends in the same state, bit for bit."""
    a, tol, cap, _, _ = _classic_lanes()
    s, u, v, rot = pcl._classic_core(torch.from_numpy(a), cap,
                                     torch.from_numpy(tol))
    for b in range(len(a)):
        s1, u1, v1, r1 = pcl._classic_core(
            torch.from_numpy(a[b:b + 1]), cap, torch.from_numpy(tol[b:b + 1]))
        assert r1.tolist() == [rot[b].item()]
        for x, x1 in ((s, s1), (u, u1), (v, v1)):
            assert torch.equal(x[b], x1[0])


# ---------------------------------------------------------------- routing

def test_svd_decomp_routes_blocked_and_dc():
    a, _ = _jax_svd("blocked")
    t = torch.from_numpy(a)
    for x, y in zip(la.svd_decomp(t, method="blocked", block=4),
                    la.svd_jac_blocked(t, block=4)):
        assert torch.equal(x, y)
    for x, y in zip(la.svd_decomp(t, method="dc"), la.svd_dc(t)):
        assert torch.equal(x, y)
    with pytest.raises(ValueError):
        la.svd_decomp(t, method="nope")


def test_jacobi_wrappers_name_their_mechanisms():
    a, _ = _jax_svd("2sided")
    t = torch.from_numpy(a)
    pairs = ((la.svd_jac_classic(t), pcl.svd_jac_classic_greedy(t)),
             (la.svd_jac_2sided(t), pkog.svd_kogbetliantz(t)),
             (la.svd_jac_2sided_blocked(t, block=2),
              la.svd_jac_blocked(t, block=2)))
    for got, want in pairs:
        for x, y in zip(got, want):
            assert torch.equal(x, y)

"""The port's simultaneous-rotation SVD (``svd_gram``) held against the JAX
package on the CPU: the pair tangents, the finishing sweeps, and the whole
call with the 'qlp' and the 'spectral' preconditioner (the one 'auto'
takes from N = 128, forced here at small N because the JAX package's
divide-and-conquer compiles slowly) on a square, a tall and a
rank-deficient batch, the last firing the batch-wide U repair. Inputs come
from numpy with fixed seeds; float64.

σ is compared directly, within 32·eps·max(M, N)·σ₀. U and V are held to
the contract of ``tests/test_svd.py`` (orthogonality ≤ 4·eps·max(M, N),
reconstruction ≤ 32·eps·max(M, N)·max|A|), except where the JAX package
itself misses it on the same input: there the port may be no worse than
twice the JAX package's own defect. (On a rank-deficient input the
null-space columns of V and the reconstruction are left as the
preconditioner gave them: frozen pairs are never rotated again.)
"""
import functools
import importlib

import numpy as np
import pytest
import torch

from nd4js_tpu_torch import config

jsg = importlib.import_module("nd4js_tpu.la.svd_gram")
psg = importlib.import_module("nd4js_tpu_torch.la.svd_gram")

EPS64 = np.finfo(np.float64).eps

CASES = {"square": (2, 20, 20), "tall": (2, 25, 15),
         "rank_deficient": (2, 16, 16)}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _input(name):
    rng = np.random.default_rng(400 + sorted(CASES).index(name))
    shape = CASES[name]
    if name == "rank_deficient":       # rank 10 of 16
        return rng.standard_normal(shape[:-1] + (10,)) @ \
            rng.standard_normal(shape[:-2] + (10, shape[-1]))
    return rng.standard_normal(shape)


@functools.lru_cache(maxsize=None)
def _jax_gram(name, precond):
    a = _input(name)
    return a, [np.asarray(x) for x in jsg.svd_gram(a, precond=precond)]


def _defects(a, u, sv, v):
    k = sv.shape[-1]
    ut = np.swapaxes(u, -1, -2)
    return (np.abs(ut @ u - np.eye(k)).max(),
            np.abs(v @ np.swapaxes(v, -1, -2) - np.eye(k)).max(),
            np.abs((u * sv[..., None, :]) @ v - a).max())


@pytest.mark.parametrize("precond", ["qlp", "spectral"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_svd_gram_matches_jax(name, precond):
    a, (ju, jsv, jv) = _jax_gram(name, precond)
    m, n = a.shape[-2:]
    before = dict(psg.branches)
    u, sv, v = (x.numpy() for x in psg.svd_gram(_t(a), precond=precond))
    k = min(m, n)
    assert u.shape == (2, m, k) and sv.shape == (2, k) and v.shape == (2, k, n)
    assert (sv >= 0).all() and (np.diff(sv, axis=-1) <= 0).all()
    assert (np.abs(sv - jsv) <= 32 * EPS64 * max(m, n) * jsv[:, :1]).all()
    contract = (4 * EPS64 * max(m, n), 4 * EPS64 * max(m, n),
                32 * EPS64 * max(m, n) * np.abs(a).max())
    for got, ref, bound in zip(_defects(a, u, sv, v),
                               _defects(a, ju, jsv, jv), contract):
        assert got <= max(bound, 2 * ref), (got, ref, bound)
    repaired = psg.branches["repair"] - before["repair"]
    assert repaired == (1 if name == "rank_deficient" else 0)


def test_svd_gram_default_precond_below_128_is_qlp_and_debug_checks_pass():
    a, _ = _jax_gram("square", "qlp")
    got = psg.svd_gram(_t(a))
    want = psg.svd_gram(_t(a), precond="qlp")
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    saved = config.debug_checks
    config.debug_checks = True
    try:
        checked = psg.svd_gram(_t(a))
    finally:
        config.debug_checks = saved
    assert all(torch.equal(x, y) for x, y in zip(got, checked))
    with pytest.raises(ValueError):
        psg.svd_gram(_t(a), precond="nope")


def test_pair_tangents_match_jax():
    """t and the off measure entry by entry (each is one formula per
    pair); one pair of zero columns tests the rank-floor freeze."""
    rng = np.random.default_rng(410)
    w = rng.standard_normal((3, 9, 7))
    w[1, :, 5:] = 0.0
    g = np.swapaxes(w, -1, -2) @ w
    jt, joff = (np.asarray(x) for x in jsg._pair_tangents(g, EPS64))
    t, off = psg._pair_tangents(_t(g), EPS64)
    assert np.abs(t.numpy() - jt).max() <= 4 * EPS64 * np.abs(jt).max()
    assert torch.equal(t, -t.mT)
    assert np.abs(off.numpy() - joff).max() <= 4 * EPS64
    assert float(t[1, 5, 6]) == 0.0


@pytest.mark.parametrize("k", [6, 7])
def test_finishing_sweeps_match_jax(k):
    """The scalar fallback sweeps from a rotated start, even and odd K (the
    odd one pads an inert column): w, p within 64·eps·K·max|w|, and off."""
    rng = np.random.default_rng(420 + k)
    w = rng.standard_normal((2, k, k))
    p = np.broadcast_to(np.eye(k), (2, k, k)).copy()
    tol = EPS64 * k
    jw, jp, joff = (np.asarray(x) for x in
                    jsg._finishing_sweeps(w, p, 3, tol))
    pw, pp, poff = psg._finishing_sweeps(_t(w), _t(p), 3, tol)
    unit = 64 * EPS64 * k
    assert np.abs(pw.numpy() - jw).max() <= unit * np.abs(w).max()
    assert np.abs(pp.numpy() - jp).max() <= unit
    assert np.abs(poff.numpy() - joff).max() <= unit

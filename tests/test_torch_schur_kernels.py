"""The plain versions of the port's three general-eigen kernels held against
the JAX package's Pallas kernels in interpret mode on the CPU, and the
port's clamping slice helper at the array's edges. Inputs come from numpy
with fixed seeds.

* ``bulge_chase_steps`` at the four cases of ``tests/test_bulge_chase.py``
  and at the main path's W = 128 with NB = 16: V_acc and the carries
  entry by entry within 1e-12 (the tolerance that file holds the Pallas
  kernel to its XLA form in float64: the same reflectors applied in
  another summation order), plus 100 times the reference's own change
  under an eps-level perturbation of its input (the long train
  amplifies rounding; see the test); V_acc orthogonal, and the slide's
  contract: Vᵀ·B·V Hessenberg outside the bulges' last positions, with
  the carries equal to its bulge columns, within eps·W·max|B|. The
  same trains over their first 8 steps entry by entry within 1e-12.
* ``schur_small`` at n ∈ {8, 16, 24, 48}, a symmetric tridiagonal and a
  defective Jordan block: each side held to the contract of
  ``tests/test_schur_small.py`` (orthogonality, similarity and the junk
  below the subdiagonal ≤ 64·eps·n, scaled by max|A|), and the two
  eigenvalue sets matched nearest to nearest within 1e3·eps·n·max|A|.
  Entry by entry is not well posed: rounding in another order may flip
  a deflation decision, and with it the trajectory.
* ``trevc_solve`` at n = 192 in float64 with a cluster of three equal
  diagonal entries: the columns within 1e-10 after normalising each, as
  ``tests/test_schur_eigen.py:149-185`` holds the Pallas kernel to the
  blocked XLA form (columns are defined up to scale).
"""
import functools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from nd4js_tpu.la.schur import _trevc_backsub_blocked
from nd4js_tpu.ops.bulge_chase import bulge_chase_steps as jax_bulge_chase
from nd4js_tpu.ops.schur_small import schur_small as jax_schur_small
from nd4js_tpu.ops.trevc_solve import trevc_solve as jax_trevc_solve

from nd4js_tpu_torch.la import schur as pschur
from nd4js_tpu_torch.ops import bulge_chase as bc
from nd4js_tpu_torch.ops import schur_small as ss
from nd4js_tpu_torch.ops import trevc_solve as tv

EPS64 = np.finfo(np.float64).eps


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of tiny torch ops; under pytest-xdist
    several workers share the cores, and a multi-threaded intra-op pool
    for each tiny op makes them many times slower. One thread per worker
    for this module's tests; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


# ---------------------------------------------------------- bulge_chase


def _chase_case(w, nb, k0_off, lo=0):
    """A slide's input as the Schur loop hands it over: a Hessenberg block,
    zero subdiagonals at the window's edges and each carried bulge's
    column B[kb..kb+2, kb−1] equal to its carry."""
    rng = np.random.default_rng(w * 100 + nb * 10 + k0_off)
    b = np.triu(rng.standard_normal((w, w)), -1)
    shifts = rng.standard_normal((nb, 2))
    seed = k0_off == 0
    p = np.zeros((nb, 3)) if seed else rng.standard_normal((nb, 3))
    off, k0, hi = 3 * (nb - 1), lo + k0_off, w - 2
    for r in (lo - k0 + off, hi - k0 + off):
        if 1 <= r < w:
            b[r, r - 1] = 0.0
    for i in range(0 if seed else nb):
        kb = off - 3 * i
        if lo <= k0 - 3 * i <= hi - 2 and kb >= 1:
            b[kb:kb + 3, kb - 1] = p[i]
    return b, p, shifts, seed, rng


def _chase_contract(b, v, pp, k0, lo, hi, sl):
    """B' = Vᵀ·B·V zero below the subdiagonal outside the three entries of
    each bulge active at the last step, and those bulges' carries equal
    to their columns B'[kb+1..kb+3, kb], within eps·W·max|B| (the slide
    stays under 0.04 of that): the largest miss of either."""
    w, nb = b.shape[-1], pp.shape[0]
    off, t = 3 * (nb - 1), sl - 1
    bp = v.T @ b @ v
    junk = np.tril(bp, -2)
    miss = 0.0
    for i in range(nb):
        k, kb = k0 + t - 3 * i, t + off - 3 * i
        if not lo <= k <= hi - 2:
            continue
        for r, c in ((kb + 2, kb), (kb + 3, kb), (kb + 3, kb + 1)):
            if r < w:
                junk[r, c] = 0.0
        want = [bp[kb + 1 + j, kb] if kb + 1 + j < w and (j < 2 or k + 3 < hi)
                else 0.0 for j in range(3)]
        miss = max(miss, np.abs(pp[i] - want).max())
    assert max(np.abs(junk).max(), miss) <= EPS64 * w * np.abs(b).max()


def _jax_chase(b, p, shifts, k0, lo, hi, sl, seed):
    return (np.asarray(x) for x in jax_bulge_chase(
        jnp.asarray(b), jnp.asarray(p), jnp.asarray(shifts), k0, lo, hi,
        sl=sl, seed=seed, interpret=True))


@pytest.mark.parametrize("w,nb,k0_off", [(32, 2, 0), (32, 2, 7), (24, 1, 0),
                                         (24, 1, 15), (128, 16, 0),
                                         (128, 16, 80)])
def test_bulge_chase_plain_matches_the_pallas_kernel(w, nb, k0_off):
    """Entering bulges (seeded), carried ones mid-sweep, a single bulge
    exiting through hi − 2, and the main path's (W, NB, SL) = (128, 16,
    80) seeded and carried.

    A train of 16 bulges through 80 random positions amplifies rounding:
    the Pallas kernel's own V_acc moves by up to 2e-5 when b is perturbed
    at 1e-15 (each bulge's reflector is built from entries its
    predecessors wrote). So beside the fixed 1e-12, the tolerance holds
    100 times that measured sensitivity of the reference; the slide's
    contract (``_chase_contract``) and V_acc's orthogonality hold however
    the rounding went, and ``test_bulge_chase_short_slide_...`` holds the
    same trains entry by entry before the amplification."""
    b, p, shifts, seed, rng = _chase_case(w, nb, k0_off)
    sl = w - 3 * nb
    lo, hi = 0, w - 2
    v_ref, p_ref = _jax_chase(b, p, shifts, lo + k0_off, lo, hi, sl, seed)
    v_pert, p_pert = _jax_chase(
        b * (1 + 1e-15 * rng.standard_normal(b.shape)), p, shifts,
        lo + k0_off, lo, hi, sl, seed)
    sens_v = np.abs(v_pert - v_ref).max()
    sens_p = np.abs(p_pert - p_ref).max()
    v, pp = bc.bulge_chase_steps(_t(b), _t(p), _t(shifts), lo + k0_off, lo,
                                 hi, sl, seed)
    assert bc.launches == 0
    assert np.abs(v.numpy() - v_ref).max() <= 1e-12 + 100 * sens_v
    assert np.abs(pp.numpy() - p_ref).max() <= \
        1e-12 * max(1.0, np.abs(p_ref).max()) + 100 * sens_p
    # V_acc is orthogonal however the rounding went
    assert np.abs(v.numpy().T @ v.numpy() - np.eye(w)).max() <= 1e-13
    _chase_contract(b, v.numpy(), pp.numpy(), lo + k0_off, lo, hi, sl)


@pytest.mark.parametrize("k0_off", [0, 80])
def test_bulge_chase_short_slide_matches_the_pallas_kernel_entrywise(k0_off):
    """The main path's train (W = 128, NB = 16), seeded and carried, over
    its first 8 steps, before a long train amplifies rounding: V_acc and
    the carries within 1e-12, with no allowance for sensitivity (the two
    differ by a few eps here)."""
    b, p, shifts, seed, _ = _chase_case(128, 16, k0_off)
    lo, hi, sl = 0, 126, 8
    v_ref, p_ref = _jax_chase(b, p, shifts, k0_off, lo, hi, sl, seed)
    v, pp = bc.bulge_chase_steps(_t(b), _t(p), _t(shifts), k0_off, lo, hi,
                                 sl, seed)
    assert np.abs(v.numpy() - v_ref).max() <= 1e-12
    assert np.abs(pp.numpy() - p_ref).max() <= \
        1e-12 * max(1.0, np.abs(p_ref).max())
    _chase_contract(b, v.numpy(), pp.numpy(), k0_off, lo, hi, sl)


def test_bulge_chase_rejects_a_train_that_does_not_fit():
    b = torch.zeros((24, 24), dtype=torch.float64)
    with pytest.raises(ValueError):
        bc.bulge_chase_steps(b, torch.zeros((4, 3)), torch.zeros((4, 2)), 0,
                             0, 22, 24 - 3 * 4 + 1, True)


# ---------------------------------------------------------- schur_small


def _schur_contract(a, t, q, tol_scale=1.0):
    n = a.shape[-1]
    nrm = max(1.0, np.abs(a).max())
    unit = 64 * EPS64 * n * tol_scale
    assert np.abs(q.T @ q - np.eye(n)).max() <= unit
    assert np.abs(q @ t @ q.T - a).max() <= unit * nrm
    assert np.abs(np.tril(t, -2)).max() <= unit * nrm


def _inputs(name):
    rng = np.random.default_rng(sorted(SMALL).index(name) + 40)
    n = SMALL[name]
    if name == "tridiagonal":
        return np.diag(np.arange(1.0, n + 1)) + np.diag(np.ones(n - 1), 1) \
            + np.diag(np.ones(n - 1), -1)
    if name == "jordan":
        return 2.0 * np.eye(n) + np.diag(np.ones(n - 1), 1)
    return np.triu(rng.standard_normal((n, n)), -1)


SMALL = {"n8": 8, "n16": 16, "n24": 24, "n48": 48, "tridiagonal": 24,
         "jordan": 12}


@functools.lru_cache(maxsize=None)
def _jax_small(name):
    t, q, lk = jax_schur_small(jnp.asarray(_inputs(name)), interpret=True)
    return np.asarray(t), np.asarray(q), np.asarray(lk)[0]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_schur_small_plain_matches_the_pallas_kernel(name):
    a = _inputs(name)
    n = a.shape[-1]
    t, q, lk, its = ss.schur_small(_t(a)[None])
    assert ss.launches == 0
    t, q, lk = t[0].numpy(), q[0].numpy(), lk[0].numpy()
    assert 0 < int(its[0]) <= 40 * n
    jt, jq, jlk = _jax_small(name)
    # a Jordan block's eigenvalues are only O(eps^{1/n}) accurate
    scale = 16.0 if name == "jordan" else 1.0
    for tt, qq in ((t, q), (jt, jq)):
        _schur_contract(a, tt, qq, scale)
    if name == "jordan":
        ev = np.linalg.eigvals(np.triu(t, -1))
        assert np.abs(ev - 2.0).max() <= 0.2
        return
    # every locked flag sits on a 2×2 block with complex eigenvalues
    for j in np.nonzero(lk > 0.5)[0]:
        blk = t[j:j + 2, j:j + 2]
        disc = (blk[0, 0] - blk[1, 1]) ** 2 + 4 * blk[0, 1] * blk[1, 0]
        assert disc < 0
    ev = np.linalg.eigvals(np.triu(t, -1))
    evj = list(np.linalg.eigvals(np.triu(jt, -1)))
    tol = 1e3 * EPS64 * n * max(1.0, np.abs(a).max())
    for w in ev:
        i = int(np.argmin(np.abs(np.asarray(evj) - w)))
        assert abs(evj[i] - w) <= tol
        evj.pop(i)
    if name == "tridiagonal":
        # all eigenvalues real: fully triangular, nothing locked
        assert np.abs(np.tril(t, -1)).max() <= 1e-12
        assert lk.sum() == 0 and jlk.sum() == 0


def test_schur_small_locks_the_complex_pairs_of_rotation_blocks():
    """Eight rotation blocks made dense Hessenberg: every eigenvalue is
    complex, so the iteration must end by locking n/2 pairs, as the Pallas
    kernel does (``tests/test_schur_small.py``)."""
    n = 16
    a0 = np.zeros((n, n))
    for i in range(n // 2):
        th = 0.3 + 0.35 * i
        a0[2 * i:2 * i + 2, 2 * i:2 * i + 2] = (1.0 + i) * np.array(
            [[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    qr, _ = np.linalg.qr(np.random.default_rng(3).standard_normal((n, n)))
    h = pschur._hessenberg_core(_t(qr @ a0 @ qr.T)[None])[0][0]
    t, q, lk, _ = ss.schur_small(h[None])
    _schur_contract(h.numpy(), t[0].numpy(), q[0].numpy())
    assert int(lk.sum()) == n // 2
    _, _, jlk = (np.asarray(x) for x in jax_schur_small(
        jnp.asarray(h.numpy()), interpret=True))
    assert int(jlk.sum()) == n // 2


def test_schur_small_batch_is_its_matrices_one_by_one():
    rng = np.random.default_rng(7)
    a = np.triu(rng.standard_normal((3, 10, 10)), -1)
    got = ss.schur_small(_t(a))
    for b in range(3):
        one = ss.schur_small(_t(a[b])[None])
        for g, o in zip(got, one):
            assert torch.equal(g[b], o[0])


# ---------------------------------------------------------- trevc_solve


def test_trevc_plain_matches_the_pallas_kernel_with_a_defective_cluster():
    n = 192
    rng = np.random.default_rng(0)
    tre = np.triu(rng.standard_normal((n, n)))
    tim = np.triu(rng.standard_normal((n, n)))
    # a defective cluster: three equal diagonal entries
    for i in (10, 70):
        tre[i, i], tim[i, i] = tre[5, 5], tim[5, 5]
    lam = (np.diag(tre).copy(), np.diag(tim).copy())
    tnorm = np.sqrt((tre * tre + tim * tim).sum())
    smallnum = EPS64 * tnorm + np.finfo(np.float64).tiny
    bignum = np.sqrt(np.finfo(np.float64).max) / n
    xk = jax_trevc_solve(jnp.asarray(tre), jnp.asarray(tim),
                         jnp.asarray(lam[0]), jnp.asarray(lam[1]), smallnum,
                         bignum, interpret=True)
    xr = _trevc_backsub_blocked((jnp.asarray(tre), jnp.asarray(tim)),
                                (jnp.asarray(lam[0]), jnp.asarray(lam[1])),
                                smallnum, bignum)
    got = tv.trevc_solve(_t(tre)[None], _t(tim)[None], _t(lam[0])[None],
                         _t(lam[1])[None], torch.tensor([smallnum],
                                                        dtype=torch.float64),
                         bignum)
    assert tv.launches == 0

    def norml(x):
        re, im = np.asarray(x[0]), np.asarray(x[1])
        nrm = np.sqrt((re ** 2 + im ** 2).sum(0))
        nrm = np.where(nrm == 0, 1, nrm)
        return re / nrm, im / nrm

    r1, i1 = norml((got[0][0].numpy(), got[1][0].numpy()))
    for ref in (xk, xr):
        r0, i0 = norml(ref)
        assert np.abs(r1 - r0).max() < 1e-10
        assert np.abs(i1 - i0).max() < 1e-10
    assert np.all(np.tril(r1, -1) == 0) and np.all(np.diag(got[0][0]) == 1)


# ---------------------------------------------------------- the slice helper


@pytest.mark.parametrize("start,size,dim,want", [
    (0, 3, 10, 0), (7, 3, 10, 7), (8, 3, 10, 7), (15, 3, 10, 7),
    (-1, 3, 10, 7), (-4, 3, 10, 6), (-40, 3, 10, 0), (4, 10, 10, 0),
    (9, 1, 10, 9), (10, 1, 10, 9)])
def test_dslice_clamps_its_start_as_lax_dynamic_slice(start, size, dim, want):
    assert pschur._dslice_start(start, size, dim) == want
    x = torch.arange(dim * dim, dtype=torch.float64).reshape(dim, dim)
    blk = pschur._dslice(x, (start, 0), (size, dim))
    assert tuple(blk.shape) == (size, dim)
    assert torch.equal(blk, x[want:want + size])
    j = jnp.arange(dim * dim, dtype=jnp.float64).reshape(dim, dim)
    import jax
    ref = jax.lax.dynamic_slice(j, (start, 0), (size, dim))
    assert np.array_equal(blk.numpy(), np.asarray(ref))


def test_get_clamps_at_the_edges():
    """``_get(h, min(k+3, n−1), k)`` and out-of-range reads give what
    ``lax.dynamic_slice`` gives: clamped to the last row or column, a
    negative index counted from the end."""
    n = 6
    h = torch.arange(n * n, dtype=torch.float64).reshape(n, n)
    for k in range(n):
        assert float(pschur._get(h, min(k + 3, n - 1), k)) == \
            float(h[min(k + 3, n - 1), k])
    assert float(pschur._get(h, n + 2, -1)) == float(h[n - 1, n - 1])
    assert float(pschur._get(h, -n - 3, n)) == float(h[0, n - 1])

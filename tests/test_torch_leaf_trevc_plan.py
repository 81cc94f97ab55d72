"""The launch plans of the port's ``chol_leaf`` and ``trevc_solve`` kernels,
and plain models of the two kernels' arithmetic orders held against the
JAX package, on the CPU.

``chol_leaf.plan`` chooses the warps of the one block a matrix;
``trevc_solve.plan`` cuts the columns into uniform tiles, one block each.
Both are checked at an H100's 132 SMs, with the kernels' constants read
from ``csrc/chol_leaf.cu`` and ``csrc/trevc_solve.cu``.

The models repeat, in numpy, the order in which each kernel computes:
``chol_leaf`` right-looking, with L⁻¹ by forward elimination on [L | I] in
the same loop (row j of X taken times d / pivot, the reciprocal of L[j, j]);
``trevc_solve`` tile by tile over the reference's 64-row blocks, the sum
below each block as one product and the in-block recurrence on running
sums, each column rescaled with its sums and in-block rows at once and the
rows below at the block's end. They are held against the Pallas kernel in
interpret mode and against ``_trevc_backsub_blocked``, on small shapes.
Torch runs on one thread; about 10 s.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nd4js_tpu.la.schur import _trevc_backsub_blocked
from nd4js_tpu.ops.chol_leaf import chol_leaf as jax_chol_leaf

from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import chol_leaf as cl
from nd4js_tpu_torch.ops import trevc_solve as tv

CSRC = Path(cl.__file__).resolve().parent.parent / "csrc"
CSRC_CHOL = (CSRC / "chol_leaf.cu").read_text()
CSRC_TREVC = (CSRC / "trevc_solve.cu").read_text()
DTYPES = [torch.float32, torch.float64]
H100_SMS = 132
# no tile's work (_trevc_work) exceeds the mean over the tiles by more than
# this: for uniform tiles the rightmost tile's k² is at most three times the
# mean of k² over its tiles (n² against (n² + 2n)/3 or more), and its chain
# of k rows at most twice the mean
BALANCE = 3.0
# summation order differs between the model and the references: 1e-10 in
# float64 and 1e-4 in float32, on L relative to max|A| and on L⁻¹ relative
# to max|L⁻¹| (as tests/test_torch_chol_lu_kernels.py)
TOL = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread per xdist worker for this module; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _constant(src: str, name: str) -> int:
    return int(re.search(rf"constexpr int {name} = (\w+);", src).group(1))


# ---------------------------------------------------------- chol_leaf plan


def test_chol_leaf_constants_match_the_kernel():
    cases = re.findall(r"case (\d+): return launch_w<T, \1>", CSRC_CHOL)
    assert tuple(int(c) for c in cases) == cl.WARPS
    assert _constant(CSRC_CHOL, "kLeaf") == cl.LEAF
    # the launch bounds' blocks an SM, as blocks_per_sm models them
    assert "16 / W / (int)(sizeof(T) / 4)" in CSRC_CHOL


@pytest.mark.parametrize("nb", [0, 1, 8, 32, 1024])
@pytest.mark.parametrize("n", [1, 8, 33, 64])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("with_inv", [False, True])
def test_chol_leaf_plan_states_its_rule(nb, n, dtype, with_inv):
    """The most warps whose blocks the card holds at once, else the
    fewest; a block's shared memory within Hopper's 227 KB."""
    warps = cl.plan(nb, n, dtype, with_inv, H100_SMS)
    assert warps in cl.WARPS
    elem = torch.finfo(dtype).bits // 8
    assert elem * (n * (n + 1) + 2 * cl.LEAF) <= _build.SMEM_MAX
    held = {w: cl.blocks_per_sm(w, n, dtype) * H100_SMS for w in cl.WARPS}
    one_wave = [w for w in cl.WARPS if nb <= held[w]]
    assert warps == (max(one_wave) if one_wave else min(cl.WARPS))
    # the main path's leaves: 16 warps at a batch of 32 or 1, 8 at 1024
    assert warps == (16 if nb <= 32 else 8)


def test_chol_leaf_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="n <= 64"):
        cl.plan(4, 65, torch.float32, True, H100_SMS)


# ---------------------------------------------------------- trevc_solve plan


def test_trevc_constants_match_the_kernel():
    assert _constant(CSRC_TREVC, "kNB") == tv.NB
    assert _constant(CSRC_TREVC, "kWMax") == tv.W_MAX
    assert _constant(CSRC_TREVC, "kNT") == 32 * tv.W_MAX
    assert "kLdD = kNB + 1;" in CSRC_TREVC
    # smem_bytes' terms, as the kernel lays its shared memory out
    for term in ("sm.dim = sm.dre + kNB * kLdD",
                 "sm.red_r = sm.dim + kNB * kLdD",
                 "sm.red_i = sm.red_r + kNB * ldr",
                 "sm.xre = sm.red_i + kNB * ldr", "sm.rows = kmax + 1",
                 "sm.xim = sm.xre + sm.rows * w", "ldr = w + 1"):
        assert term in CSRC_TREVC


def _trevc_work(k1: int, w: int) -> int:
    """A tile's work: the k1 rows of its in-block chain and the complex
    multiply-adds of its contraction, w for each of T's k1·(k1 − 1)/2
    entries above the diagonal."""
    return k1 + w * k1 * (k1 - 1) // 2


@pytest.mark.parametrize("n", [1, 63, 64, 100, 192, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_trevc_plan_covers_every_column_once_and_balances(n, dtype):
    tiles = tv.plan(1, n, dtype, H100_SMS)
    cover = np.zeros(n, int)
    for k0, w in tiles:
        assert 1 <= w <= tv.W_MAX
        cover[k0:k0 + w] += 1
        assert tv.smem_bytes(k0 + w, w, dtype) <= _build.SMEM_MAX
    assert (cover == 1).all()
    # rightmost first: the longest chains start first
    assert tiles[0][0] + tiles[0][1] == n
    assert [k0 for k0, _ in tiles] == sorted((k0 for k0, _ in tiles),
                                             reverse=True)
    work = [_trevc_work(k0 + w, w) for k0, w in tiles]
    assert max(work) <= BALANCE * np.mean(work)


@pytest.mark.parametrize("n", [1, 63, 64, 100, 1024])
@pytest.mark.parametrize("dtype", DTYPES)
def test_trevc_plan_is_uniform_tiles_of_the_measured_width(n, dtype):
    """Tiles of TILE columns from the right, the leftmost narrower when
    TILE does not divide n: config 4's (1, 1024, 1024) takes 256 tiles."""
    tiles = tv.plan(1, n, dtype, H100_SMS)
    widths = [w for _, w in tiles]
    assert widths[:-1] == [tv.TILE] * (len(widths) - 1)
    assert widths[-1] == (n % tv.TILE or min(n, tv.TILE))
    if n == 1024:
        assert len(tiles) == 256


@pytest.mark.parametrize("B", [0, 1, 2, 8, 256])
def test_trevc_plan_does_not_depend_on_the_batch_or_the_card(B):
    """Only B = 1 on 132 SMs was timed, so neither changes the tiles."""
    one = tv.plan(1, 256, torch.float32, H100_SMS)
    assert tv.plan(B, 256, torch.float32, H100_SMS) == one
    assert tv.plan(B, 256, torch.float32, 78) == one


def test_trevc_plan_narrows_its_tiles_where_they_do_not_fit():
    """The widest n whose x of TILE columns fits a block takes tiles of
    TILE; one more row, tiles of TILE − 1."""
    n = max(m for m in range(1, 60000)
            if tv.smem_bytes(m, tv.TILE, torch.float64) <= _build.SMEM_MAX)
    assert {w for _, w in tv.plan(1, n, torch.float64, H100_SMS)} == {tv.TILE}
    wide = {w for k0, w in tv.plan(1, n + 1, torch.float64, H100_SMS)
            if k0 > 0}
    assert wide == {tv.TILE - 1}


def test_trevc_plan_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="n >= 1"):
        tv.plan(1, 0, torch.float32, H100_SMS)
    with pytest.raises(ValueError, match="does not fit"):
        tv.plan(1, 40000, torch.float64, H100_SMS)


# ---------------------------------------------------------- chol_leaf model


def chol_leaf_model(a: np.ndarray, with_inv: bool):
    """The kernel's order: right-looking, column j divided by the IEEE
    square root d of its pivot, the rank-1 update of the trailing lower
    triangle; X = L⁻¹ by forward elimination on [L | I] in the same loop,
    row j times d / pivot (= 1 / L[j, j]), then X[i, :] −= L[i, j]·X[j, :]
    for i > j. Reads only the lower triangle."""
    n = a.shape[-1]
    A = np.tril(a).copy()
    X = np.broadcast_to(np.eye(n, dtype=a.dtype), a.shape).copy()
    for j in range(n):
        piv = A[:, j, j].copy()
        d = np.sqrt(piv)
        A[:, j:, j] = A[:, j:, j] / d[:, None]
        col = A[:, j + 1:, j]
        A[:, j + 1:, j + 1:] -= np.tril(col[:, :, None] * col[:, None, :])
        if with_inv:
            X[:, j, :] = X[:, j, :] * (d / piv)[:, None]
            X[:, j + 1:, :] -= col[:, :, None] * X[:, j, None, :]
    return np.tril(A), (X if with_inv else None)


def _spd(rng, shape, dtype):
    a = rng.standard_normal(shape)
    n = shape[-1]
    return (a @ np.swapaxes(a, -1, -2) / n + 2 * np.eye(n)).astype(dtype)


def _assert_close(got, want, scale, dtype):
    np.testing.assert_allclose(got, np.asarray(want).astype(got.dtype),
                               atol=TOL[dtype] * scale)


@pytest.mark.parametrize("n", [1, 8, 33])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_chol_leaf_model_matches_the_pallas_kernel(n, dtype):
    a = _spd(np.random.default_rng(130 + n), (3, n, n), dtype)
    jl, jli = jax_chol_leaf(a, True, interpret=True)
    l, li = chol_leaf_model(a, True)
    _assert_close(l, jl, np.abs(a).max(), dtype)
    _assert_close(li, jli, np.abs(np.asarray(jli)).max(), dtype)
    assert np.abs(np.triu(l, 1)).max() == 0.0
    assert np.abs(np.triu(li, 1)).max() == 0.0


@pytest.mark.parametrize("n", [16, 64])
def test_chol_leaf_model_matches_the_plain_version_under_garbage(n):
    """Against the port's plain version (row-by-row substitution) with an
    upper triangle of garbage, in both types; non-SPD input gives NaN."""
    rng = np.random.default_rng(140 + n)
    lower = np.tril(_spd(rng, (4, n, n), np.float64))
    garbage = lower + np.triu(rng.standard_normal(lower.shape) * 1e6, 1)
    for dtype in (np.float64, np.float32):
        l, li = chol_leaf_model(garbage.astype(dtype), True)
        rl, rli = cl.chol_leaf_ref(torch.from_numpy(lower.astype(dtype)),
                                   True)
        _assert_close(l, rl.numpy(), np.abs(lower).max(), dtype)
        _assert_close(li, rli.numpy(), float(rli.abs().max()), dtype)
    with np.errstate(invalid="ignore"):
        l, li = chol_leaf_model(-np.eye(4)[None], True)
    assert np.isnan(l).any() and np.isnan(li).any()


# ---------------------------------------------------------- trevc model


def _smith(ar, ai, br, bi):
    """core/cpx.py div, branch for branch, with the divisor's terms formed
    first as the kernel forms them before the recurrence."""
    if abs(br) >= abs(bi):
        r = bi / (br if br != 0 else 1.0)
        den = br + bi * r
        den = den if den != 0 else 1.0
        return (ar + ai * r) / den, (ai - ar * r) / den
    r = br / (bi if bi != 0 else 1.0)
    den = bi + br * r
    den = den if den != 0 else 1.0
    return (ar * r + ai) / den, (ai * r - ar) / den


def trevc_model(tre, tim, lre, lim, smallnum, bignum, tiles, nbk=64):
    """The kernel's order on one matrix (n, n) in float64, tile by tile:
    x of the tile from the identity's columns; per 64-row block of the
    reference, bottom-up from the first with a row above the tile's last
    column, acc = T[b0:b1, b1:kmax+1]·x[b1:kmax+1, tile], then each column
    k's rows b0 + il ≤ k top-down: the unit at row k, else the Smith
    quotient of −acc by the clamped pivot; a quotient over bignum rescales
    the column's sums and its solved rows of the block at once (and its
    rows below the block by the product of the factors at the block's
    end); then the rank-1 update of the rows above by T[rows, i]·x_i."""
    n = tre.shape[-1]
    xr, xi = np.zeros((n, n)), np.zeros((n, n))
    for k0, w in tiles:
        kmax = k0 + w - 1
        sr = np.zeros((kmax + 1, w))
        si = np.zeros((kmax + 1, w))
        sr[np.arange(k0, kmax + 1), np.arange(w)] = 1.0
        b1 = n - 1 - nbk * ((n - 1 - kmax) // nbk)
        while b1 > 0:
            b0 = max(0, b1 - nbk)
            if b0 < kmax:
                tr, ti = tre[b0:b1, b1:kmax + 1], tim[b0:b1, b1:kmax + 1]
                ar = tr @ sr[b1:] - ti @ si[b1:]
                ai = tr @ si[b1:] + ti @ sr[b1:]
                for c in range(w):
                    k = k0 + c
                    top = min(b1 - b0 - 1, k - b0)
                    ftot = 1.0
                    for il in range(top, -1, -1):
                        i = b0 + il
                        if i == k:
                            zr, zi = 1.0, 0.0
                        else:
                            dr, di = tre[i, i] - lre[k], tim[i, i] - lim[k]
                            if np.hypot(dr, di) <= smallnum:
                                dr, di = smallnum, 0.0
                            zr, zi = _smith(-ar[il, c], -ai[il, c], dr, di)
                            m = max(abs(zr), abs(zi))
                            if m > bignum:
                                f = 1.0 / m
                                zr, zi = zr * f, zi * f
                                ar[:, c] *= f
                                ai[:, c] *= f
                                sr[i + 1:b0 + top + 1, c] *= f
                                si[i + 1:b0 + top + 1, c] *= f
                                ftot *= f
                        sr[i, c], si[i, c] = zr, zi
                        t_r, t_i = tre[b0:i, i], tim[b0:i, i]
                        ar[:il, c] += t_r * zr - t_i * zi
                        ai[:il, c] += t_r * zi + t_i * zr
                    if ftot != 1.0:
                        sr[b1:k + 1, c] *= ftot
                        si[b1:k + 1, c] *= ftot
            b1 -= nbk
        xr[:kmax + 1, k0:kmax + 1] = sr
        xi[:kmax + 1, k0:kmax + 1] = si
    return xr, xi


def _triangular(rng, n, cluster):
    tre = np.triu(rng.standard_normal((n, n)))
    tim = np.triu(rng.standard_normal((n, n)))
    if cluster:
        for i in (10, 70):
            tre[i, i], tim[i, i] = tre[5, 5], tim[5, 5]
    eps = np.finfo(np.float64).eps
    small = eps * np.sqrt((tre ** 2 + tim ** 2).sum()) \
        + np.finfo(np.float64).tiny
    return tre, tim, small


def _unit(re, im):
    re, im = np.asarray(re), np.asarray(im)
    nrm = np.sqrt((re ** 2 + im ** 2).sum(0))
    nrm = np.where(nrm == 0, 1, nrm)
    return re / nrm, im / nrm


@pytest.mark.parametrize("n,cluster,bignum", [
    (100, True, None), (192, True, None), (130, False, 30.0),
    (192, True, 30.0), (63, False, None)])
def test_trevc_model_matches_the_blocked_reference(n, cluster, bignum):
    """On the plan's tiles, on tiles of 5 (ragged at the left) and on
    uneven tiles (widths 1, 8, 3, 6 in turn from the right),
    against the JAX package's _trevc_backsub_blocked in float64, with a
    cluster of three equal diagonal entries (rows 5, 10, 70: clamped
    pivots) and with a bignum of 30 (many columns rescaled, several times
    in a block)."""
    tre, tim, small = _triangular(np.random.default_rng(150 + n), n, cluster)
    lam = (np.diag(tre).copy(), np.diag(tim).copy())
    big = np.sqrt(np.finfo(np.float64).max) / n if bignum is None else bignum
    want = _unit(*_trevc_backsub_blocked(
        (jnp.asarray(tre), jnp.asarray(tim)),
        (jnp.asarray(lam[0]), jnp.asarray(lam[1])), small, big))
    k1, fives, uneven = n, [], []
    while k1 > 0:
        fives.append((max(0, k1 - 5), k1 - max(0, k1 - 5)))
        k1 -= 5
    k1, cycle = n, (1, 8, 3, 6)
    while k1 > 0:
        w = min(k1, cycle[len(uneven) % len(cycle)])
        uneven.append((k1 - w, w))
        k1 -= w
    for tiles in (tv.plan(1, n, torch.float64, H100_SMS), tuple(fives),
                  tuple(uneven)):
        got = trevc_model(tre, tim, *lam, small, big, tiles)
        assert np.all(np.tril(got[0], -1) == 0)
        assert np.all(np.tril(got[1], -1) == 0)
        for g, w in zip(_unit(*got), want):
            assert np.abs(g - w).max() < 1e-10


def test_trevc_model_matches_the_plain_version_when_rescaling():
    """bignum 30 on n = 100 with a cluster: the port's plain version
    (trevc_solve_ref) and the model agree column by column, before
    normalisation too (the rescale factors are the same products)."""
    tre, tim, small = _triangular(np.random.default_rng(160), 100, True)
    lam = (np.diag(tre).copy(), np.diag(tim).copy())
    got = trevc_model(tre, tim, *lam, small, 30.0,
                      tv.plan(1, 100, torch.float64, H100_SMS))
    ref = tv.trevc_solve_ref(*(torch.from_numpy(x)[None] for x in
                               (tre, tim, *lam)),
                             torch.tensor([small], dtype=torch.float64),
                             30.0)
    for g, r in zip(got, ref):
        r = r[0].numpy()
        assert np.abs(g - r).max() <= 1e-10 * max(1.0, np.abs(r).max())

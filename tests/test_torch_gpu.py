"""The port's CUDA kernels and its QR, Cholesky, LU and symmetric eigen
slices on the card.

Imports neither JAX nor the JAX package, so it runs on a machine without
them, skipping the JAX-based tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA card every test skips. Each kernel is held against its
plain PyTorch version on the same inputs, from numpy with a fixed seed:
1e-4·max|A| in float32 and 1e-10·max|A| in float64 on R, V and taus (the
two sum in different orders); x within the forward-error bound of the
solve, and its backward error, which does not loosen with κ(A), within
N·eps and 8× the plain version's. ``chol_leaf``'s L and L⁻¹ within the
same TOL·max|A| and TOL·max|L⁻¹|; ``lu_panel``'s factored panel within
TOL·max|A| and its rank exactly equal (the kernel and the plain version
round each product and difference alike); ``sytrd_panel`` within
SYTRD_C·eps·m·max|C| (reason below), its trailing block exactly
symmetric, and backward stable (``panel_backward_error``).
"""
import numpy as np
import pytest
import torch

from nd4js_tpu_torch import la
from nd4js_tpu_torch.la import qr
from nd4js_tpu_torch.ops import chol_leaf as cl
from nd4js_tpu_torch.ops import house_panel as hp
from nd4js_tpu_torch.ops import house_stripe as hs
from nd4js_tpu_torch.ops import lu_panel as lp
from nd4js_tpu_torch.ops import sytrd_panel as sp

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.float64: 1e-10}
DTYPES = [torch.float32, torch.float64]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _on(cuda, arr, dtype):
    return torch.from_numpy(arr).to(cuda, dtype)


def backward_error(a, y, x):
    """Per system, over the worst right-hand side, ‖A·x − y‖₂/(‖A‖₂·‖x‖₂)
    for a square A, and ‖Aᵀ(A·x − y)‖₂/(‖A‖₂·(‖A‖₂·‖x‖₂ + ‖y‖₂)) for a
    tall one (least squares): near eps for a backward-stable solve,
    whatever κ(A)."""
    a, y, x = (t.double().cpu().numpy() for t in (a, y, x))
    res = a @ x - y
    norm_a = np.linalg.norm(a, 2, axis=(-2, -1))[..., None]
    if a.shape[-2] == a.shape[-1]:
        return (np.linalg.norm(res, axis=-2)
                / (norm_a * np.linalg.norm(x, axis=-2))).max(-1)
    grad = np.linalg.norm(np.swapaxes(a, -1, -2) @ res, axis=-2)
    return (grad / (norm_a * (norm_a * np.linalg.norm(x, axis=-2)
                              + np.linalg.norm(y, axis=-2)))).max(-1)


def assert_backward_stable(a, y, x, x_ref, dtype):
    """x's backward error ≤ N·eps and ≤ 8× x_ref's (floored at eps): two
    Householder solves that round differently stay within 1.4× of each
    other on random systems. Unlike a bound on x, this does not loosen
    with κ(A)."""
    eps = torch.finfo(dtype).eps
    be, be_ref = backward_error(a, y, x), backward_error(a, y, x_ref)
    assert (be <= np.minimum(a.shape[-1] * eps,
                             8 * np.maximum(be_ref, eps))).all(), (be, be_ref)


@pytest.mark.parametrize("shape", [(3, 48, 16), (2, 32, 32), (5, 130, 20),
                                   (2, 6, 8), (1, 600, 96)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_house_panel_kernel_matches_plain_version(cuda, shape, dtype):
    a = _on(cuda, np.random.default_rng(31).standard_normal(shape), dtype)
    a[0, :, min(shape[1:]) // 2] = 0            # a zero column: tau = 0
    before = hp.launches
    got = hp.house_panel(a)
    torch.cuda.synchronize()
    assert hp.launches == before + 1
    tol = TOL[dtype] * float(a.abs().max())
    for g, w in zip(got, hp.house_panel_ref(a)):
        assert g.device.type == "cuda"
        assert float((g - w).abs().max()) <= tol


@pytest.mark.parametrize("nb,n,k", [(3, 13, 3), (2, 64, 1), (1, 256, 4)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_gesv_kernel_matches_plain_version(cuda, nb, n, k, dtype):
    rng = np.random.default_rng(32 + n)
    a64 = rng.standard_normal((nb, n, n))
    a, y = _on(cuda, a64, dtype), _on(cuda, rng.standard_normal((nb, n, k)),
                                      dtype)
    before = hs.launches
    x = hs.qr_gesv(a, y)
    torch.cuda.synchronize()
    assert hs.launches == before + 1
    x_ref = hs.qr_gesv_ref(a, y)
    err = (x - x_ref).abs().amax(dim=(-2, -1)).double().cpu().numpy()
    xmax = x_ref.abs().amax(dim=(-2, -1)).double().cpu().numpy()
    tol = np.maximum(TOL[dtype] * np.abs(a64).max(axis=(-2, -1)),
                     n * torch.finfo(dtype).eps * np.linalg.cond(a64) * xmax)
    assert (err <= tol).all()
    assert_backward_stable(a, y, x, x_ref, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_qr_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """qr_decomp over two panels and both branches of qr_lstsq_fused on
    the card against the same calls on the CPU (plain kernels there)."""
    rng = np.random.default_rng(33)
    a = rng.standard_normal((2, 200, 150))
    y = rng.standard_normal((2, 200, 2))
    sq = rng.standard_normal((3, 40, 40))
    ys = rng.standard_normal((3, 40, 2))
    tol = 100 * TOL[dtype]
    q, r = la.qr_decomp(_on(cuda, a, dtype))
    qc, rc = la.qr_decomp(torch.from_numpy(a).to(dtype))
    assert float((r.cpu() - rc).abs().max()) <= tol * np.abs(a).max()
    assert float((q.cpu() - qc).abs().max()) <= tol
    for aa, yy in ((a, y), (sq, ys)):
        x = la.qr_lstsq_fused(_on(cuda, aa, dtype), _on(cuda, yy, dtype))
        xc = la.qr_lstsq_fused(torch.from_numpy(aa).to(dtype),
                               torch.from_numpy(yy).to(dtype))
        assert x.device.type == "cuda"
        assert float((x.cpu() - xc).abs().max()) <= \
            tol * float(xc.abs().max()) * np.linalg.cond(aa).max()
        assert_backward_stable(torch.from_numpy(aa).to(dtype),
                               torch.from_numpy(yy).to(dtype), x, xc, dtype)


def _spd(rng, shape):
    """SPD blocks a·aᵀ/n + 2I from a seeded normal, with the upper
    triangle overwritten by garbage that a correct kernel never reads."""
    a = rng.standard_normal(shape)
    n = shape[-1]
    spd = a @ np.swapaxes(a, -1, -2) / n + 2 * np.eye(n)
    return np.tril(spd) + np.triu(rng.standard_normal(spd.shape) * 1e3, 1)


@pytest.mark.parametrize("shape", [(5, 64, 64), (3, 33, 33), (2, 8, 8),
                                   (1, 1, 1)])
@pytest.mark.parametrize("with_inv", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_chol_leaf_kernel_matches_plain_version(cuda, shape, with_inv, dtype):
    a = _on(cuda, _spd(np.random.default_rng(34), shape), dtype)
    before = cl.launches
    l, li = cl.chol_leaf(a, with_inv)
    torch.cuda.synchronize()
    assert cl.launches == before + 1
    l_ref, li_ref = cl.chol_leaf_ref(a, with_inv)
    amax = float(torch.tril(a).abs().max())
    assert float((l - l_ref).abs().max()) <= TOL[dtype] * amax
    assert float(torch.triu(l, 1).abs().max()) == 0.0
    if with_inv:
        assert float((li - li_ref).abs().max()) <= \
            TOL[dtype] * float(li_ref.abs().max())
    else:
        assert li is None


def test_chol_leaf_kernel_gives_nan_on_non_spd(cuda):
    a = -torch.eye(4, device=cuda, dtype=torch.float64)[None]
    l, _ = cl.chol_leaf(a, False)
    assert bool(torch.isnan(l).any())


def _panel(rng, shape):
    """A random panel with a zero column in the first matrix and tied
    |pivots| (3 and −3, twice) in column 0 of the second."""
    a = rng.standard_normal(shape)
    a[0, :, shape[2] // 2] = 0
    if shape[0] > 1:
        a[1, :4, 0] = [1.0, -3.0, 3.0, -3.0]
        a[1, 4:, 0] = 0.5
    return a


@pytest.mark.parametrize("shape", [(3, 136, 40), (2, 512, 128),
                                   (2, 384, 128), (2, 16, 16)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_panel_kernel_matches_plain_version(cuda, shape, dtype):
    a = _on(cuda, _panel(np.random.default_rng(35), shape), dtype)
    before = lp.launches["lu_panel"]
    out, rank = lp.lu_panel(a)
    torch.cuda.synchronize()
    assert lp.launches["lu_panel"] == before + 1
    out_ref, rank_ref = lp.lu_panel_ref(a)
    assert rank.dtype == torch.int32
    assert torch.equal(rank, rank_ref)
    assert float((out - out_ref).abs().max()) <= TOL[dtype] * float(a.abs().max())


@pytest.mark.parametrize("nb,n,k", [(3, 13, 3), (4, 128, 1), (2, 128, 4),
                                    (1, 128, 160)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_gesv_kernel_matches_plain_version(cuda, nb, n, k, dtype):
    """(1, 128, 160) in float64 does not fit in shared memory and runs on
    the kernel's global-memory branch."""
    rng = np.random.default_rng(36 + n + k)
    a64 = rng.standard_normal((nb, n, n))
    a, y = _on(cuda, a64, dtype), _on(cuda, rng.standard_normal((nb, n, k)),
                                      dtype)
    before = lp.launches["lu_gesv"]
    x = lp.lu_gesv(a, y)
    torch.cuda.synchronize()
    assert lp.launches["lu_gesv"] == before + 1
    x_ref = lp.lu_gesv_ref(a, y)
    err = (x - x_ref).abs().amax(dim=(-2, -1)).double().cpu().numpy()
    xmax = x_ref.abs().amax(dim=(-2, -1)).double().cpu().numpy()
    tol = np.maximum(TOL[dtype] * np.abs(a64).max(axis=(-2, -1)),
                     n * torch.finfo(dtype).eps * np.linalg.cond(a64) * xmax)
    assert (err <= tol).all()
    assert_backward_stable(a, y, x, x_ref, dtype)


def test_lu_gesv_kernel_singular_gives_non_finite(cuda):
    a = torch.ones((1, 4, 4), device=cuda)
    x = lp.lu_gesv(a, torch.ones((1, 4, 1), device=cuda))
    assert not bool(torch.isfinite(x).all())


@pytest.mark.parametrize("dtype", DTYPES)
def test_lu_chol_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """lu_decomp over three panels, lu_solve, both branches of
    lu_solve_fused, det, cholesky_decomp with and without the inverse,
    cholesky_solve both ways, and qr_decomp with cholqr2 and auto, on the
    card against the same calls on the CPU (plain kernels there)."""
    rng = np.random.default_rng(37)
    tol = 100 * TOL[dtype]

    def both(f, *arrs, **kw):
        on = f(*(_on(cuda, x, dtype) for x in arrs), **kw)
        off = f(*(torch.from_numpy(x).to(dtype) for x in arrs), **kw)
        return on, off

    a = rng.standard_normal((2, 300, 260))
    (lu, p), (luc, pc) = both(la.lu_decomp, a)
    assert torch.equal(p.cpu(), pc)
    assert float((lu.cpu() - luc).abs().max()) <= tol * float(luc.abs().max())
    sq = rng.standard_normal((3, 200, 200))
    y = rng.standard_normal((3, 200, 2))
    for aa, yy in ((sq, y), (sq[:, :100, :100], y[:, :100])):
        x, xc = both(la.lu_solve_fused, aa, yy)
        assert_backward_stable(torch.from_numpy(aa).to(dtype),
                               torch.from_numpy(yy).to(dtype), x, xc, dtype)
    d, dc = both(la.det, sq[:, :12, :12])
    assert float(((d.cpu() - dc) / dc).abs().max()) <= tol
    spd = _spd(rng, (4, 256, 256))
    amax = np.abs(np.tril(spd)).max()
    for inv in (False, True):
        on, off = both(la.cholesky_decomp, spd, inv=inv)
        on, off = (on, off) if inv else ((on, None), (off, None))
        assert float((on[0].cpu() - off[0]).abs().max()) <= tol * amax
        if inv:
            assert float((on[1].cpu() - off[1]).abs().max()) <= \
                tol * float(off[1].abs().max())
    ys = rng.standard_normal((4, 256, 3))
    L, Li = la.cholesky_decomp(_on(cuda, spd, dtype), inv=True)
    x1 = la.cholesky_solve(L, _on(cuda, ys, dtype), l_inv=Li)
    x2 = la.cholesky_solve(L, _on(cuda, ys, dtype))
    full = torch.tril(_on(cuda, spd, dtype))
    full = full + torch.tril(full, -1).mT
    for x in (x1, x2):
        resid = float((torch.matmul(full, x) - _on(cuda, ys, dtype)).abs().max())
        assert resid <= TOL[dtype] * amax * 256 ** 0.5
    tall = rng.standard_normal((2, 300, 200))
    for method in ("cholqr2", "auto"):
        (q, r), (qc, rc) = both(la.qr_decomp, tall, method=method)
        assert float((r.cpu() - rc).abs().max()) <= tol * np.abs(tall).max() * 10
        eye = torch.eye(200, device=cuda, dtype=dtype)
        assert float((q.mT @ q - eye).abs().max()) <= \
            4 * torch.finfo(dtype).eps * 300
    assert qr.auto_branches["cholqr2"] >= 2


# sytrd_panel, kernel against plain version: SYTRD_C·eps·m·max|C| on the
# trailing block, W, d and e, and SYTRD_C·eps·m on V and taus, which are
# scale-free. The two sum in different orders. At the main path's shapes
# (64 of 512 or 1024 columns) the plain version in float32 is within about
# eps·m·max|C| of itself in float64 (tests/test_torch_sytrd.py), so two
# float32 roundings differ by about twice that. Late in a reduction (bk
# close to m) the entries grow sensitive to rounding, by a factor that
# depends on the input; 32 covers the inputs here. Every panel is also held
# to its contract, which does not depend on that: see panel_backward_error.
SYTRD_C = 32
# H = Π(I − τ·v·vᵀ) orthogonal to BACKWARD_C·eps·m, and Hᵀ·C·H equal to the
# tridiagonal columns (d, e) beside the trailing block to
# BACKWARD_C·eps·m·max|C|; at most 0.15 of each on the CPU, float32 and
# float64, for any seed tried (tests/test_torch_sytrd.py).
BACKWARD_C = 2


def panel_backward_error(c, out, bk):
    """(max|Hᵀ·C·H − T|, max|Hᵀ·H − I|) in float64 for a panel's outputs:
    H = H_0···H_{bk−1}, T the tridiagonal columns d, e of the first bk
    columns and rows, zeros elsewhere beside them, and C_trailing below
    and right of them."""
    trail, V, _, taus, d, e = (x.double() for x in out)
    c = c.double()
    nb, m, _ = c.shape
    eye = torch.eye(m, dtype=torch.float64, device=c.device)
    H = eye.repeat(nb, 1, 1)
    for j in range(bk):
        v = V[:, :, j:j + 1]
        H = H - taus[:, j, None, None] * (H @ v) @ v.mT
    T = torch.zeros_like(c)
    i = torch.arange(bk, device=c.device)
    T[:, i, i] = d
    T[:, i + 1, i] = e
    T[:, i, i + 1] = e
    T[:, bk:, bk:] = trail
    return (float((H.mT @ c @ H - T).abs().max()),
            float((H.mT @ H - eye).abs().max()))


def assert_panel_backward_stable(c, out, bk):
    eps = torch.finfo(c.dtype).eps
    m = c.shape[-1]
    resid, orth = panel_backward_error(c, out, bk)
    assert resid <= BACKWARD_C * eps * m * float(c.abs().max()), resid
    assert orth <= BACKWARD_C * eps * m, orth


def _sym(rng, shape):
    a = rng.standard_normal(shape)
    return (a + np.swapaxes(a, -1, -2)) / 2


def _tau_zero(rng, nb, m):
    """Symmetric blocks whose first columns are already tridiagonal and
    whose other half is a separate block: τ = 0 on those columns."""
    a = _sym(rng, (nb, m, m))
    h = m // 2
    a[:, h:, :h] = 0
    a[:, :h, h:] = 0
    band = np.triu(np.tril(np.ones((h, h)), 1), -1)
    a[:, :h, :h] *= band
    return a


def assert_sytrd_panel_close(got, want, c, bk, dtype):
    m = c.shape[-1]
    unit = SYTRD_C * torch.finfo(dtype).eps * m
    cmax = float(c.abs().max())
    for name, g, w, scale in zip(("C_trailing", "V", "W", "taus", "d", "e"),
                                 got, want, (cmax, 1, cmax, 1, cmax, cmax)):
        assert g.shape == w.shape, name
        err = float((g - w).abs().max())
        assert err <= unit * scale, (name, err, unit * scale)
    trail = got[0]
    assert torch.equal(trail, trail.mT)


@pytest.mark.parametrize("shape,bk", [((1, 1024, 1024), 64),
                                      ((4, 512, 512), 64), ((3, 100, 100), 63),
                                      ((2, 70, 70), 1), ((2, 33, 33), 7)])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sytrd_panel_kernel_matches_plain_version(cuda, shape, bk, dtype):
    c = _on(cuda, _sym(np.random.default_rng(38), shape), dtype)
    before = sp.launches
    got = sp.sytrd_panel(c, bk)
    torch.cuda.synchronize()
    assert sp.launches == before + 1
    assert_sytrd_panel_close(got, sp.sytrd_panel_ref(c, bk), c, bk, dtype)
    assert_panel_backward_stable(c, got, bk)


@pytest.mark.parametrize("dtype", DTYPES)
def test_sytrd_panel_kernel_on_columns_with_tau_zero(cuda, dtype):
    c = _on(cuda, _tau_zero(np.random.default_rng(39), 2, 96), dtype)
    got = sp.sytrd_panel(c, 63)
    want = sp.sytrd_panel_ref(c, 63)
    assert_sytrd_panel_close(got, want, c, 63, dtype)
    assert_panel_backward_stable(c, got, 63)
    assert float(got[3][:, :47].abs().max()) == 0.0
    assert float(got[3][:, 48:].abs().min()) > 0.0
    assert torch.equal(got[5][:, :47], torch.diagonal(c, -1, 1, 2)[:, :47])


@pytest.mark.parametrize("dtype", DTYPES)
def test_eigh_slice_on_the_card_matches_the_cpu(cuda, dtype):
    """eigh (dc, at n = 130 over three panels, and jacobi), eigh_tridiag_dc
    on a batch and tridiag_eigh_dc on the card against the same calls on
    the CPU: w directly, V by its contract (orthogonality and
    reconstruction). Reconstruction within 100·eps·n·max|A| in float32 and
    the JAX package's own 1e-9·n·max|A| for its dc path in float64, where
    its eps-scale jitter of close poles leaves more than Jacobi does."""
    rng = np.random.default_rng(40)
    eps = torch.finfo(dtype).eps
    rtol = 100 * eps if dtype == torch.float32 else 1e-9
    a = _sym(rng, (130, 130))
    b = _sym(rng, (2, 3, 70, 70))
    before = sp.launches
    for arr, fn, panels in ((a, la.eigh, 3), (b, la.eigh_tridiag_dc, 2),
                            (b[0, 0, :20, :20], la.eigh, 0)):
        w, v = fn(_on(cuda, arr, dtype))
        torch.cuda.synchronize()
        assert sp.launches == before + panels
        before = sp.launches
        wc, _ = fn(torch.from_numpy(arr).to(dtype))
        n = arr.shape[-1]
        amax = np.abs(arr).max()
        assert w.device.type == "cuda"
        assert float((w.cpu() - wc).abs().max()) <= 100 * eps * n * amax
        assert bool((torch.diff(w, dim=-1) >= 0).all())
        eye = torch.eye(n, device=cuda, dtype=dtype)
        assert float((v.mT @ v - eye).abs().max()) <= 100 * eps * n
        recon = (v * w[..., None, :]) @ v.mT - _on(cuda, arr, dtype)
        assert float(recon.abs().max()) <= rtol * n * amax
    d, e = rng.standard_normal((2, 100)), rng.standard_normal((2, 99))
    w, v = la.tridiag_eigh_dc(_on(cuda, d, dtype), _on(cuda, e, dtype))
    wc, _ = la.tridiag_eigh_dc(torch.from_numpy(d).to(dtype),
                               torch.from_numpy(e).to(dtype))
    assert float((w.cpu() - wc).abs().max()) <= 100 * eps * 100 * 4


def test_eigh_auto_below_128_runs_jacobi_and_no_kernel(cuda):
    a = _on(cuda, _sym(np.random.default_rng(41), (4, 127, 127)),
            torch.float32)
    before = sp.launches
    w, v = la.eigh(a)
    torch.cuda.synchronize()
    assert sp.launches == before
    wj, _ = la.eigh(a, method="jacobi")
    assert torch.equal(w, wj)
    eps = torch.finfo(torch.float32).eps
    eye = torch.eye(127, device=cuda)
    assert float((v.mT @ v - eye).abs().max()) <= 4 * eps * 127

"""The port's CUDA kernels and its QR, Cholesky and LU slices on the card.

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
round each product and difference alike).
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

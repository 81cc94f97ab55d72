"""The port's CUDA kernels and its QR slice on the card.

Imports neither JAX nor the JAX package, so it runs on a machine without
them, skipping the JAX-based tests/conftest.py:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py

Without a CUDA card every test skips. Each kernel is held against its
plain PyTorch version on the same inputs, from numpy with a fixed seed:
1e-4·max|A| in float32 and 1e-10·max|A| in float64 on R, V and taus (the
two sum in different orders); x within the forward-error bound of the
solve, and its backward error, which does not loosen with κ(A), within
N·eps and 8× the plain version's.
"""
import numpy as np
import pytest
import torch

from nd4js_tpu_torch import la
from nd4js_tpu_torch.ops import house_panel as hp
from nd4js_tpu_torch.ops import house_stripe as hs

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

"""The port's two QR kernels, by their plain PyTorch versions, held
against the JAX package's Pallas kernels run in interpret mode on the
CPU; the wrappers' routing and input checks; and the C interface that
the wrappers bind against the CUDA sources.

The CUDA kernels themselves run only on the card (tests/test_torch_gpu.py
and chip_smoke.py hold them against these plain versions there)."""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from nd4js_tpu.ops.house_panel import house_panel as j_house_panel
from nd4js_tpu.ops.house_stripe import qr_gesv as j_qr_gesv

from nd4js_tpu_torch.ops import _build
from nd4js_tpu_torch.ops import house_panel as hp
from nd4js_tpu_torch.ops import house_stripe as hs

# summation order differs between the packages: 1e-10·max|A| in float64
# and 1e-4·max|A| in float32 on R, V and taus
TOL = {np.float64: 1e-10, np.float32: 1e-4}
CSRC = Path(hp.__file__).resolve().parent.parent / "csrc"


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def x_tolerance(a, x_ref, dtype):
    """Per-system tolerance on a solve's x: TOL·max|A|, or the
    forward-error bound N·eps·κ₂(A)·max|x| where larger, since two
    backward-stable solves that round differently differ in x by up to
    κ(A) times their backward error."""
    n = a.shape[-1]
    eps = np.finfo(dtype).eps
    kappa = np.linalg.cond(a.astype(np.float64))
    xmax = np.abs(x_ref).max(axis=(-2, -1))
    return np.maximum(TOL[dtype] * np.abs(a).max(axis=(-2, -1)),
                      n * eps * kappa * xmax)


def backward_error(a, y, x):
    """Per system, ‖A·x − y‖₂/(‖A‖₂·‖x‖₂) over the worst right-hand side:
    near eps for a backward-stable solve, whatever κ(A)."""
    a, y, x = (np.asarray(t, np.float64) for t in (a, y, x))
    res = np.linalg.norm(a @ x - y, axis=-2)
    norm_a = np.linalg.norm(a, 2, axis=(-2, -1))[..., None]
    return (res / (norm_a * np.linalg.norm(x, axis=-2))).max(-1)


def assert_backward_stable(a, y, got, want, dtype):
    """got's backward error ≤ N·eps and ≤ 8× want's (floored at eps): two
    Householder solves that round differently stay within 1.4× of each
    other on random systems. Unlike a bound on x, this does not loosen
    with κ(A)."""
    eps = np.finfo(dtype).eps
    be, be_want = backward_error(a, y, got), backward_error(a, y, want)
    assert (be <= np.minimum(a.shape[-1] * eps,
                             8 * np.maximum(be_want, eps))).all(), (be, be_want)


@pytest.mark.parametrize("shape", [(3, 48, 16), (2, 32, 32)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_house_panel_ref_matches_pallas_kernel(shape, dtype):
    """R, V and taus are unique under the sign convention, so they are
    compared directly."""
    a = np.random.default_rng(11).standard_normal(shape).astype(dtype)
    want = [np.asarray(w) for w in j_house_panel(a, interpret=True)]
    got = [g.numpy() for g in hp.house_panel_ref(_t(a))]
    tol = TOL[dtype] * np.abs(a).max()
    for name, g, w in zip(("R", "V", "taus"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, atol=tol, err_msg=name)


def test_house_panel_ref_handles_zero_and_sign_cases():
    """A zero column (tau = 0, beta = -0), a column already reduced with a
    negative pivot, and a short wide panel (M < B), against the kernel."""
    a = np.random.default_rng(12).standard_normal((2, 6, 8))
    a[0, :, 1] = 0.0
    a[1, 1:, 0] = 0.0
    a[1, 0, 0] = -3.0
    want = [np.asarray(w) for w in j_house_panel(a, interpret=True)]
    got = [g.numpy() for g in hp.house_panel_ref(_t(a))]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-12)
    assert got[2][0, 1] == 0.0 and got[2][1, 0] == 2.0


@pytest.mark.parametrize("nb,n,k", [(2, 32, 1), (2, 32, 3), (3, 13, 3)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_qr_gesv_ref_matches_pallas_kernel(nb, n, k, dtype):
    rng = np.random.default_rng(13 + n + k)
    a = rng.standard_normal((nb, n, n)).astype(dtype)
    y = rng.standard_normal((nb, n, k)).astype(dtype)
    want = np.asarray(j_qr_gesv(a, y, interpret=True))
    got = hs.qr_gesv_ref(_t(a), _t(y)).numpy()
    assert got.shape == want.shape == (nb, n, k) and got.dtype == want.dtype
    err = np.abs(got - want).max(axis=(-2, -1))
    assert (err <= x_tolerance(a, want, dtype)).all(), err
    assert_backward_stable(a, y, got, want, dtype)


def test_qr_gesv_ref_singular_gives_non_finite():
    """A singular R yields inf/nan with no guard, as the kernel does."""
    a = np.ones((1, 4, 4))
    x = hs.qr_gesv_ref(_t(a), _t(np.ones((1, 4, 1)))).numpy()
    assert not np.isfinite(x).all()


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    rng = np.random.default_rng(14)
    a = _t(rng.standard_normal((2, 10, 4)))
    before = hp.launches
    for g, w in zip(hp.house_panel(a), hp.house_panel_ref(a)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    sq = _t(rng.standard_normal((2, 6, 6)))
    y = _t(rng.standard_normal((2, 6, 2)))
    gesv_before = hs.launches
    torch.testing.assert_close(hs.qr_gesv(sq, y), hs.qr_gesv_ref(sq, y),
                               rtol=0, atol=0)
    assert hp.launches == before and hs.launches == gesv_before


@pytest.mark.parametrize("call,err,match", [
    (lambda: hp.house_panel(torch.zeros(4, 4)), ValueError, "3-D"),
    (lambda: hp.house_panel(torch.zeros(1, 4, 4, dtype=torch.int32)),
     TypeError, "float32 or float64"),
    (lambda: hp.house_panel(torch.zeros(1, 4, 4, device="meta")),
     ValueError, "no kernel for device"),
    (lambda: hs.qr_gesv(torch.zeros(1, 4, 3), torch.zeros(1, 4, 1)),
     ValueError, "needs a"),
    (lambda: hs.qr_gesv(torch.zeros(1, 4, 4), torch.zeros(1, 4, 1,
                                                          dtype=torch.float64)),
     ValueError, "share dtype"),
    (lambda: hs.qr_gesv(torch.zeros(1, 4, 4, device="meta"),
                        torch.zeros(1, 4, 1, device="meta")),
     ValueError, "no kernel for device"),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err, match):
    """Only CPU tensors fall to the plain version; another device raises."""
    with pytest.raises(err, match=match):
        call()


def test_build_without_nvcc_raises(monkeypatch):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(_build, "_NVCC_DEFAULT", "/nonexistent/nvcc")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()


def test_bound_c_functions_exist_in_the_cuda_sources():
    """Every function the wrappers bind is defined in csrc/*.cu with the
    number of arguments its ctypes signature declares."""
    src = "".join(p.read_text() for p in sorted(CSRC.glob("*.cu")))
    defined = {m.group(2): m.group(3) for m in re.finditer(
        r"^(int|size_t) (nd4js_\w+)\(([^)]*)\)", src, re.M)}
    assert set(defined) == set(_build._SIGNATURES)
    for name, (_, argtypes) in _build._SIGNATURES.items():
        assert len(defined[name].split(",")) == len(argtypes), name


def test_cuda_sources_state_what_they_replace():
    """house_stripe.cu replaces house_panel and both kernels of
    ops/house_stripe.py on the one stripe body of house_stripe.cuh: the
    one-block house_panel.cu is gone."""
    for name, tpus, design in (
            ("house_stripe.cu", ["ops/house_panel.py::house_panel",
                                 "ops/house_stripe.py::house_stripe_t",
                                 "ops/house_stripe.py::qr_gesv"],
             "house_stripe.cuh"),):
        head = (CSRC / name).read_text().split("#include")[0]
        assert all(t in head for t in tpus) and "Bound on the H100" in head
        assert design in head
    assert not (CSRC / "qr_gesv.cu").exists()
    assert not (CSRC / "house_panel.cu").exists()

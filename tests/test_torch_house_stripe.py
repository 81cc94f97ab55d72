"""The port of ``nd4js_tpu/ops/house_stripe.py``: the plain versions of its
two kernels, over one stripe body, held against the JAX package's Pallas
kernels in interpret mode on the CPU; the wrappers' routing, counters,
input checks. Inputs come from numpy with fixed seeds.

* ``house_stripe_t_ref`` against ``house_stripe_t(..., interpret=True)``
  on R, V and taus within 1e-10·max|A| in float64 and 1e-4·max|A| in
  float32 (the two sum in different orders), at shapes from
  ``tests/test_qr.py:129-130`` kept small, a B that is not a multiple of
  8, a wide panel (M < B) and panels with zero columns (τ = 0: the rest
  update's mask, ``house_stripe.py:137``, and the unpacking's,
  ``:318-319``).
* ``house_stripe_t_ref`` against the port's ``house_panel_ref`` within
  1e-12·max(1, max|R|) on R and 1e-11 on V and taus in float64, as
  ``tests/test_qr.py:133-135`` holds the two Pallas kernels.
* ``qr_gesv_ref`` (the stripe body on [A | y], then back substitution)
  against the Pallas ``qr_gesv`` in interpret mode, with K > 8 and an N
  that is not a multiple of 8: x within the solve's forward-error bound
  and backward stable.

The CUDA kernels run only on the card (tests/test_torch_gpu.py and
chip_smoke.py hold them against these plain versions there).
"""
import numpy as np
import pytest
import torch

from nd4js_tpu.ops.house_stripe import house_stripe_t as j_house_stripe_t
from nd4js_tpu.ops.house_stripe import qr_gesv as j_qr_gesv

from nd4js_tpu_torch.ops import house_panel as hp
from nd4js_tpu_torch.ops import house_stripe as hs

TOL = {np.float64: 1e-10, np.float32: 1e-4}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions are loops of small torch ops; under pytest-xdist
    several workers share the cores, and a multi-threaded intra-op pool
    for each small op makes them many times slower. One thread per worker
    for this module's tests; restored after."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _panel(shape, dtype, seed, zero_cols=()):
    a = np.random.default_rng(seed).standard_normal(shape)
    for b, c in zero_cols:
        a[b, :, c] = 0.0
    return a.astype(dtype)


# (Nb, M, B): tests/test_qr.py:129-130 kept small, a wide panel, and a
# panel of one stripe
STRIPE_SHAPES = [(2, 48, 24), (1, 32, 32), (3, 40, 17), (2, 64, 17),
                 (2, 6, 12), (2, 9, 5)]


@pytest.mark.parametrize("shape", STRIPE_SHAPES)
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_house_stripe_t_ref_matches_pallas_kernel(shape, dtype):
    """R, V and taus are unique under the sign convention, so they are
    compared directly; the first matrix has a zero column (τ = 0)."""
    a = _panel(shape, dtype, 70 + shape[-1], zero_cols=[(0, shape[-1] // 2)])
    want = [np.asarray(w) for w in j_house_stripe_t(a, interpret=True)]
    got = [g.numpy() for g in hs.house_stripe_t_ref(_t(a))]
    tol = TOL[dtype] * np.abs(a).max()
    for name, g, w in zip(("R", "V", "taus"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        np.testing.assert_allclose(g, w, atol=tol, rtol=0, err_msg=name)
    assert got[2][0, shape[-1] // 2] == 0.0


def test_house_stripe_t_ref_masks_columns_with_tau_zero():
    """Two zero columns in one stripe and a zero leading column: their τ
    is 0, V keeps only the unit diagonal there (house_stripe.py:318-319),
    and the rest update skips them (:137) — both sides agree exactly on
    which entries are zero."""
    a = _panel((2, 20, 12), np.float64, 77, zero_cols=[(0, 0), (0, 3), (1, 5)])
    want = [np.asarray(w) for w in j_house_stripe_t(a, interpret=True)]
    r, v, taus = (g.numpy() for g in hs.house_stripe_t_ref(_t(a)))
    for g, w in zip((r, v, taus), want):
        np.testing.assert_allclose(g, w, atol=1e-10 * np.abs(a).max(), rtol=0)
    for b, c in ((0, 0), (0, 3), (1, 5)):
        assert taus[b, c] == 0.0
        col = np.zeros(20)
        col[c] = 1.0
        np.testing.assert_array_equal(v[b, :, c], col)
    assert (taus[0, [1, 2, 4]] != 0).all()


@pytest.mark.parametrize("shape", [(2, 48, 24), (3, 40, 17), (2, 6, 12),
                                   (1, 64, 64)])
def test_house_stripe_t_ref_is_a_drop_in_for_house_panel_ref(shape):
    """Compact-WY stripes reassociate the same reflectors: R within
    1e-12·max(1, max|R|), V and taus within 1e-11, as test_qr.py:133-135
    holds the two Pallas kernels."""
    a = _t(_panel(shape, np.float64, 80 + shape[1], zero_cols=[(0, 1)]))
    r1, v1, t1 = hs.house_stripe_t_ref(a)
    r0, v0, t0 = hp.house_panel_ref(a)
    sc = max(1.0, float(r0.abs().max()))
    assert float((r1 - r0).abs().max()) < 1e-12 * sc
    assert float((v1 - v0).abs().max()) < 1e-12 * 10
    assert float((t1 - t0).abs().max()) < 1e-12 * 10


def x_tolerance(a, x_ref, dtype):
    """Per system: TOL·max|A|, or the forward-error bound
    N·eps·κ₂(A)·max|x| where larger (two backward-stable solves that round
    differently differ in x by up to κ(A) times their backward error)."""
    n = a.shape[-1]
    eps = np.finfo(dtype).eps
    kappa = np.linalg.cond(a.astype(np.float64))
    xmax = np.abs(x_ref).max(axis=(-2, -1))
    return np.maximum(TOL[dtype] * np.abs(a).max(axis=(-2, -1)),
                      n * eps * kappa * xmax)


def backward_error(a, y, x):
    a, y, x = (np.asarray(t, np.float64) for t in (a, y, x))
    res = np.linalg.norm(a @ x - y, axis=-2)
    norm_a = np.linalg.norm(a, 2, axis=(-2, -1))[..., None]
    return (res / (norm_a * np.linalg.norm(x, axis=-2))).max(-1)


@pytest.mark.parametrize("nb,n,k", [(2, 21, 11), (1, 40, 9), (3, 8, 16)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_stripe_qr_gesv_ref_matches_pallas_kernel(nb, n, k, dtype):
    """K > 8 (two groups of right-hand sides) and N not a multiple of 8
    (a last stripe narrower than 8 whose rest update reaches y)."""
    rng = np.random.default_rng(90 + n + k)
    a = rng.standard_normal((nb, n, n)).astype(dtype)
    y = rng.standard_normal((nb, n, k)).astype(dtype)
    want = np.asarray(j_qr_gesv(a, y, interpret=True))
    got = hs.qr_gesv_ref(_t(a), _t(y)).numpy()
    assert got.shape == want.shape == (nb, n, k) and got.dtype == want.dtype
    err = np.abs(got - want).max(axis=(-2, -1))
    assert (err <= x_tolerance(a, want, dtype)).all(), err
    eps = np.finfo(dtype).eps
    be, be_want = backward_error(a, y, got), backward_error(a, y, want)
    assert (be <= np.minimum(n * eps, 8 * np.maximum(be_want, eps))).all()


def test_stripe_body_ref_matches_the_elimination_step_by_step():
    """In float64 the body's [R | Qᵀy] equals Householder steps one column
    at a time on [A | y] (house_panel_ref's steps) within 1e-12·max|A|:
    the stripes only reassociate."""
    rng = np.random.default_rng(95)
    buf = _t(rng.standard_normal((2, 19, 19 + 5)))
    got = buf.clone()
    taus = hs._stripe_body_ref(got, 19)
    want = buf.clone()
    want_taus = torch.stack([hp.householder_step(want, j)[1]
                             for j in range(19)], -1)
    r_got, r_want = torch.triu(got[:, :, :19]), torch.triu(want[:, :, :19])
    tol = 1e-12 * float(buf.abs().max())
    assert float((r_got - r_want).abs().max()) < tol
    assert float((got[:, :, 19:] - want[:, :, 19:]).abs().max()) < tol
    assert float((taus - want_taus).abs().max()) < 1e-12


def test_cpu_tensors_run_the_plain_versions_and_count_no_launch():
    rng = np.random.default_rng(96)
    a = _t(rng.standard_normal((2, 12, 9)))
    before = (hs.launches, hs.stripe_launches, hp.launches)
    for g, w in zip(hs.house_stripe_t(a), hs.house_stripe_t_ref(a)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    sq = _t(rng.standard_normal((2, 10, 10)))
    y = _t(rng.standard_normal((2, 10, 3)))
    torch.testing.assert_close(hs.qr_gesv(sq, y),
                               hs.qr_gesv_ref(sq, y), rtol=0, atol=0)
    assert (hs.launches, hs.stripe_launches, hp.launches) == before


@pytest.mark.parametrize("call,err,match", [
    (lambda: hs.house_stripe_t(torch.zeros(4, 4)), ValueError, "3-D"),
    (lambda: hs.house_stripe_t(torch.zeros(1, 4, 4, dtype=torch.int64)),
     TypeError, "float32 or float64"),
    (lambda: hs.house_stripe_t(torch.zeros(1, 4, 4, device="meta")),
     ValueError, "no kernel for device"),
    (lambda: hs.qr_gesv(torch.zeros(1, 4, 4), torch.zeros(2, 4, 1)),
     ValueError, "needs a"),
])
def test_wrappers_reject_what_the_kernels_do_not_take(call, err, match):
    with pytest.raises(err, match=match):
        call()


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_cpu_wrappers_take_transposed_views(dtype):
    """A panel or system given as a transposed (non-contiguous) view runs
    as its contiguous copy does, and the outputs are contiguous."""
    rng = np.random.default_rng(97)
    panel = _t(rng.standard_normal((2, 9, 20))).to(dtype).mT
    assert not panel.is_contiguous()
    for g, w in zip(hs.house_stripe_t(panel),
                    hs.house_stripe_t_ref(panel.contiguous())):
        assert g.is_contiguous()
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    a = _t(rng.standard_normal((2, 11, 11))).to(dtype)
    y = _t(rng.standard_normal((2, 3, 11))).to(dtype).mT
    x = hs.qr_gesv(a.mT, y)
    assert x.is_contiguous()
    torch.testing.assert_close(
        x, hs.qr_gesv_ref(a.mT.contiguous(), y.contiguous()), rtol=0, atol=0)


def test_gesv_scratch_puts_the_right_hand_sides_at_a_group():
    a = torch.arange(13 * 13, dtype=torch.float64).reshape(1, 13, 13)
    y = -torch.arange(13 * 3, dtype=torch.float64).reshape(1, 13, 3) - 1
    work = hs._gesv_scratch(a, y)
    assert work.shape == (1, 24, 13)
    torch.testing.assert_close(work[0, :13], a[0].T)
    assert float(work[0, 13:16].abs().max()) == 0.0
    torch.testing.assert_close(work[0, 16:19], y[0].T)
    assert float(work[0, 19:].abs().max()) == 0.0

"""The port's QR slice held against the JAX package on the CPU (its
Pallas kernels in interpret mode): qr_decomp, qr_decomp_full, the blocked
factorisation and Q application over several panels, qr_lstsq,
qr_lstsq_fused on both of its branches, entry.forward, and
convert.vts_from_numpy. Inputs come from numpy with a fixed seed.

R is unique under the Householder sign convention, so R, V, T and Q are
compared directly (and Q also by contract); x is compared directly
within the forward-error bound of the solve."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from nd4js_tpu import la as jla
from nd4js_tpu.la import qr as jqr

from nd4js_tpu_torch import config, convert, entry, la
from nd4js_tpu_torch.la import qr

CPU = "cpu"
# summation order differs between the packages: 1e-10·max|A| in float64,
# 1e-4·max|A| in float32
TOL = {np.float64: 1e-10, np.float32: 1e-4}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def assert_x_close(got, want, a, dtype, y=None):
    """x within TOL·max|A| or, where larger, the forward-error bound
    N·eps·κ₂(A)·max|x| of two backward-stable solves (per system).

    For a square system (``y`` given) also the check that does not loosen
    with κ(A): the backward error ‖A·x − y‖₂/(‖A‖₂·‖x‖₂), worst right-hand
    side, ≤ N·eps and ≤ 8× that of the JAX package's x (floored at eps);
    two Householder solves that round differently stay within 1.4× of each
    other on random systems."""
    n = a.shape[-1]
    a = np.broadcast_to(a, want.shape[:-2] + a.shape[-2:]).astype(np.float64)
    tol = np.maximum(TOL[dtype] * np.abs(a).max(axis=(-2, -1)),
                     n * np.finfo(dtype).eps * np.linalg.cond(a)
                     * np.abs(want).max(axis=(-2, -1)))
    err = np.abs(_np(got) - want).max(axis=(-2, -1))
    assert (err <= tol).all(), (err, tol)
    if y is None:
        return
    y = np.broadcast_to(y, want.shape).astype(np.float64)
    eps = np.finfo(dtype).eps
    norm_a = np.linalg.norm(a, 2, axis=(-2, -1))[..., None]

    def backward(x):
        x = np.asarray(x, np.float64)
        res = np.linalg.norm(a @ x - y, axis=-2)
        return (res / (norm_a * np.linalg.norm(x, axis=-2))).max(-1)

    be, be_want = backward(_np(got)), backward(want)
    assert (be <= np.minimum(n * eps, 8 * np.maximum(be_want, eps))).all(), \
        (be, be_want)


def check_qr_contract(a, q, r, dtype):
    """Reconstruction and orthogonality ≤ 4·eps·max(M, N)."""
    m, n = a.shape[-2:]
    q, r = _np(q).astype(np.float64), _np(r).astype(np.float64)
    eye = np.eye(q.shape[-1])
    orth = np.abs(np.swapaxes(q, -1, -2) @ q - eye).max()
    assert orth <= 4 * np.finfo(dtype).eps * max(m, n)
    assert np.abs(q @ r - a).max() <= 32 * np.finfo(dtype).eps * max(m, n) \
        * max(1.0, np.abs(a).max())
    assert np.abs(np.tril(r, -1)).max(initial=0.0) == 0.0


@pytest.mark.parametrize("shape", [(2, 3, 40, 24), (24, 40), (2, 17, 17)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("full", [False, True])
def test_qr_decomp_matches_jax(shape, dtype, full):
    a = np.random.default_rng(21).standard_normal(shape).astype(dtype)
    jfn, fn = ((jla.qr_decomp_full, la.qr_decomp_full) if full
               else (jla.qr_decomp, la.qr_decomp))
    jq, jr = (np.asarray(v) for v in jfn(a))
    q, r = fn(a, device=CPU)
    assert q.shape == jq.shape and r.shape == jr.shape
    assert q.dtype == config.default_float_for(a.dtype)
    tol = TOL[dtype] * np.abs(a).max()
    np.testing.assert_allclose(r.numpy(), jr, atol=tol)
    np.testing.assert_allclose(q.numpy(), jq, atol=TOL[dtype])
    check_qr_contract(a, q, r, dtype)


@pytest.mark.parametrize("kmax", [None, 24])
def test_blocked_factor_and_q_over_several_panels(kmax):
    """Panels of 16 over a (2, 44, 36) batch: the panel loop, the T
    formation and the trailing GEMM update run three times; with kmax the
    trailing columns are transformed but not factored."""
    a3 = np.random.default_rng(22).standard_normal((2, 44, 36))
    jr, jvts = jqr._qr_factor_batched(a3, panel=16, kmax=kmax)
    r, vts = qr._qr_factor_batched(_t(a3), panel=16, kmax=kmax)
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-12)
    assert [k for k, _, _ in vts] == [k for k, _, _ in jvts]
    for (_, V, T), (_, jV, jT) in zip(vts, jvts):
        np.testing.assert_allclose(V.numpy(), np.asarray(jV), atol=1e-12)
        np.testing.assert_allclose(T.numpy(), np.asarray(jT), atol=1e-12)
    eye = np.broadcast_to(np.eye(44), (2, 44, 44))
    for transpose in (False, True):
        want = np.asarray(jqr._apply_q_batched(jvts, eye, transpose))
        got = qr._apply_q_batched(vts, _t(eye), transpose).numpy()
        np.testing.assert_allclose(got, want, atol=1e-12)


def test_vts_from_numpy_applies_the_jax_factorisation():
    """The JAX package's (k, V, T) list, carried across as numpy arrays,
    gives back the JAX Q through the port's _apply_q_batched."""
    a3 = np.random.default_rng(23).standard_normal((2, 40, 40))
    _, jvts = jqr._qr_factor_batched(a3, panel=16)
    eye = np.broadcast_to(np.eye(40), (2, 40, 40))
    jq = np.asarray(jqr._apply_q_batched(jvts, eye))
    vts = convert.vts_from_numpy(
        [(k, np.asarray(V), np.asarray(T)) for k, V, T in jvts], device=CPU)
    assert all(isinstance(k, int) and V.dtype == torch.float64
               for k, V, _ in vts)
    got = qr._apply_q_batched(vts, _t(eye)).numpy()
    np.testing.assert_allclose(got, jq, atol=1e-13)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_qr_lstsq_broadcasts_like_jax(dtype):
    """Q, R of a (2, 1) batch against y of leading shape (3,), economic
    and full factors."""
    rng = np.random.default_rng(24)
    a = rng.standard_normal((2, 1, 30, 20)).astype(dtype)
    y = rng.standard_normal((3, 30, 2)).astype(dtype)
    for jfn, fn in ((jla.qr_decomp, la.qr_decomp),
                    (jla.qr_decomp_full, la.qr_decomp_full)):
        jq, jr = jfn(a)
        want = np.asarray(jla.qr_lstsq(jq, jr, y))
        q, r = fn(a, device=CPU)
        got = la.qr_lstsq(q, r, _t(y))
        assert got.shape == want.shape == (2, 3, 20, 2)
        assert_x_close(got, want, a, dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_qr_solve_and_fused_square_branch_match_jax(dtype):
    """Square N ≤ 256: qr_lstsq_fused is one qr_gesv (here its plain
    version); qr_solve goes through qr_decomp. y broadcasts over a."""
    rng = np.random.default_rng(25)
    a = rng.standard_normal((2, 24, 24)).astype(dtype)
    y = rng.standard_normal((24, 3)).astype(dtype)
    want = np.asarray(jla.qr_lstsq_fused(a, y))
    got = la.qr_lstsq_fused(a, y, device=CPU)
    assert got.shape == want.shape == (2, 24, 3)
    assert_x_close(got, want, a, dtype, y)
    q, r = la.qr_decomp(a, device=CPU)
    assert_x_close(la.qr_solve(q, r, _t(y)), want, a, dtype, y)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_qr_lstsq_fused_tall_branch_matches_jax(dtype):
    """M > N: the RHS rides the blocked factorisation, then the blocked
    triangular solve."""
    rng = np.random.default_rng(26)
    a = rng.standard_normal((2, 40, 24)).astype(dtype)
    y = rng.standard_normal((2, 40, 3)).astype(dtype)
    want = np.asarray(jla.qr_lstsq_fused(a, y))
    got = la.qr_lstsq_fused(_t(a), _t(y))
    assert got.shape == want.shape == (2, 24, 3) and got.device.type == "cpu"
    np.testing.assert_allclose(got.numpy(), want,
                               atol=TOL[dtype] * np.abs(want).max())


def test_entry_forward_matches_jax():
    """entry.forward against the same composition in the JAX package at a
    small size: x and the residual norms."""
    rng = np.random.default_rng(27)
    a = rng.standard_normal((2, 24, 24))
    y = rng.standard_normal((2, 24, 1))
    jq, jr = jla.qr_decomp(a)
    jx = np.asarray(jla.qr_lstsq(jq, jr, y))
    jres = np.asarray(jla.norm_fro(jla.matmul2(a, jx) - jnp.asarray(y),
                                   axis=(-2, -1)))
    x, res = entry.forward(_t(a), _t(y))
    assert_x_close(x, jx, a, np.float64, y)
    assert res.shape == (2,)
    np.testing.assert_allclose(res.numpy(), jres, atol=1e-10)
    forward, (ea, ey) = entry.entry(device=CPU)
    assert forward is entry.forward
    assert ea.shape == (4, 128, 128) and ey.shape == (4, 128, 1)
    assert ea.dtype == torch.float32


def test_integer_input_promotes_to_float64_like_jax():
    a = np.arange(1, 13).reshape(4, 3) % 5
    jq, jr = jla.qr_decomp(a)
    q, r = la.qr_decomp(a, device=CPU)
    assert str(q.dtype) == f"torch.{np.asarray(jq).dtype.name}"
    np.testing.assert_allclose(r.numpy(), np.asarray(jr), atol=1e-12)


def test_unported_methods_and_bad_shapes_raise():
    a = torch.zeros(4, 4, dtype=torch.float64)
    with pytest.raises(ValueError, match="unknown method"):
        la.qr_decomp(a, method="givens")
    with pytest.raises(ValueError, match="ndim"):
        la.qr_decomp(torch.zeros(4))
    with pytest.raises(ValueError, match="under-determined"):
        la.qr_lstsq_fused(torch.zeros(3, 5), torch.zeros(3, 1))

"""The port's qr_decomp with method "cholqr2" and "auto" held against the
JAX package on the CPU: economic and full, one and two BCGS2 panels, and
an ill-conditioned float32 input on which auto falls back to
Householder. Inputs come from numpy with a fixed seed.

R is unique (CholeskyQR's R has a positive diagonal, Householder's
follows its sign convention), so R is compared directly, to
1e-10·max|A|·max(M, N) in float64 and 1e-4·max|A|·max(M, N) in float32;
Q by the contract (orthogonality ≤ 4·eps·max(M, N), reconstruction)."""
import numpy as np
import pytest
import torch

from nd4js_tpu import la as jla

from nd4js_tpu_torch import la
from nd4js_tpu_torch.la import qr
from tests.test_torch_qr_slice import CPU, TOL, _t, check_qr_contract


@pytest.mark.parametrize("method", ["cholqr2", "auto"])
@pytest.mark.parametrize("shape", [(2, 40, 24), (24, 40), (140, 130)])
@pytest.mark.parametrize("economic", [True, False])
def test_qr_cholqr2_and_auto_match_jax(method, shape, economic):
    """(140, 130) runs two panels (128 and 2): the second is
    orthogonalised against the first (BCGS2)."""
    a = np.random.default_rng(100).standard_normal(shape)
    jf = jla.qr_decomp if economic else jla.qr_decomp_full
    f = la.qr_decomp if economic else la.qr_decomp_full
    jq, jr = jf(a, method=method)
    q, r = f(a, method=method, device=CPU)
    assert q.shape == jq.shape and r.shape == jr.shape
    np.testing.assert_allclose(r.numpy(), np.asarray(jr),
                               atol=TOL[np.float64] * np.abs(a).max()
                               * max(shape[-2:]))
    check_qr_contract(a, q, r, np.float64)


def test_qr_auto_falls_back_to_householder_on_ill_conditioned_float32():
    """κ ≈ 1e6 in float32 is past CholeskyQR2's 1/√eps: auto takes the
    Householder branch, as JAX's does, and meets 4·eps·max(M, N); the
    same matrix in float64 keeps CholeskyQR2."""
    rng = np.random.default_rng(101)
    u, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    v, _ = np.linalg.qr(rng.standard_normal((48, 48)))
    a = (u[:, :48] * np.logspace(0, -6, 48) @ v.T).astype(np.float32)
    before = dict(qr.auto_branches)
    q, r = la.qr_decomp(_t(a), method="auto")
    assert qr.auto_branches == {"cholqr2": before["cholqr2"],
                                "householder": before["householder"] + 1}
    hq, hr = la.qr_decomp(_t(a))
    torch.testing.assert_close(r, hr, rtol=0, atol=0)
    torch.testing.assert_close(q, hq, rtol=0, atol=0)
    jq, jr = jla.qr_decomp(a, method="auto")
    np.testing.assert_allclose(r.numpy(), np.asarray(jr),
                               atol=TOL[np.float32] * np.abs(a).max() * 64)
    eye = np.eye(48)
    orth = np.abs(q.double().numpy().T @ q.double().numpy() - eye).max()
    assert orth <= 4 * np.finfo(np.float32).eps * 64
    la.qr_decomp(_t(a.astype(np.float64)), method="auto")
    assert qr.auto_branches["cholqr2"] == before["cholqr2"] + 1

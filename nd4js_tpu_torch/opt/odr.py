"""Orthogonal distance regression / total least squares, the counterpart
of ``nd4js_tpu/opt/odr.py``:

    min over p, Δx of  Σᵢ ‖Δxᵢ‖² + Σᵢ ‖f(p, xᵢ + Δxᵢ) − yᵢ‖².

Two mechanisms:

  * method='schur' (the default): the structured solver of
    ``_trust_region_tls`` (per-point Schur elimination of the Δx block,
    O(M·NY·(NP + NX)) memory, the λ iteration on an NP×NP system);
  * method='dense': the block Jacobian materialised and handed to the
    generic LM and dogleg drivers, O((M·NX)²) memory, for small M.

``f(p, x)`` is a torch function vectorised over the rows of x, whose rows
are independent. Its Jacobian blocks come from ``torch.func``: ∂f/∂p by
``jacfwd``, ∂f/∂x by NX ``jvp`` passes, each with the tangent e_k at every
point, so one pass gives every point's ∂f/∂x_k. The step's accept or
reject selects with ``torch.where``; ``odr_lm`` reads one flag an
iteration on the host (``lm._drive``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ._trust_region_tls import TlsState, tls_more_lambda_step, tls_state
from ._tree import vdot, where_tree
from .dogleg import lsq_dogleg_gen, lsq_dogleg
from .lm import (lsq_lm_gen, lsq_lm, _DEFAULTS, _drive, _generate,
                 _next_radius)

__all__ = ["odr_lm_gen", "odr_dogleg_gen", "odr_lm", "odr_dogleg",
           "tls_lm_gen", "tls_dogleg_gen", "fit_odr_lm", "fit_odr_dogleg"]


def _odr_setup(x, y, p0, dx0, device):
    """x, y, p0 (and dx0) as tensors of one floating dtype on one device;
    x and y as (M, NX) and (M, NY)."""
    x = as_tensor(x, device)
    y, p0 = as_tensor(y, x.device), as_tensor(p0, x.device)
    dtype = default_float_for(torch.promote_types(
        torch.promote_types(x.dtype, y.dtype), p0.dtype))
    x, y, p0 = x.to(dtype), y.to(dtype), p0.to(dtype)
    x2 = x if x.ndim == 2 else x[:, None]
    y2 = y if y.ndim == 2 else y[:, None]
    if x2.shape[0] != y2.shape[0]:
        raise ValueError("x and y must have the same number of rows")
    dx0 = torch.zeros_like(x2) if dx0 is None \
        else as_tensor(dx0, x.device).to(dtype).reshape(x2.shape)
    return x2, y2, p0, dx0, x.shape


def _jx(apply_f, p, xx2):
    """(M, NY, NX): each point's ∂f/∂x by NX jvp passes."""
    cols = []
    for k in range(xx2.shape[1]):
        tang = torch.zeros_like(xx2)
        tang[:, k] = 1.0
        _, bk = torch.func.jvp(lambda z: apply_f(p, z), (xx2,), (tang,))
        cols.append(bk)                                   # (M, NY)
    return torch.stack(cols, -1)


def _applier(f, M, NY, x_shape):
    def apply_f(p, xx2):
        return f(p, xx2.reshape(x_shape)).reshape(M, NY)
    return apply_f


def _odr_problem(x, y, f, p0, dx0=None, device=None):
    """The dense problem: fJ(u) over u = [p, Δx] with the block Jacobian,
    the start u0, and unpack(u) -> (p, Δx)."""
    x2, y2, p0, dx0, x_shape = _odr_setup(x, y, p0, dx0, device)
    M, NX = x2.shape
    NY = y2.shape[1]
    NP = p0.numel()
    apply_f = _applier(f, M, NY, x_shape)
    eye_m = torch.eye(M, dtype=p0.dtype, device=p0.device)

    def fJ(u):
        p = u[:NP]
        dx = u[NP:].reshape(M, NX)
        xx2 = x2 + dx
        F1 = (apply_f(p, xx2) - y2).reshape(-1)             # (M·NY,)
        Jp = torch.func.jacfwd(lambda q: apply_f(q, xx2))(p) \
            .reshape(M * NY, NP)
        # each point's dy/dx, embedded block-diagonally
        J21 = (eye_m[:, None, :, None] * _jx(apply_f, p, xx2)[:, :, None, :]) \
            .reshape(M * NY, M * NX)
        top = torch.cat([Jp, J21], 1)
        bot = torch.cat([p0.new_zeros((M * NX, NP)),
                         torch.eye(M * NX, dtype=p0.dtype, device=p0.device)],
                        1)
        return torch.cat([F1, dx.reshape(-1)]), torch.cat([top, bot], 0)

    def unpack(u):
        return u[:NP], u[NP:].reshape(x_shape)

    return fJ, torch.cat([p0, dx0.reshape(-1)]), unpack


# ---------------------------------------------------------------------
# the structured (Schur-complement) driver, the default mechanism
# ---------------------------------------------------------------------

class _OdrLMState(NamedTuple):
    st: TlsState
    radius: torch.Tensor
    it: torch.Tensor
    stuck: torch.Tensor
    loss: torch.Tensor


def _odr_blocks(x2, y2, f, x_shape):
    """ev(p, dx) -> (f1, A, B): the residuals and each point's Jacobian
    blocks by forward-mode AD."""
    M = x2.shape[0]
    apply_f = _applier(f, M, y2.shape[1], x_shape)

    def ev(p, dx):
        xx2 = x2 + dx
        f1 = apply_f(p, xx2) - y2
        a = torch.func.jacfwd(lambda q: apply_f(q, xx2))(p)   # (M, NY, NP)
        return f1, a, _jx(apply_f, p, xx2)                     # B (M, NY, NX)

    return ev


def _odr_lm_step(ev, opt, s: _OdrLMState) -> _OdrLMState:
    st = s.st
    dp, ddx = tls_more_lambda_step(st, s.radius)
    p_new = st.p + dp
    dx_new = st.dx + ddx
    f1_new, a_new, b_new = ev(p_new, dx_new)
    loss_new = 0.5 * ((f1_new * f1_new).sum() + (dx_new * dx_new).sum())
    # the model's prediction
    pred1 = st.f1 + torch.einsum("myp,p->my", st.a, dp) \
        + torch.einsum("myx,mx->my", st.b, ddx)
    pred2 = st.dx + ddx
    loss_pred = 0.5 * ((pred1 * pred1).sum() + (pred2 * pred2).sum())
    predicted = s.loss - loss_pred
    actual = s.loss - loss_new
    rho = actual / torch.where(predicted == 0, 1.0, predicted)
    gdx = vdot(st.g_p, dp) + vdot(st.g_dx, ddx)
    denom = 2 * (loss_new - s.loss - gdx)
    shrink = torch.where(denom > 0,
                         -gdx / torch.where(denom == 0, 1.0, denom),
                         opt["shrinkUpper"])
    shrink = torch.clamp(shrink, opt["shrinkLower"], opt["shrinkUpper"])
    dnorm = torch.sqrt(((st.d_p * dp) ** 2).sum()
                       + ((st.d_dx * ddx) ** 2).sum())
    radius = _next_radius(opt, s, rho, dnorm, shrink)
    acc = _OdrLMState(st=tls_state(p_new, dx_new, f1_new, a_new, b_new,
                                   d_prev=(st.d_p, st.d_dx)),
                      radius=radius, it=s.it + 1,
                      stuck=torch.zeros_like(s.stuck), loss=loss_new)
    rej = _OdrLMState(st=st, radius=radius, it=s.it + 1, stuck=s.stuck + 1,
                      loss=s.loss)
    return where_tree((actual > 0) & torch.isfinite(loss_new), acc, rej)


def _odr_init(ev, p0, dx0, opt) -> _OdrLMState:
    f1, a, b = ev(p0, dx0)
    zero = torch.zeros((), dtype=torch.int32, device=p0.device)
    return _OdrLMState(
        st=tls_state(p0, dx0, f1, a, b),
        radius=torch.tensor(opt["r0"], dtype=p0.dtype, device=p0.device),
        it=zero, stuck=zero,
        loss=0.5 * ((f1 * f1).sum() + (dx0 * dx0).sum()))


def _odr_report(s: _OdrLMState, x_shape):
    m = s.st.f1.numel() + s.st.dx.numel()
    g = torch.cat([s.st.g_p, s.st.g_dx.reshape(-1)])
    return (s.st.p, s.st.dx.reshape(x_shape)), 2 * s.loss / m, 2 * g / m


def _schur(x, y, f, p0, dx0, device, options):
    x2, y2, p0, dx0, x_shape = _odr_setup(x, y, p0, dx0, device)
    opt = {**_DEFAULTS, **options}
    ev = _odr_blocks(x2, y2, f, x_shape)
    return (functools.partial(_odr_lm_step, ev, opt),
            _odr_init(ev, p0, dx0, opt), opt, x_shape)


def odr_lm_gen(x, y, f, p0, dx0=None, method: str = "schur", device=None,
               **options):
    """ODR fit by trust-region LM: yields ((p, Δx), mse, ∇mse) per
    iteration; raises OptimizationNoProgressError past stuckLimit rejected
    steps. ``f(p, x)`` is vectorised over the rows of x. method='schur'
    (the default) uses the structured Δx-eliminated solver, 'dense' the
    block Jacobian. Array-likes go to ``device`` (default
    ``config.default_device``)."""
    if method == "dense":
        fJ, u0, unpack = _odr_problem(x, y, f, p0, dx0, device)
        for u, mse, g in lsq_lm_gen(fJ, u0, **options):
            yield unpack(u), mse, g
        return
    if method != "schur":
        raise ValueError(f"unknown method {method!r}")
    step, s, opt, x_shape = _schur(x, y, f, p0, dx0, device, options)
    for s in _generate(step, s, opt["stuckLimit"], lambda s: s.st.p):
        yield _odr_report(s, x_shape)


def odr_dogleg_gen(x, y, f, p0, dx0=None, device=None, **options):
    """ODR fit by dogleg: the dense block Jacobian through the generic
    dogleg driver."""
    fJ, u0, unpack = _odr_problem(x, y, f, p0, dx0, device)
    for u, mse, g in lsq_dogleg_gen(fJ, u0, **options):
        yield unpack(u), mse, g


def odr_lm(x, y, f, p0, dx0=None, method: str = "schur",
           gtol: float = 1e-8, max_iter: int = 200, device=None, **options):
    """ODR fit by LM until max|g| ≤ gtol, ``max_iter`` iterations or more
    than stuckLimit rejected steps in a row. Returns ((p, Δx), mse, ∇mse,
    n_iter)."""
    if method == "dense":
        fJ, u0, unpack = _odr_problem(x, y, f, p0, dx0, device)
        u, mse, g, it = lsq_lm(fJ, u0, gtol=gtol, max_iter=max_iter,
                               **options)
        return unpack(u), mse, g, it
    if method != "schur":
        raise ValueError(f"unknown method {method!r}")
    step, s, opt, x_shape = _schur(x, y, f, p0, dx0, device, options)

    def cond(s):
        g = torch.maximum(s.st.g_p.abs().max(), s.st.g_dx.abs().max())
        return (s.it < max_iter) & (g > gtol) \
            & (s.stuck <= opt["stuckLimit"])

    s = _drive(step, s, cond)
    (p, dx), mse, g = _odr_report(s, x_shape)
    return (p, dx), mse, g, s.it


def odr_dogleg(x, y, f, p0, dx0=None, device=None, **kw):
    """ODR fit by dogleg (the dense path). Returns ((p, Δx), mse, ∇mse,
    n_iter)."""
    fJ, u0, unpack = _odr_problem(x, y, f, p0, dx0, device)
    u, mse, g, it = lsq_dogleg(fJ, u0, **kw)
    return unpack(u), mse, g, it


# the reference's TLS fronts share the ODR solver
tls_lm_gen = odr_lm_gen
tls_dogleg_gen = odr_dogleg_gen
fit_odr_lm = odr_lm
fit_odr_dogleg = odr_dogleg

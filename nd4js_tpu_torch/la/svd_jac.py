"""One-sided (Hestenes) Jacobi SVD, the counterpart of the batched path
of ``nd4js_tpu/la/svd_jac.py``.

Each sweep is one call of the ``jacobi_sweeps`` kernel, which rotates all
n − 1 rounds of Brent-Luk pairs of W = A (V accumulates the rotations);
between sweeps one host-side check of the batch's largest off-diagonal
measure against Demmel's eps·N decides whether another runs (at most
``max_sweeps``). Inputs are pre-reduced by Householder QR and the
iteration runs on Rᵀ; wide inputs are transposed first. An odd N gets a
zero pad column, which no rotation mixes in and which sorts last. Columns
whose singular value is zero leave U undefined: the matrices that have
one get U completed to an orthonormal basis by a Householder QR.

Returns (U, sv, V) with A = U·diag(sv)·V (V is what NumPy calls Vᵀ).
``_rotation`` and ``_brent_luk_shuffle`` serve ``svd_gram``'s finishing
sweeps (and the shuffle ``svd_block_jac``'s inner sweeps);
``_rectangular`` and ``_svd_entry`` the entry points of the other SVD
modules. The wrappers ``svd_jac_classic``, ``svd_jac_2sided`` and
``svd_jac_2sided_blocked`` name the other Jacobi mechanisms
(``svd_classic``, ``svd_kogbetliantz``, ``svd_block_jac``). The JAX
package's XLA-only paths (``_jacobi_core``, ``_svd_square``,
``_svd_1sided_core``, ``_svd_jac_1sided_xla``), which nothing there calls,
are not ported.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core.mm import mm, mt
from ..ops.jacobi_sweep import _shuffle as _brent_luk_shuffle  # noqa: F401
from ..ops.jacobi_sweep import jacobi_sweeps
from .qr import _qr_house_flat

__all__ = ["svd_jac_1sided", "svd_jac_classic", "svd_jac_2sided",
           "svd_jac_2sided_blocked"]


def _rotation(app, aqq, apq, eps):
    """Stable rotation (c, s) diagonalising [[app, apq], [apq, aqq]]
    (``nd4js_tpu/la/svd_jac.py:45-54``)."""
    tiny = torch.finfo(apq.dtype).tiny
    small = apq.abs() <= eps * torch.sqrt(app * aqq) * 0.01 + tiny
    safe_apq = torch.where(small, 1.0, apq)
    tau = (aqq - app) / (2 * safe_apq)
    t = torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau))
    t = torch.where(tau == 0, 1.0, t)       # 45° when app == aqq
    t = torch.where(small, 0.0, t)
    c = torch.rsqrt(1 + t * t)
    return c, t * c


def _descending(x):
    """Stable descending order along the last axis, as ``jnp.argsort(-x)``.
    The key is 0 − x, not −x: −x of a zero is −0, which a radix sort (the
    card's) orders before +0 where a comparison sort ties them."""
    return torch.sort(0.0 - x, dim=-1, stable=True).indices


def _complete_u(u, sv, tol_rank, force=False):
    """Orthonormal completion of the U columns with sv ≈ 0, per matrix
    (``nd4js_tpu/la/svd_jac.py:112-125`` under ``vmap``): the matrices
    whose smallest sv is ≤ their ``tol_rank``, or whose ``force`` (a bool,
    or one a matrix) is set, get U from a Householder QR of it, signs
    fixed by R's diagonal; the others keep theirs. One host sync."""
    need = torch.nonzero((sv.amin(-1) <= tol_rank) | torch.as_tensor(
        force, device=sv.device)).squeeze(1)
    if need.numel() == 0:
        return u
    q, r = _qr_house_flat(u[need], True)
    d = torch.diagonal(r, dim1=-2, dim2=-1)
    u = u.clone()
    u[need] = q * torch.where(d < 0, -1.0, 1.0)[:, None, :]
    return u


def _svd_square_batched(a3, max_sweeps: int):
    """Jacobi SVD of a square batch (Bn, N, N) through the kernel, one
    launch per sweep, until the batch's largest off measure is ≤ eps·N
    (``nd4js_tpu/la/svd_jac.py:165-204``)."""
    Bn, N, _ = a3.shape
    eps = torch.finfo(a3.dtype).eps
    pad = N % 2
    w = a3
    if pad:
        w = torch.cat([w, a3.new_zeros((Bn, N, 1))], -1)
    n2 = N + pad
    v = torch.eye(n2, dtype=a3.dtype, device=a3.device).expand(Bn, n2, n2)
    tol = eps * N
    for _ in range(max_sweeps):
        w, v, off = jacobi_sweeps(w, v, 1)
        # NaN-safe: a non-finite off measure is not converged
        if bool(off.max() <= tol):
            break
    sv = torch.sqrt((w * w).sum(1))
    order = _descending(sv)[..., :N]
    sv = torch.gather(sv, 1, order)
    w = torch.gather(w, 2, order[:, None, :].expand(Bn, N, N))
    v = torch.gather(v, 2, order[:, None, :].expand(Bn, n2, N))[:, :N, :]
    safe = torch.where(sv > 0, sv, 1.0)
    u = _complete_u(w / safe[:, None, :], sv, eps * N * sv.amax(-1))
    return u, sv, mt(v)


def _svd_jac_flat(a3, max_sweeps: int):
    M, N = a3.shape[-2:]
    if M < N:
        u, sv, v = _svd_jac_flat(mt(a3), max_sweeps)
        return mt(v), sv, mt(u)
    # pre-QR, then Jacobi on Rᵀ: Rᵀ = u·Σ·v ⇒ A = Q·R = (Q·vᵀ)·Σ·uᵀ
    q, r = _qr_house_flat(a3, True)
    u, sv, v = _svd_square_batched(mt(r), max_sweeps)
    return mm(q, mt(v)), sv, mt(u)


def _rectangular(a3, square):
    """(U, sv, V) of a flat batch (B, M, N) from ``square``, an SVD of
    square batches: a wide batch transposed, a tall one reduced by
    Householder QR first (``house_panel`` on the card), as the reference's
    Jacobi drivers do."""
    M, N = a3.shape[-2:]
    if M < N:
        u, sv, v = _rectangular(mt(a3), square)
        return mt(v), sv, mt(u)
    if M > N:
        q, r = _qr_house_flat(a3, True)
        u, sv, v = square(r)
        return mm(q, u), sv, v
    return square(a3)


def _svd_entry(a, flat, device):
    """An SVD entry point: ``a`` to ``device`` and a floating dtype, its
    leading dims flattened into one batch axis for ``flat`` (B, M, N) →
    (U, sv, V), and restored on the outputs."""
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.ndim < 2:
        raise ValueError("svd expects ndim >= 2")
    lead = a.shape[:-2]
    M, N = a.shape[-2:]
    u, sv, v = flat(a.reshape((max(1, math.prod(lead)), M, N)))
    K = min(M, N)
    return (u.reshape(lead + (M, K)), sv.reshape(lead + (K,)),
            v.reshape(lead + (K, N)))


def svd_jac_1sided(a, max_sweeps: int = 24, device=None):
    """One-sided Jacobi SVD (see the module docstring). Batched over
    leading dims. Returns (U (..., M, K), sv (..., K), V (..., K, N)) with
    A = U·diag(sv)·V, K = min(M, N). An array-like ``a`` goes to
    ``device`` (default ``config.default_device``)."""
    return _svd_entry(a, lambda a3: _svd_jac_flat(a3, max_sweeps), device)


# The reference's Jacobi variants, each with its own mechanism: one-sided
# Brent-Luk (above), greedy max-pivot classic (svd_classic), sequential
# row-cyclic two-sided Kogbetliantz (svd_kogbetliantz) and the block
# variant (svd_block_jac), as in nd4js_tpu/la/svd_jac.py:249-281. Their
# modules import this one, so the wrappers import them when called.
def svd_jac_classic(a, max_sweeps: int = 60, device=None):
    """Classic two-sided Jacobi with the greedy largest-off-diagonal pivot
    (``svd_classic.svd_jac_classic_greedy``): sequential, one rotation a
    step, kept for mechanism parity."""
    from .svd_classic import svd_jac_classic_greedy
    return svd_jac_classic_greedy(a, max_sweeps=max_sweeps, device=device)


def svd_jac_2sided(a, max_sweeps: int = 30, device=None):
    """Cyclic two-sided Jacobi, Kogbetliantz's row-cyclic sweeps
    (``svd_kogbetliantz.svd_kogbetliantz``): sequential, one pair a step."""
    from .svd_kogbetliantz import svd_kogbetliantz
    return svd_kogbetliantz(a, max_sweeps=max_sweeps, device=device)


def svd_jac_2sided_blocked(a, device=None, **kw):
    """The block Jacobi SVD (``svd_block_jac.svd_jac_blocked``); keywords
    pass through."""
    from .svd_block_jac import svd_jac_blocked
    return svd_jac_blocked(a, device=device, **kw)

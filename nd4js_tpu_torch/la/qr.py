"""QR decomposition and least squares, the counterpart of
``nd4js_tpu/la/qr.py``: blocked Householder with compact-WY
aggregation, CholeskyQR2 panels (``method="cholqr2"``), and the
condition-adaptive ``method="auto"`` that takes CholeskyQR2 and falls
back to Householder when its orthogonality defect is over the contract.

    per panel of width b:
      R_panel, V, taus = house_panel(A[k:, k:k+b])         (CUDA kernel)
      T (b×b upper)     = (diag(1/τ) + striu(VᵀV))⁻¹        (GEMMs)
      A[k:, k+b:]      -= V·Tᵀ·Vᵀ·A[k:, k+b:]              (3 GEMMs)
    Q = (I−V₁T₁V₁ᵀ)···(I−VₚTₚVₚᵀ) applied to I in reverse   (GEMMs)

Square systems up to 256² in ``qr_lstsq_fused`` are one launch of the
``qr_gesv`` kernel. The GEMMs are ``torch.matmul`` at full precision.

``_qr_core`` is the single-matrix QR that the optimisers and the strong
rank-revealing QR call (``nd4js_tpu/la/qr.py:40-141``): an unblocked
Householder panel in plain tensor code (a Python loop over columns where
the JAX package has a ``fori_loop``), the compact-WY T by its column
recurrence, and the same blocked trailing updates. The JAX package builds
it in XLA, not with a kernel, and so does the port.
"""
from __future__ import annotations

import math

import torch

from .. import config
from ..config import default_float_for
from ..convert import as_tensor
from ..core.batch import batched
from ..core.debug import dassert, dcheck_finite
from ..core.mm import mm, mt
from ..ops.house_panel import house_panel
from ..ops.house_stripe import qr_gesv
from .cholesky import _chol_inv_core
from .tri import _tril_inv_core, _triu_solve, _triu_solve_blocked

__all__ = ["qr_decomp", "qr_decomp_full", "qr_lstsq", "qr_solve",
           "qr_lstsq_fused"]

_PANEL = 128

# How often ``method="auto"`` kept CholeskyQR2 and how often it fell back
# to Householder, since the last reset: one count per call, as the
# decision is one for the whole batch.
auto_branches = {"cholqr2": 0, "householder": 0}


def _householder_panel(p: torch.Tensor):
    """Unblocked Householder QR of one panel ``p`` (m, b), m >= b.

    Returns (V, taus, R_panel): V (m, b) unit-diagonal reflectors (zeros
    above the diagonal), taus (b,), and the transformed panel whose top
    b rows are the triangular factor.
    """
    m, b = p.shape
    rows = torch.arange(m, device=p.device)
    cols = torch.arange(b, device=p.device)
    V = torch.zeros_like(p)
    taus = p.new_zeros((b,))
    for j in range(b):
        x = p[:, j]
        x0 = x[j]
        sigma = torch.where(rows > j, x * x, 0.0).sum()
        nrm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -nrm, nrm)
        denom = x0 - beta
        safe_den = torch.where(denom == 0, 1.0, denom)
        v = torch.where(rows > j, x / safe_den, 0.0)
        v = torch.where(rows == j, 1.0, v)
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(nrm == 0, 0.0, (beta - x0) / safe_beta)
        # apply H = I − tau·v·vᵀ to the remaining panel columns
        w = torch.where(cols > j, tau * mm(v[None], p)[0], 0.0)
        p = p - v[:, None] * w[None, :]
        # column j becomes beta·e_j (R part); rows above j keep R values
        newc = torch.where(rows == j, beta, 0.0)
        newc = torch.where(rows < j, p[:, j], newc)
        p = torch.cat([p[:, :j], newc[:, None], p[:, j + 1:]], 1)
        V[:, j] = v
        taus[j] = tau
    return V, taus, p


def _form_t(V: torch.Tensor, taus: torch.Tensor) -> torch.Tensor:
    """Compact-WY T factor of one reflector store (m, b):
    H_1···H_b = I − V·T·Vᵀ, T upper triangular, by the column recurrence
    T[:j, j] = −τ_j·T·(VᵀV)[:, j]."""
    b = V.shape[1]
    W = mm(mt(V), V)                                    # (b, b) Gram
    cols = torch.arange(b, device=V.device)
    T = V.new_zeros((b, b))
    for j in range(b):
        col = -taus[j] * mm(T, W[:, j, None])[:, 0]
        col = torch.where(cols < j, col, 0.0)
        T[:, j] = torch.where(cols == j, taus[j], col)
    return T


def _qr_factor(a: torch.Tensor, panel: int = _PANEL):
    """Blocked factorisation of one matrix (M, N). Returns
    (R_packed, [(k, V, T), ...])."""
    M, N = a.shape
    K = min(M, N)
    vts = []
    for k in range(0, K, panel):
        b = min(panel, K - k)
        V, taus, pdone = _householder_panel(a[k:, k:k + b])
        T = _form_t(V, taus)
        vts.append((k, V, T))
        trail = a[k:, k + b:]
        if k + b < N:
            trail = trail - mm(V, mm(mt(T), mm(mt(V), trail)))
        a = torch.cat([a[:k], torch.cat([a[k:, :k], pdone, trail], 1)], 0)
    return a, vts


def _apply_q(vts, B: torch.Tensor, transpose: bool = False) -> torch.Tensor:
    """B ← Q·B (or Qᵀ·B) for one matrix. Q = Π_i (I − V_i·T_i·V_iᵀ),
    panels applied in reverse for Q, forward for Qᵀ."""
    order = vts if transpose else list(reversed(vts))
    for k, V, T in order:
        sub = B[k:, :]
        w = mm(mt(V), sub)
        w = mm(mt(T), w) if transpose else mm(T, w)
        B = torch.cat([B[:k], sub - mm(V, w)], 0)
    return B


def _qr_core(a: torch.Tensor, economic: bool):
    """Householder QR of one matrix (M, N): Q (M, K or M), R (K or M, N)."""
    M, N = a.shape
    K = min(M, N)
    r, vts = _qr_factor(a)
    ncols = K if economic else M
    q = _apply_q(vts, torch.eye(M, ncols, dtype=a.dtype, device=a.device))
    r = torch.triu(r[:K] if economic else r)
    return q, r


def _form_t_batched(V: torch.Tensor, taus: torch.Tensor):
    """Compact-WY T for batched reflector stores (..., M, b) by the
    closed form T = (diag(1/τ) + striu(VᵀV))⁻¹, for the forward product
    H_0···H_{b−1} = I − V·T·Vᵀ. Null reflectors (τ = 0) are masked out
    of V, which zeroes their T coupling.

    Returns (V_masked, T); use V_masked for all V·T·Vᵀ applications.
    """
    b = V.shape[-1]
    live = taus != 0
    V = V * live[..., None, :].to(V.dtype)
    W = mm(mt(V), V)
    inv_tau = torch.where(live, 1.0 / torch.where(live, taus,
                                                  torch.ones_like(taus)),
                          torch.ones_like(taus))
    eye = torch.eye(b, dtype=V.dtype, device=V.device)
    U = torch.triu(W, 1) + inv_tau[..., None, :] * eye
    # upper-triangular inverse via the reversed lower-triangular one
    T = _tril_inv_core(U.flip(-2, -1)).flip(-2, -1)
    return V, T


def _qr_factor_batched(a3: torch.Tensor, panel: int = _PANEL, kmax=None):
    """Blocked Householder factorisation of (Bn, M, N) with the
    ``house_panel`` kernel. Returns (R_packed, [(k, V, T), ...]).
    ``kmax`` limits the factored columns (trailing columns are still
    transformed: the seam of ``qr_lstsq_fused``). Works in place on a
    copy of ``a3``."""
    a3 = a3.clone()
    Bn, M, N = a3.shape
    K = min(M, N) if kmax is None else kmax
    vts = []
    for k in range(0, K, panel):
        b = min(panel, K - k)
        rpan, V, taus = house_panel(a3[:, k:, k:k + b].contiguous())
        V, T = _form_t_batched(V, taus)
        vts.append((k, V, T))
        a3[:, k:, k:k + b] = rpan
        if k + b < N:
            trail = a3[:, k:, k + b:]
            trail -= mm(V, mm(mt(T), mm(mt(V), trail)))
    return a3, vts


def _apply_q_batched(vts, Bmat: torch.Tensor, transpose: bool = False):
    """Q·B (or Qᵀ·B) for Q = Π_i (I − V_i·T_i·V_iᵀ): panels applied in
    reverse for Q, forward for Qᵀ. Works in place on a copy of B."""
    Bmat = Bmat.clone()
    order = vts if transpose else list(reversed(vts))
    for k, V, T in order:
        sub = Bmat[:, k:, :]
        w = mm(mt(V), sub)
        w = mm(mt(T), w) if transpose else mm(T, w)
        sub -= mm(V, w)
    return Bmat


def _qr_house_flat(a3: torch.Tensor, economic: bool):
    """Householder QR of a flat (B, M, N) batch -> (Q3, R3)."""
    Bn, M, N = a3.shape
    K = min(M, N)
    r, vts = _qr_factor_batched(a3)
    ncols = K if economic else M
    eye = torch.eye(M, ncols, dtype=a3.dtype, device=a3.device)
    q = _apply_q_batched(vts, eye.expand(Bn, M, ncols))
    r = torch.triu(r[:, :K] if economic else r)
    return q, r


def _cholqr2_panel(p: torch.Tensor, q_prev):
    """Orthogonalise a flat-batched panel ``p`` (B, M, b) against q_prev
    (BCGS2) and internally (CholeskyQR2; the panel Cholesky carries its
    inverse, so the whitening is a GEMM). Returns (q_new, r_top, r_diag)
    (``nd4js_tpu/la/qr.py:144-176``)."""
    finfo = torch.finfo(p.dtype)
    b = p.shape[-1]
    eye = torch.eye(b, dtype=p.dtype, device=p.device)

    def cholqr(p):
        g = mm(mt(p), p)
        # a tiny diagonal shift keeps the Cholesky alive on nearly rank-
        # deficient panels; Q·R == P holds by construction all the same
        tr = torch.diagonal(g, dim1=-2, dim2=-1).sum(-1)[..., None, None]
        shift = 10 * finfo.eps * tr / b + finfo.tiny
        l, linv = _chol_inv_core(g + shift * eye)
        return mm(p, mt(linv)), mt(l)

    s1 = None
    if q_prev is not None:
        s1 = mm(mt(q_prev), p)
        p = p - mm(q_prev, s1)
    q1, r1 = cholqr(p)
    if q_prev is not None:
        s2 = mm(mt(q_prev), q1)
        q1 = q1 - mm(q_prev, s2)
    q2, r2 = cholqr(q1)
    r_diag = mm(r2, r1)
    r_top = None if s1 is None else s1 + mm(s2, r1)
    return q2, r_top, r_diag


def _qr_cholqr2_flat(a3: torch.Tensor, economic: bool):
    """All-GEMM QR of a flat (B, M, N) batch: blocked classical
    Gram-Schmidt with reorthogonalisation (BCGS2) over CholeskyQR2
    panels of 128 (``nd4js_tpu/la/qr.py:179-214``). Orthogonality holds
    for κ(A) ≲ 1/√eps; Householder stays the robust default."""
    B, M, N = a3.shape
    K = min(M, N)
    q_panels, r_cols = [], []
    q = None
    for k in range(0, K, _PANEL):
        b = min(_PANEL, K - k)
        qk, r_top, r_diag = _cholqr2_panel(a3[:, :, k:k + b], q)
        block = [r_diag] if r_top is None else [r_top, r_diag]
        if K - (k + b) > 0:
            block.append(a3.new_zeros((B, K - k - b, b)))
        r_cols.append(torch.cat(block, dim=1))
        q_panels.append(qk)
        q = torch.cat(q_panels, dim=2)
    r = torch.cat(r_cols, dim=2)
    if N > K:
        r = torch.cat([r, mm(mt(q), a3[:, :, K:])], dim=2)
    if not economic:
        # extend Q to a full orthogonal basis by orthogonalising the
        # identity's columns K..M−1 against it (only when M > K)
        if M > K:
            extra = torch.eye(M, dtype=a3.dtype,
                              device=a3.device)[:, K:].expand(B, M, M - K)
            qe, _, _ = _cholqr2_panel(extra, q)
            q = torch.cat([q, qe], dim=2)
        r = torch.cat([r, a3.new_zeros((B, M - K, N))], dim=1)
    return q, torch.triu(r)


def _qr_auto_flat(a3: torch.Tensor, economic: bool):
    """Condition-adaptive QR of a flat (B, M, N) batch
    (``nd4js_tpu/la/qr.py:312-331``): CholeskyQR2, then its orthogonality
    defect max|QᵀQ − I| over the WHOLE batch; above the contract
    4·eps·max(M, N) (or NaN) the whole batch is redone by Householder.
    JAX's ``lax.cond`` on that scalar is one host-side ``if`` here, at
    the cost of one synchronisation."""
    Bn, M, N = a3.shape
    qf, rf = _qr_cholqr2_flat(a3, economic)
    eye = torch.eye(qf.shape[-1], dtype=a3.dtype, device=a3.device)
    defect = (mm(mt(qf), qf) - eye).abs().max()
    tol = 4 * torch.finfo(a3.dtype).eps * max(M, N)
    if bool(defect <= tol):
        auto_branches["cholqr2"] += 1
        return qf, rf
    auto_branches["householder"] += 1
    return _qr_house_flat(a3, economic)


_FLAT_METHODS = {"householder": _qr_house_flat, "cholqr2": _qr_cholqr2_flat,
                 "auto": _qr_auto_flat}


def _qr_public(a, economic: bool, method: str, device):
    a = as_tensor(a, device)
    a = a.to(default_float_for(a.dtype))
    if a.ndim < 2:
        raise ValueError("qr_decomp expects ndim >= 2")
    if method not in _FLAT_METHODS:
        raise ValueError(f"unknown method {method!r}")
    lead = a.shape[:-2]
    M, N = a.shape[-2:]
    a3 = a.reshape((max(1, math.prod(lead)), M, N))
    q, r = _FLAT_METHODS[method](a3, economic)
    return (q.reshape(lead + q.shape[-2:]),
            r.reshape(lead + (r.shape[-2], N)))


def _qr_debug_guard(q, r):
    """debug_checks guards: finite outputs and an orthogonality check."""
    if not config.debug_checks:
        return
    dcheck_finite((q, r), "qr_decomp (q, r)")
    ncols = q.shape[-1]
    eye = torch.eye(ncols, dtype=q.dtype, device=q.device)
    defect = (mm(mt(q), q) - eye).abs().max()
    tol = 64 * torch.finfo(q.dtype).eps * max(q.shape[-2], ncols)
    dassert(defect <= tol, "qr_decomp: Q orthogonality defect")


def qr_decomp(a, method: str = "householder", device=None):
    """Economic QR: A = Q·R, Q (..., M, K), R (..., K, N), K = min(M, N).
    Batched over leading dims. ``method`` is 'householder' (the
    default), 'cholqr2' (all GEMMs and ``chol_leaf``; orthogonal for
    κ(A) ≲ 1/√eps) or 'auto' (CholeskyQR2, redone by Householder when
    its orthogonality defect exceeds 4·eps·max(M, N)). An array-like
    ``a`` goes to ``device`` (default ``config.default_device``)."""
    q, r = _qr_public(a, economic=True, method=method, device=device)
    _qr_debug_guard(q, r)
    return q, r


def qr_decomp_full(a, method: str = "householder", device=None):
    """Full QR: Q (..., M, M), R (..., M, N)."""
    return _qr_public(a, economic=False, method=method, device=device)


def qr_lstsq(q, r, y, device=None):
    """Least-squares solve from a QR factorisation: x = R⁻¹·Qᵀ·y.
    Accepts economic or full Q/R; for full, only the leading K
    columns/rows take part. Leading dims broadcast."""
    q, r, y = (as_tensor(t, device) for t in (q, r, y))
    k = min(r.shape[-2], r.shape[-1])

    @batched((2, 2, 2))
    def _go(q, r, y):
        qty = mm(mt(q[..., :k]), y.to(q.dtype))
        return _triu_solve.core(r[..., :k, :k], qty, "block")

    return _go(q, r, y)


def qr_solve(q, r, y, device=None):
    """Exact-solve alias of :func:`qr_lstsq` for square systems."""
    return qr_lstsq(q, r, y, device=device)


def qr_lstsq_fused(a, y, device=None):
    """Least-squares solve x = argmin‖A·x − y‖ without forming Q: the
    RHS rides through the Householder factorisation as appended columns,
    then one blocked triangular solve. Square systems up to 256² are one
    launch of the ``qr_gesv`` kernel. Requires M ≥ N; batched over
    leading dims."""
    a, y = as_tensor(a, device), as_tensor(y, device)
    a = a.to(default_float_for(a.dtype))
    y = y.to(a.dtype)
    M, N = a.shape[-2:]
    if M < N:
        raise ValueError("qr_lstsq_fused: under-determined systems not "
                         "supported; use rrqr_lstsq or urv_lstsq")
    L = y.shape[-1]
    lead = tuple(torch.broadcast_shapes(a.shape[:-2], y.shape[:-2]))
    Bn = max(1, math.prod(lead))
    a = a.expand(lead + (M, N)).reshape((Bn, M, N))
    y = y.expand(lead + (M, L)).reshape((Bn, M, L))
    if M == N and N <= 256:
        x = qr_gesv(a.contiguous(), y.contiguous())
        dcheck_finite(x, "qr_lstsq_fused x")
        return x.reshape(lead + (N, L))
    r, _ = _qr_factor_batched(torch.cat([a, y], dim=-1), kmax=N)
    x = _triu_solve_blocked(torch.triu(r[:, :N, :N]), r[:, :N, N:])
    return x.reshape(lead + (N, L))

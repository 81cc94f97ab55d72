"""Divide-and-conquer symmetric tridiagonal eigensolver, the counterpart
of ``nd4js_tpu/la/tridiag_dc.py``.

Cuppen's split T = diag(T₁, T₂) + β·v·vᵀ recurses over halves; each
merge solves all n secular roots at once by a fixed count of bisections
in shifted coordinates (34 halvings in float32, 60 in float64), refines
ẑ by the Gu-Eisenstat product formula so the eigenvectors stay
orthogonal without data-dependent deflation, separates duplicate dᵢ by
an eps-scale jitter, and back-transforms with one GEMM per merge. Leaves
of 16 are solved by ``eigh_jacobi``.

Every function works on a batch axis G of independent problems (where
the JAX package used ``vmap``): the level-batched solver flattens the
caller's batch and a level's P merges into that one axis, so ``neg``,
``rho`` and ``trivial`` are per merge. Sorts are stable, as
``jnp.argsort`` is: equal eigenvalues are real here.
"""
from __future__ import annotations

import torch

from ..convert import as_tensor
from ..config import default_float_for
from ..core.batch import batched
from ..core.mm import mm

__all__ = ["tridiag_eigh_dc"]

_BASE = 16


def _dense_tridiag(d, e):
    """(G, n) diagonal and (G, n − 1) off-diagonal → (G, n, n)."""
    t = torch.diag_embed(d)
    if d.shape[-1] > 1:
        t = t + torch.diag_embed(e, 1) + torch.diag_embed(e, -1)
    return t


def _base_eigh(d, e):
    from .eigh import eigh_jacobi   # handles odd sizes by padding
    return eigh_jacobi(_dense_tridiag(d, e))


def _take(x, idx):
    """x[g, idx[g, i]] along the last axis."""
    return torch.gather(x, -1, idx)


def _secular_roots_shifted(dd, z2, rho, iters: int | None = None):
    """All roots of f(λ) = 1 + ρ·Σ z²ᵢ/(dᵢ − λ) for a batch (G, n) of
    sorted poles, in shifted coordinates: root r is returned as
    μᵣ = λᵣ − ddᵣ ∈ (0, hiᵣ), which avoids the cancellation of dⱼ − λ
    near a pole (``nd4js_tpu/la/tridiag_dc.py:53-88``). Fixed-count
    bisection sized to the mantissa: 60 halvings in float64, 34 in
    float32."""
    if iters is None:
        iters = 60 if torch.finfo(dd.dtype).bits > 32 else 34
    tiny = torch.finfo(dd.dtype).tiny
    zsum = z2.sum(dim=-1)
    # delta[g, r, j] = dd_j − dd_r  (exact fp subtraction)
    delta = dd[:, None, :] - dd[:, :, None]
    gap = torch.cat([dd[:, 1:] - dd[:, :-1], (rho * zsum)[:, None]], dim=-1)
    rho_c = rho[:, None]
    z2r = z2[:, None, :]

    def f(mu):
        # f_r(μ) = 1 + ρ Σ_j z²_j / (delta[r, j] − μ_r)
        den = delta - mu[:, :, None]
        safe = torch.where(den == 0, tiny, den)
        return 1 + rho_c * (z2r / safe).sum(dim=-1)

    lo = torch.zeros_like(dd)
    hi = gap
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = f(mid) < 0
        # f is increasing in μ between the poles: move lo while f < 0
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def _merge(w1, v1, w2, v2, beta):
    """Combine the eigensystems of G pairs of halves, w1 (G, n1), v1
    (G, n1, n1), w2 (G, n2), v2 (G, n2, n2), through the rank-one update
    diag(D) + β·z·zᵀ, β (G,) (``nd4js_tpu/la/tridiag_dc.py:91-167``)."""
    dtype = w1.dtype
    n1 = w1.shape[-1]
    n = n1 + w2.shape[-1]
    eps = torch.finfo(dtype).eps
    tiny = torch.finfo(dtype).tiny
    z = torch.cat([v1[:, -1, :], v2[:, 0, :]], dim=-1)
    d = torch.cat([w1, w2], dim=-1)
    rho = beta
    # β may be negative: solve for −T and negate back
    neg = (rho < 0)[:, None]
    d_s = torch.where(neg, -d, d)
    rho_s = torch.abs(rho) + tiny
    order = torch.argsort(d_s, dim=-1, stable=True)
    dd = _take(d_s, order)
    zz = _take(z, order)
    # eps-jitter duplicate diagonal entries (static-shape deflation)
    zsq = (z * z).sum(dim=-1)
    scale = (torch.maximum(dd.abs().amax(dim=-1), rho_s * zsq) + tiny)[:, None]
    gap = torch.diff(dd, dim=-1)
    bump = torch.where(gap < 8 * eps * scale, 8 * eps * scale - gap, 0.0)
    dd = dd + torch.cat([torch.zeros_like(dd[:, :1]),
                         torch.cumsum(bump, dim=-1)], dim=-1)
    z2 = zz * zz + (eps * scale) ** 2 / n   # the floor keeps intervals alive
    mu = _secular_roots_shifted(dd, z2, rho_s)
    lam = dd + mu
    # Gu-Eisenstat ẑ refinement in shifted/log form:
    #   ẑᵢ² = Πⱼ (λⱼ − ddᵢ) / (ρ · Πⱼ≠ᵢ (ddⱼ − ddᵢ))
    # with λⱼ − ddᵢ = (ddⱼ − ddᵢ) + μⱼ accurate in shifted coordinates
    delta = dd[:, None, :] - dd[:, :, None]          # (g, i, j): ddⱼ − ddᵢ
    num = delta + mu[:, None, :]                     # λⱼ − ddᵢ
    eye = torch.eye(n, dtype=torch.bool, device=d.device)
    # Δ = 0 (duplicates whose jitter underflowed at scale ≈ 0) would give
    # 0/0 and poison even the trivially merged branch with NaN
    safe_delta = torch.where(delta == 0, tiny, delta)
    den = torch.where(eye, 1.0, safe_delta)
    ratio = torch.where(eye, num, num / den)
    log_z2 = torch.log(ratio.abs() + tiny).sum(dim=-1) - torch.log(rho_s)[:, None]
    # a common shift rescales every ẑᵢ alike, which the column
    # normalisation cancels; it keeps exp, u² and Σu² in range as ρ → 0
    log_z2 = log_z2 - log_z2.amax(dim=-1, keepdim=True)
    z_hat = torch.exp(0.5 * log_z2) * torch.where(zz == 0, 1.0, torch.sign(zz))
    # eigenvectors u[i, r] = ẑᵢ / (ddᵢ − λᵣ), ddᵢ − λᵣ = delta[r, i] − μᵣ
    dmat = delta.transpose(-1, -2) - mu[:, None, :]  # (g, i, r)
    safe = torch.where(dmat == 0, tiny, dmat)
    u = z_hat[:, :, None] / safe
    # two-stage normalisation (max, then 2-norm): no overflow for any
    # dynamic range of ẑ and μ
    umax = u.abs().amax(dim=-2, keepdim=True)
    u = u / torch.where(umax == 0, 1.0, umax)
    u = u / torch.sqrt((u * u).sum(dim=-2, keepdim=True))
    # a numerically zero coupling (ρ·Σz² ≤ (eps·scale)², e.g. the
    # decoupled pad seam of the level-batched solver) merges trivially.
    # The raw ρ keeps β = 0 exact even where scale underflows.
    trivial = (torch.abs(rho) * zsq <= (eps * scale[:, 0]) ** 2)[:, None]
    lam = torch.where(trivial, dd, lam)
    u = torch.where(trivial[:, :, None], eye.to(dtype), u)
    lam_out = torch.where(neg, -lam, lam)
    inv = torch.argsort(order, dim=-1, stable=True)
    u_unsorted = torch.gather(u, 1, inv[:, :, None].expand(-1, n, n))
    v = torch.cat([mm(v1, u_unsorted[:, :n1, :]),
                   mm(v2, u_unsorted[:, n1:, :])], dim=1)
    fin = torch.argsort(lam_out, dim=-1, stable=True)
    return _take(lam_out, fin), torch.gather(v, 2, fin[:, None, :].expand(-1, n, n))


def _tdc(d, e):
    """Cuppen recursion on a batch (G, n), one merge per split
    (``nd4js_tpu/la/tridiag_dc.py:170-180``)."""
    n = d.shape[-1]
    if n <= _BASE:
        return _base_eigh(d, e)
    k = n // 2
    beta = e[:, k - 1]
    d1 = d[:, :k].clone()
    d1[:, k - 1] -= beta
    d2 = d[:, k:].clone()
    d2[:, 0] -= beta
    w1, v1 = _tdc(d1, e[:, :k - 1])
    w2, v2 = _tdc(d2, e[:, k:])
    return _merge(w1, v1, w2, v2, beta)


def _tdc_level_batched(d, e, base: int = _BASE):
    """Level-batched Cuppen D&C on a batch (B, n): pad T to
    M = base·2^L with decoupled diagonal entries above the spectrum, apply
    every split correction up front (junctions are ≥ base apart, so they
    never collide), solve all leaves in one batched Jacobi call, then one
    batched merge per level (``nd4js_tpu/la/tridiag_dc.py:183-234``)."""
    B, n = d.shape
    dt = d.dtype
    if n <= base:
        return _base_eigh(d, e)
    nleaf = -(-n // base)
    L = max(0, (nleaf - 1).bit_length())
    M = base << L
    if M > n:
        # pads strictly above the Gershgorin bound, pairwise distinct at
        # every scale (the absolute term covers T == 0)
        bound = d.abs().amax(dim=-1) + 2 * e.abs().amax(dim=-1)
        ar = torch.arange(1, M - n + 1, dtype=dt, device=d.device)
        pads = bound[:, None] * (1.25 + ar / 8) + ar
        d = torch.cat([d, pads], dim=-1)
        e = torch.cat([e, e.new_zeros((B, M - n))], dim=-1)
    e_in = torch.cat([e, e.new_zeros((B, 1))], dim=-1)        # length M
    P0 = M // base
    junc = base * torch.arange(1, P0, device=d.device)
    betas = e_in[:, junc - 1]
    d = d.clone()
    d[:, junc - 1] -= betas
    d[:, junc] -= betas
    dl = d.reshape(B * P0, base)
    el = e_in.reshape(B, P0, base)[:, :, :base - 1].reshape(B * P0, base - 1)
    w, v = _base_eigh(dl, el)          # (B·P0, base), (B·P0, base, base)
    m = base
    while m < M:
        P = M // (2 * m)
        w = w.reshape(B * P, 2, m)
        v = v.reshape(B * P, 2, m, m)
        beta = e_in[:, torch.arange(P, device=d.device) * 2 * m + m - 1]
        w, v = _merge(w[:, 0], v[:, 0], w[:, 1], v[:, 1], beta.reshape(B * P))
        m *= 2
    w, v = w.reshape(B, M), v.reshape(B, M, M)
    # the pads sit above the real spectrum: the ascending sort puts them
    # in the last M − n columns, and their rows are inert
    return w[:, :n], v[:, :n, :n]


def tridiag_eigh_dc(d, e, method: str = "batched", device=None):
    """Eigendecomposition of the symmetric tridiagonal (diagonal d,
    off-diagonal e): T = V·diag(w)·Vᵀ, w ascending. Batched over leading
    dims (d: (..., n), e: (..., n−1)).

    method: 'batched' (level-batched merges) or 'recursive' (one merge
    per split, the accuracy reference for tests). Up to n = 64 both run
    the recursion: below about four leaves the level batching buys
    nothing, and its pads add eps-scale noise. Array-likes go to
    ``device`` (default ``config.default_device``)."""
    d, e = as_tensor(d, device), as_tensor(e, device)
    dtype = default_float_for(torch.promote_types(d.dtype, e.dtype))

    @batched((1, 1))
    def core(d1, e1):
        flat = d1.ndim == 1
        if flat:
            d1, e1 = d1[None], e1[None]
        if method == "batched" and d1.shape[-1] > 64:
            w, v = _tdc_level_batched(d1, e1)
        else:
            w, v = _tdc(d1, e1)
        return (w[0], v[0]) if flat else (w, v)

    return core(d.to(dtype), e.to(dtype))

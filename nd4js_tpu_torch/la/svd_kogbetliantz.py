"""Two-sided Jacobi (Kogbetliantz) SVD, the mechanism behind
``svd_jac_2sided``, the counterpart of ``nd4js_tpu/la/svd_kogbetliantz.py``.

The reference's row-cyclic sweep over the N(N−1)/2 lexicographic pairs,
each pair's 2×2 block annihilated by the closed-form angle pair

    ┌ ca  sa ┐ ┌ S_pp S_pq ┐ ┌ cb  sb ┐   ┌ s1  0 ┐
    └-sa  ca ┘ └ S_qp S_qq ┘ └-sb  cb ┘ = └ 0  s2 ┘ ,  |s1| ≥ |s2|, s1 ≥ 0.

Two-sided Jacobi does not converge under the parallel tournament, so the
pairs run one after another, as in the reference. The pair table is
static, so a pair step is a few ops over the whole batch: S, Uᵀ and V
share one buffer [[S, Uᵀ], [V, 0]], whose rows p and q take the left
rotation (rows of S, columns of U) and whose columns p and q the right
one (columns of S and of V). The JAX package tests convergence once a
sweep per matrix (its ``while_loop`` under ``vmap``); here each matrix is
frozen (its rotations made the identity) once its sweep's off measure is
within tolerance or it has run ``max_sweeps``, and the host reads whether
any matrix is still running once a sweep. So each matrix runs exactly the
sweeps its JAX lane runs. O(N²) steps a sweep, each a few small kernels:
on the card a sweep is replayed as one CUDA graph (``core.graph``).
Mechanism parity, not throughput (``svd_gram`` and ``svd_jac_blocked``
are the fast paths).
"""
from __future__ import annotations

import torch

from ..core import graph, host
from ..core.mm import mt
from .svd_jac import _descending, _rectangular, _svd_entry

__all__ = ["svd_kogbetliantz"]


def _kog_angles(spp, spq, sqp, sqq):
    """The closed-form angles (``nd4js_tpu/la/svd_kogbetliantz.py:41-62``)
    with the reference's ordering (|s1| ≥ |s2|) and sign (s1 ≥ 0) fixes,
    elementwise."""
    x = torch.atan2(sqp - spq, sqq + spp)
    y = torch.atan2(sqp + spq, sqq - spp)
    a = (x - y) / 2
    b = (x + y) / 2
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    d1 = cb * (sa * sqp + ca * spp) - sb * (sa * sqq + ca * spq)
    d2 = sb * (ca * sqp - sa * spp) + cb * (ca * sqq - sa * spq)
    swap = d1.abs() < d2.abs()
    sa_n = torch.where(swap, ca, sa)
    ca_n = torch.where(swap, -sa, ca)
    cb_n = torch.where(swap, sb, cb)
    sb_n = torch.where(swap, -cb, sb)
    neg = torch.where(swap, d2, d1) < 0
    return ca_n, sa_n, torch.where(neg, -cb_n, cb_n), \
        torch.where(neg, -sb_n, sb_n)


def _pair_angles(spp, spq, sqp, sqq, hold):
    """The angles, the identity where the pair is inert (its off entries
    ≤ tiny) or the matrix is held (``hold``)."""
    tiny = torch.finfo(spp.dtype).tiny
    ca, sa, cb, sb = _kog_angles(spp, spq, sqp, sqq)
    still = hold | ((spq.abs() + sqp.abs()) <= tiny)
    return (torch.where(still, 1.0, ca), torch.where(still, 0.0, sa),
            torch.where(still, 1.0, cb), torch.where(still, 0.0, sb))


def _frame(a):
    """The work buffer [[S, Uᵀ], [V, 0]] of a batch (B, N, N), U = V = I."""
    B, N, _ = a.shape
    x = a.new_zeros((B, 2 * N, 2 * N))
    eye = torch.eye(N, dtype=a.dtype, device=a.device)
    x[:, :N, :N] = a
    x[:, :N, N:] = eye
    x[:, N:, :N] = eye
    return x


def _unframe(x, N: int):
    """(S, U, V) of the work buffer."""
    return x[:, :N, :N], mt(x[:, :N, N:]), x[:, N:, :N]


def _rotate(x, bi, p, q, ca, sa, cb, sb):
    """Rows p, q of the buffer ← [[ca, sa], [−sa, ca]]·[rows], then its
    columns p, q ← [cols]·[[cb, sb], [−sb, cb]], in place. p and q are
    ints with ``bi`` = ``slice(None)``, or one index a matrix with ``bi``
    = arange(B)."""
    rp, rq = x[bi, p], x[bi, q]
    nrp = ca[:, None] * rp + sa[:, None] * rq
    nrq = -sa[:, None] * rp + ca[:, None] * rq
    x[bi, p] = nrp
    x[bi, q] = nrq
    cp, cq = x[bi, :, p], x[bi, :, q]
    ncp = cb[:, None] * cp - sb[:, None] * cq
    ncq = sb[:, None] * cp + cb[:, None] * cq
    x[bi, :, p] = ncp
    x[bi, :, q] = ncq


def _sweep(x, hold):
    """One row-cyclic sweep of the buffer x (B, 2N, 2N), the matrices set
    in ``hold`` left as they are. Returns (x, off), off the sweep's
    largest (|S_pq| + |S_qp|)/‖(S_pp, S_qq)‖ a matrix."""
    N = x.shape[-1] // 2
    tiny = torch.finfo(x.dtype).tiny
    x = x.clone()
    off = x.new_zeros(x.shape[0])
    every = slice(None)
    for p in range(N - 1):
        for q in range(p + 1, N):
            spp, spq = x[:, p, p], x[:, p, q]
            sqp, sqq = x[:, q, p], x[:, q, q]
            scale = torch.sqrt(spp * spp + sqq * sqq) + tiny
            off = torch.maximum(off, (spq.abs() + sqp.abs()) / scale)
            _rotate(x, every, p, q,
                    *_pair_angles(spp, spq, sqp, sqq, hold))
    return x, off


def _kog_core(a, max_sweeps: int, tol):
    """Row-cyclic Kogbetliantz on a batch (B, N, N)
    (``nd4js_tpu/la/svd_kogbetliantz.py:72-146``, each matrix as its
    lane); on the card each sweep after the first is a CUDA graph
    (``core.graph``). Returns (S, U, V, sweeps) with a = U·S·Vᵀ, S ≈
    diagonal, and the sweeps each matrix ran."""
    B, N, _ = a.shape
    x = _frame(a)
    active = torch.ones(B, dtype=torch.bool, device=a.device)
    sweeps = torch.zeros(B, dtype=torch.int32, device=a.device)
    for _ in range(max_sweeps):
        x, off = graph.run("kogbetliantz sweep", _sweep, x, ~active)
        sweeps += active.to(torch.int32)
        active = active & (off > tol)
        if not host.read(active.any()):
            break
    return (*_unframe(x.clone(), N), sweeps)


def _kog_square(a3, max_sweeps: int):
    """The square batch (B, N, N) with the sign and order fixes. Returns
    (U, sv, V) with A = U·diag(sv)·V."""
    B, N, _ = a3.shape
    if N == 1:
        return (torch.where(a3 < 0, -1.0, 1.0), a3[:, 0].abs(),
                torch.ones_like(a3))
    s, u, v, _ = _kog_core(a3, max_sweeps, torch.finfo(a3.dtype).eps * N)
    d = torch.diagonal(s, 0, -2, -1)
    sv = d.abs()
    u = u * torch.where(d < 0, -1.0, 1.0)[:, None, :]
    order = _descending(sv)
    cols = order[:, None, :].expand(B, N, N)
    return (torch.gather(u, 2, cols), torch.gather(sv, 1, order),
            mt(torch.gather(v, 2, cols)))


def svd_kogbetliantz(a, max_sweeps: int = 30, device=None):
    """Two-sided Jacobi (Kogbetliantz) SVD, A = U·diag(sv)·V (see the
    module docstring), batched over leading dims; a tall input is reduced
    by QR first, a wide one transposed. An array-like ``a`` goes to
    ``device`` (default ``config.default_device``)."""
    return _svd_entry(a, lambda a3: _rectangular(
        a3, lambda r: _kog_square(r, max_sweeps)), device)

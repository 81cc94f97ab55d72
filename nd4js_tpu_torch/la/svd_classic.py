"""Classic two-sided Jacobi SVD with the greedy largest-off-diagonal
pivot, the counterpart of ``nd4js_tpu/la/svd_classic.py``.

Each rotation picks, per matrix, the pair (p, q) whose |S_pq| + |S_qp| is
largest (one masked argmax over |S| + |S|ᵀ) and annihilates it with
Kogbetliantz's closed-form angles (``svd_kogbetliantz._kog_angles``), so
the rotation is a gather and a scatter of two rows and two columns a
matrix of the buffer [[S, Uᵀ], [V, 0]]. The JAX package tests its
``while_loop`` condition (rotations below the cap, largest pair above
eps·‖A‖_F) before every rotation of each lane; here each matrix is frozen
by mask as soon as its condition fails, so it performs exactly the
rotations its lane does, and the host reads whether any matrix is still
running once every N(N−1)/2 rotations; on the card each such run after
the first is replayed as one CUDA graph (``core.graph``). Sequential by
nature: mechanism parity, not throughput.
"""
from __future__ import annotations

import functools

import torch

from ..core import graph, host
from ..core.mm import mt
from .svd_jac import _descending, _rectangular, _svd_entry
from .svd_kogbetliantz import _frame, _pair_angles, _rotate, _unframe

__all__ = ["svd_jac_classic_greedy"]


def _rotations(x, active, rot, tol, count: int):
    """``count`` greedy rotations of the buffer x (B, 2N, 2N), a matrix
    frozen (``active`` cleared) once its largest pair is ≤ its ``tol``.
    Returns (x, active, rot), ``rot`` counting each matrix's rotations."""
    B = x.shape[0]
    N = x.shape[-1] // 2
    x = x.clone()
    iu = torch.triu(torch.ones((N, N), dtype=torch.bool, device=x.device), 1)
    every = torch.arange(B, device=x.device)
    for _ in range(count):
        s = x[:, :N, :N]
        m = torch.where(iu, s.abs() + mt(s).abs(), -1.0).reshape(B, N * N)
        flat = torch.argmax(m, -1)
        mx = torch.gather(m, 1, flat[:, None])[:, 0]
        active = active & (mx > tol)
        p, q = flat // N, flat % N
        spp, spq = x[every, p, p], x[every, p, q]
        sqp, sqq = x[every, q, p], x[every, q, q]
        _rotate(x, every, p, q, *_pair_angles(spp, spq, sqp, sqq, ~active))
        rot = rot + active.to(torch.int32)
    return x, active, rot


def _classic_core(a, max_rot: int, tol):
    """Greedy Jacobi on a batch (B, N, N) (``nd4js_tpu/la/svd_classic.py:
    69-97``, each matrix as its lane; ``tol`` one a matrix), in runs of
    N(N−1)/2 rotations, each after the first a CUDA graph on the card
    (``core.graph``). Returns (S, U, V, rotations) with a = U·S·Vᵀ and
    the rotations each matrix performed."""
    B, N, _ = a.shape
    x = _frame(a)
    active = torch.ones(B, dtype=torch.bool, device=a.device)
    rot = torch.zeros(B, dtype=torch.int32, device=a.device)
    per_sweep = N * (N - 1) // 2
    done = 0
    while done < max_rot:
        count = min(per_sweep, max_rot - done)
        x, active, rot = graph.run(
            ("classic rotations", count),
            functools.partial(_rotations, count=count), x, active, rot, tol)
        done += count
        if not host.read(active.any()):
            break
    return (*_unframe(x.clone(), N), rot.clone())


def _classic_square(a3, max_sweeps: int):
    """The square batch (B, N, N) with the sign and order fixes."""
    B, N, _ = a3.shape
    if N == 1:
        return (torch.where(a3 < 0, -1.0, 1.0), a3[:, 0].abs(),
                torch.ones_like(a3))
    fro = torch.sqrt((a3 * a3).sum((-2, -1)))
    max_rot = max_sweeps * (N * (N - 1)) // 2
    s, u, v, _ = _classic_core(a3, max_rot, torch.finfo(a3.dtype).eps * fro)
    d = torch.diagonal(s, 0, -2, -1)
    sv = d.abs()
    u = u * torch.where(d < 0, -1.0, 1.0)[:, None, :]
    order = _descending(sv)
    cols = order[:, None, :].expand(B, N, N)
    return (torch.gather(u, 2, cols), torch.gather(sv, 1, order),
            mt(torch.gather(v, 2, cols)))


def svd_jac_classic_greedy(a, max_sweeps: int = 60, device=None):
    """Greedy largest-pivot classic Jacobi SVD, A = U·diag(sv)·V, batched
    over leading dims, at most max_sweeps·N(N−1)/2 rotations a matrix; a
    tall input is reduced by QR first, a wide one transposed. An
    array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    return _svd_entry(a, lambda a3: _rectangular(
        a3, lambda r: _classic_square(r, max_sweeps)), device)

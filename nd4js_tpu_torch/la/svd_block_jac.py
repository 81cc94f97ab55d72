"""Blocked one-sided Jacobi SVD, the counterpart of
``nd4js_tpu/la/svd_block_jac.py``.

Columns are grouped into nb blocks of width b, and block pairs follow a
round-robin schedule fixed on the host, so each round's reshuffle is a
static gather. For each pair: the 2b×2b Gram matrix (one batched GEMM
over all pairs), one parallel-Jacobi sweep on it (two-sided rotations,
Brent-Luk order, vectorised over pairs and batch; an approximate inner
solve, standard for block Jacobi), and the block rotation applied to W
and V as batched GEMMs. A fixed count of outer sweeps, no convergence
test. On the card each inner sweep after the first is replayed as one
CUDA graph (``core.graph``). Then the singular values are the column norms, sorted; U is W
normalised, completed to an orthonormal basis where a singular value is
zero (``svd_jac._complete_u``). Tall inputs are reduced by Householder QR
first (``house_panel`` on the card), wide ones transposed. Plain PyTorch
around that kernel: the JAX package computes these GEMMs outside any
Pallas kernel.

One step is added to the JAX package's: V, a product of some seventy
rotation GEMMs, drifts from orthogonal in float32 (by 2.3e-4 at 512², the
contract's 4·eps·N), and U·diag(σ)·V misses A by as much, over bench.py's
reconstruction gate. So before the last outer sweep V gets ``svd_dc``'s
CholeskyQR polish (``chol_leaf`` on the card) and W is formed anew as
A·V; the last sweep makes W's columns orthogonal again, and V drifts by
one sweep's rotations only.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import graph
from ..core.mm import mm, mt
from .svd_dc import _orth_polish
from .svd_jac import (_brent_luk_shuffle, _complete_u, _descending,
                      _rectangular, _svd_entry)

__all__ = ["svd_jac_blocked"]


def _round_robin_schedule(nb: int):
    """The classic tournament of nb teams (nb even): nb − 1 rounds of
    nb/2 disjoint pairs, each round the flat block order
    [i0, j0, i1, j1, ...]."""
    teams = list(range(nb))
    rounds = []
    for _ in range(nb - 1):
        pairs = [(teams[i], teams[nb - 1 - i]) for i in range(nb // 2)]
        rounds.append([ix for p in pairs for ix in p])
        teams = [teams[0]] + [teams[-1]] + teams[1:-1]
    return rounds


def _inner_rotation_sweep(g, sweeps: int = 1):
    """``sweeps`` parallel-Jacobi sweeps on symmetric (..., n, n) Gram
    matrices; returns only the accumulated rotation Φ, orthogonal by
    construction (``nd4js_tpu/la/svd_block_jac.py:52-108``)."""
    n = g.shape[-1]
    h = n // 2
    tiny = torch.finfo(g.dtype).tiny
    a = g
    v = torch.eye(n, dtype=g.dtype, device=g.device).expand(g.shape)
    for _ in range(sweeps * (n - 1)):
        app = torch.diagonal(a[..., :h, :h], 0, -2, -1)
        aqq = torch.diagonal(a[..., h:, h:], 0, -2, -1)
        apq = torch.diagonal(a[..., :h, h:], 0, -2, -1)
        small = apq.abs() <= tiny
        tau = (aqq - app) / (2 * torch.where(small, 1.0, apq))
        t = torch.sign(tau) / (tau.abs() + torch.sqrt(1 + tau * tau))
        t = torch.where(tau == 0, 1.0, t)
        t = torch.where(small, 0.0, t)
        c = torch.rsqrt(1 + t * t)
        s = t * c
        # rows then columns of A, columns of V
        at, ab = a[..., :h, :], a[..., h:, :]
        a = torch.cat([c[..., :, None] * at - s[..., :, None] * ab,
                       s[..., :, None] * at + c[..., :, None] * ab], -2)
        al, ar = a[..., :, :h], a[..., :, h:]
        nal = c[..., None, :] * al - s[..., None, :] * ar
        nar = s[..., None, :] * al + c[..., None, :] * ar
        vl, vr = v[..., :, :h], v[..., :, h:]
        nvl = c[..., None, :] * vl - s[..., None, :] * vr
        nvr = s[..., None, :] * vl + c[..., None, :] * vr
        # the same seat change on A's columns, A's rows and V's columns
        a = torch.cat(_brent_luk_shuffle(nal, nar), -1)
        at2, ab2 = _brent_luk_shuffle(mt(a[..., :h, :]), mt(a[..., h:, :]))
        a = torch.cat([mt(at2), mt(ab2)], -2)
        v = torch.cat(_brent_luk_shuffle(nvl, nvr), -1)
    return v


def _svd_blocked_core(a3, block: int = 64, outer_sweeps: int = 10,
                      inner_sweeps: int = 1):
    """A square batch (Bn, N, N). Returns (U, sv, V) with A = U·diag(sv)·V
    (``nd4js_tpu/la/svd_block_jac.py:111-164``). N is padded with zero
    columns to a multiple of 2b, so nb is even and at least 2."""
    Bn, N, _ = a3.shape
    b = min(block, N)
    pad = (-N) % (2 * b)
    n_work = N + pad
    w = torch.cat([a3, a3.new_zeros((Bn, N, pad))], 2) if pad else a3
    nb = n_work // b
    v = torch.eye(n_work, dtype=a3.dtype, device=a3.device).expand(
        Bn, n_work, n_work)
    npair = nb // 2

    def inner(g):
        return (_inner_rotation_sweep(g, inner_sweeps),)

    for sweep in range(outer_sweeps):
        if sweep == outer_sweeps - 1:
            # V orthonormal again, W = A·V of it (A's pad columns are 0)
            v = _orth_polish(v)
            w = mm(a3, v[:, :N, :])
        for rnd in _round_robin_schedule(nb):
            # the blocks in pair-adjacent order
            cols = (np.asarray(rnd)[:, None] * b
                    + np.arange(b)[None, :]).reshape(-1)
            sel = torch.from_numpy(cols).to(a3.device)
            wp = w[:, :, sel].reshape(Bn, N, npair, 2 * b).movedim(2, 1)
            vp = v[:, :, sel].reshape(Bn, n_work, npair, 2 * b).movedim(2, 1)
            phi = graph.run(("block Jacobi inner sweep", inner_sweeps),
                            inner, mm(mt(wp), wp))[0]
            wp = mm(wp, phi).movedim(1, 2).reshape(Bn, N, n_work)
            vp = mm(vp, phi).movedim(1, 2).reshape(Bn, n_work, n_work)
            inv = torch.from_numpy(np.argsort(cols)).to(a3.device)
            w = wp[:, :, inv]
            v = vp[:, :, inv]
    # σ, sort and normalise, the padding cut
    sv = torch.sqrt((w * w).sum(1))
    order = _descending(sv)[..., :N]
    sv = torch.gather(sv, 1, order)
    w = torch.gather(w, 2, order[:, None, :].expand(Bn, N, N))
    v = torch.gather(v, 2, order[:, None, :].expand(Bn, n_work, N))[:, :N, :]
    u = w / torch.where(sv > 0, sv, 1.0)[:, None, :]
    eps = torch.finfo(a3.dtype).eps
    return _complete_u(u, sv, eps * N * sv.amax(-1)), sv, mt(v)


def svd_jac_blocked(a, block: int = 64, outer_sweeps: int = 10,
                    device=None):
    """Blocked one-sided Jacobi SVD, A = U·diag(sv)·V, batched over
    leading dims (see the module docstring). An array-like ``a`` goes to
    ``device`` (default ``config.default_device``)."""
    return _svd_entry(a, lambda a3: _rectangular(
        a3, lambda r: _svd_blocked_core(r, block, outer_sweeps)), device)

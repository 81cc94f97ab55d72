"""k-nearest neighbours, the counterpart of ``nd4js_tpu/utils/spatial.py``:
``KDTree`` keeps the reference's surface (``nearest``, ``nearest_gen``)
over a brute-force search, as the JAX package does: the squared distances
‖p‖² − 2·q·pᵀ + ‖q‖² by one product (``core.mm``, full float32
precision), then the k smallest by ``torch.topk``.

``lax.top_k`` puts the lower index first among equal values; ``torch.topk``
promises no order among them. So the k-th distance of each query is
taken from ``topk``, every point strictly nearer is kept, the points at
exactly that distance are taken lowest index first (a second ``topk``, on
the negated indices), and the k are sorted by (distance, index).
"""
from __future__ import annotations

import torch

from ..convert import as_tensor
from ..core.mm import mm, mt

__all__ = ["KDTree"]


def _k_smallest(d2, k):
    """(values, indices) of the k smallest entries of each row of d2,
    ascending, the lower index first among equal values."""
    n = d2.shape[1]
    vals, idx = torch.topk(d2, k, dim=1, largest=False)
    kth = vals.max(1, keepdim=True).values
    n_lt = (vals < kth).sum(1, keepdim=True)
    iota = torch.arange(n, dtype=torch.int32, device=d2.device)
    # the points at exactly the k-th distance, lowest index first
    at_kth = torch.topk(torch.where(d2 == kth, -iota, -n), k, dim=1).indices
    j = torch.arange(k, device=d2.device)
    keep = torch.where(j < n_lt, idx,
                       at_kth.gather(1, torch.clamp(j - n_lt, min=0)))
    keep = torch.sort(keep, dim=1).values
    vals = d2.gather(1, keep)
    order = torch.sort(vals, dim=1, stable=True).indices
    return vals.gather(1, order), keep.gather(1, order)


class KDTree:
    """k-NN index over an (N, D) point set."""

    def __init__(self, points, device=None):
        """An array-like ``points`` goes to ``device`` (default
        ``config.default_device``)."""
        self.points = as_tensor(points, device)
        if self.points.ndim != 2:
            raise ValueError("KDTree expects (N, D) points")
        self._sq = torch.sum(self.points * self.points, 1)

    def nearest(self, queries, k: int = 1):
        """Distances and indices of the k nearest points of each query.

        queries: (Q, D) or (D,). Returns (dist (Q, k), idx (Q, k)), nearest
        first, the lower index first among equal distances."""
        q = as_tensor(queries, self.points.device)
        dtype = torch.promote_types(q.dtype, self.points.dtype)
        q, p, sq = q.to(dtype), self.points.to(dtype), self._sq.to(dtype)
        single = q.ndim == 1
        if single:
            q = q[None, :]
        # ‖p − q‖² = ‖p‖² − 2·q·pᵀ + ‖q‖²
        d2 = sq[None, :] - 2 * mm(q, mt(p)) + torch.sum(q * q, 1)[:, None]
        d2 = torch.clamp(d2, min=0.0)
        d2, idx = _k_smallest(d2, k)
        dist = torch.sqrt(d2)
        if single:
            return dist[0], idx[0]
        return dist, idx

    def nearest_gen(self, query):
        """Yield (distance, index) pairs in increasing distance, every
        point once."""
        dist, idx = self.nearest(query, k=self.points.shape[0])
        for d, i in zip(dist.tolist(), idx.tolist()):
            yield d, int(i)

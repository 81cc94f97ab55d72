"""Row and column permutations, the counterpart of
``nd4js_tpu/la/permute.py``.

A permutation is an integer index tensor ``P`` with ``out[i] = in[P[i]]``
(permute) and the inverse scatter for unpermute, both as gathers.
Leading dims broadcast.
"""
from __future__ import annotations

import torch

from ..convert import as_tensor

__all__ = ["permute_rows", "permute_cols", "unpermute_rows", "unpermute_cols",
           "invert_permutation"]


def invert_permutation(p, device=None):
    """Index tensor q with q[p[i]] = i, batched over leading dims, in p's
    integer dtype."""
    p = as_tensor(p, device)
    return torch.sort(p, dim=-1, stable=True).indices.to(p.dtype)


def _gather(a, p, axis: int, device):
    a = as_tensor(a, device)
    p = as_tensor(p, a.device)
    lead = torch.broadcast_shapes(a.shape[:-2], p.shape[:-1])
    idx = p.long().expand(lead + p.shape[-1:])
    if axis == -2:
        idx = idx[..., :, None].expand(lead + (p.shape[-1], a.shape[-1]))
    else:
        idx = idx[..., None, :].expand(lead + (a.shape[-2], p.shape[-1]))
    return torch.gather(a.expand(lead + a.shape[-2:]), axis, idx)


def permute_rows(a, p, device=None):
    """out[..., i, :] = a[..., p[i], :]."""
    return _gather(a, p, -2, device)


def permute_cols(a, p, device=None):
    """out[..., :, j] = a[..., :, p[j]]."""
    return _gather(a, p, -1, device)


def unpermute_rows(a, p, device=None):
    """Inverse of :func:`permute_rows`."""
    return permute_rows(a, invert_permutation(p, device), device)


def unpermute_cols(a, p, device=None):
    """Inverse of :func:`permute_cols`."""
    return permute_cols(a, invert_permutation(p, device), device)

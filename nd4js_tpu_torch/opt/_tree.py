"""Select between two solver states of one structure, field by field.

Where the JAX package's ``lax.cond`` picks between two cheap, NaN-safe
branches (accept or reject a step, keep or skip a curvature pair), the
port computes both and selects with ``torch.where``: no host read."""
from __future__ import annotations

import torch

__all__ = ["where_tree", "vdot"]


def where_tree(cond: torch.Tensor, a, b):
    """``a`` where the 0-d bool ``cond`` holds, else ``b``: tensors, or
    tuples and NamedTuples of them, of matching structure."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    return type(a)(*(where_tree(cond, x, y) for x, y in zip(a, b)))


def vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dot product of two real tensors, flattened (``jnp.vdot``)."""
    return torch.dot(a.reshape(-1), b.reshape(-1))

"""The port's counterpart of ``__graft_entry__.entry()``: one forward
step of the flagship workload, batched least squares by QR."""
from __future__ import annotations

import torch

from . import config, la

__all__ = ["entry", "forward"]


def forward(a: torch.Tensor, y: torch.Tensor):
    """x = argmin‖A·x − y‖ by ``qr_decomp`` then ``qr_lstsq``, and the
    Frobenius norm of each residual A·x − y."""
    q, r = la.qr_decomp(a)
    x = la.qr_lstsq(q, r, y)
    resid = la.norm_fro(la.matmul2(a, x) - y, axis=(-2, -1))
    return x, resid


def entry(device=None, seed: int = 0):
    """(forward, (a, y)) at the shapes of ``__graft_entry__.entry()``:
    a (4, 128, 128), y (4, 128, 1), float32, standard normal from a
    ``torch.Generator`` seeded with ``seed``, on ``device`` (default
    ``config.default_device``)."""
    b, n = 4, 128
    gen = torch.Generator().manual_seed(seed)
    a = torch.randn((b, n, n), generator=gen, dtype=torch.float32)
    y = torch.randn((b, n, 1), generator=gen, dtype=torch.float32)
    device = config.default_device if device is None else device
    return forward, (a.to(device), y.to(device))

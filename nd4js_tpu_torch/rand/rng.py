"""Seeded random number generation, the counterpart of
``nd4js_tpu/rand/rng.py``: the class ``RNG`` (``int``, ``uniform``,
``normal``, ``bool``, ``shuffle``, and the structured ``ortho`` and
``rankdef``) and the deprecated ``rand_normal`` and ``rand_ortho``.

Each ``RNG`` owns a ``torch.Generator`` on its device, seeded from
``seed`` (a string seed through CRC-32, so it means the same in every
process), so an instance is reproducible from its seed. Its streams are
PyTorch's, not JAX's threefry streams: the two packages agree by
contract (shapes, ranges, orthogonality, rank), not by value. ``ortho``
is the Householder QR of Gaussians with R's diagonal made positive
(``la.qr_decomp``, so ``house_panel`` on the card).
"""
from __future__ import annotations

import warnings
import zlib

import torch

from .. import config
from ..convert import as_tensor
from ..core import host
from ..core.mm import mm, mt

__all__ = ["RNG", "rand_normal", "rand_ortho"]


class RNG:
    """Seeded generator with the reference's AleaRNG surface; draws go to
    ``device`` (default ``config.default_device``)."""

    def __init__(self, seed=0, device=None):
        if isinstance(seed, str):
            seed = zlib.crc32(seed.encode()) % (2 ** 31)
        self.device = torch.device(
            config.default_device if device is None else device)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

    def _draw(self, fn, *args, **kw):
        return fn(*args, generator=self._gen, device=self.device, **kw)

    # ---- scalars and arrays -------------------------------------------
    def int(self, lo, hi, *shape):
        """Integers uniform on [lo, hi), int32; a Python int for no
        shape."""
        out = self._draw(torch.randint, int(lo), int(hi), shape,
                         dtype=torch.int32)
        return host.read(out) if shape == () else out

    def uniform(self, lo, hi, *shape, dtype=None):
        """Uniform on [lo, hi)."""
        u = self._draw(torch.rand, shape, dtype=dtype or config.default_float)
        return lo + (hi - lo) * u

    def normal(self, *shape, dtype=None):
        """Standard normal."""
        return self._draw(torch.randn, shape,
                          dtype=dtype or config.default_float)

    def bool(self, *shape):
        """Fair coins; a Python bool for no shape."""
        out = self._draw(torch.rand, shape) < 0.5
        return host.read(out) if shape == () else out

    def shuffle(self, x, axis: int = 0):
        """``x`` permuted at random along ``axis``."""
        x = as_tensor(x, self.device)
        perm = self._draw(torch.randperm, x.shape[axis])
        return x.index_select(axis, perm)

    # ---- structured matrices ------------------------------------------
    def ortho(self, *shape, dtype=None):
        """Random orthogonal matrices (..., M, N): orthonormal columns for
        M ≥ N, orthonormal rows for M < N."""
        from ..la.qr import qr_decomp      # la re-exports rand_ortho
        dtype = dtype or config.default_float
        if len(shape) == 1:
            shape = (shape[0], shape[0])
        *batch, m, n = shape
        k = min(m, n)
        q, r = qr_decomp(self.normal(*batch, max(m, n), k, dtype=dtype))
        d = torch.diagonal(r, 0, -2, -1)
        q = q * torch.where(d < 0, -1.0, 1.0)[..., None, :]
        return mt(q) if m < n else q

    def rankdef(self, *shape, rank=None, dtype=None):
        """Random matrices of known rank, U·diag(sv)·Vᵀ with the trailing
        singular values zeroed (sv uniform on [0.5, 2)). Returns
        (A, rank); rank is drawn on [0, min(M, N)] when not given."""
        dtype = dtype or config.default_float
        *batch, m, n = shape
        k = min(m, n)
        if rank is None:
            rank = self.int(0, k + 1)
        u = self.ortho(*batch, m, k, dtype=dtype)
        v = self.ortho(*batch, n, k, dtype=dtype)
        sv = self.uniform(0.5, 2.0, *batch, k, dtype=dtype)
        sv = sv * (torch.arange(k, device=self.device) < rank)
        return mm(u * sv[..., None, :], mt(v)), rank


def rand_normal(*shape, device=None):
    """Deprecated global sampler: ``RNG(0xDECAF).normal``."""
    warnings.warn("rand_normal is deprecated; use RNG(seed).normal",
                  DeprecationWarning)
    return RNG(0xDECAF, device).normal(*shape)


def rand_ortho(*shape, dtype=None, device=None):
    """Deprecated random orthogonal: ``RNG(0xDECAF).ortho``."""
    warnings.warn("rand_ortho is deprecated; use RNG(seed).ortho",
                  DeprecationWarning)
    return RNG(0xDECAF, device).ortho(*shape, dtype=dtype)

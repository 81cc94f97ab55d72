"""Real roots of quadratic polynomials, the counterpart of
``nd4js_tpu/opt/polyquad.py``: the stable quadratic formula (the
larger-magnitude root by the classic formula, the other by Vieta)."""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor

__all__ = ["roots1d_polyquad"]


def roots1d_polyquad(c0, c1, c2, device=None):
    """Roots of c2·x² + c1·x + c0 = 0, sorted (r0 <= r1), elementwise.

    For c2 == 0 the linear root, twice. Complex roots give NaN. Array-likes
    go to ``device`` (default ``config.default_device``); c1 and c2 take
    c0's device and dtype.
    """
    c0 = as_tensor(c0, device)
    c0 = c0.to(default_float_for(c0.dtype))
    c1 = as_tensor(c1, c0.device).to(c0.dtype)
    c2 = as_tensor(c2, c0.device).to(c0.dtype)
    lin = c2 == 0
    safe_c1 = torch.where(c1 == 0, 1.0, c1)
    xlin = torch.where(c1 == 0, torch.nan, -c0 / safe_c1)
    disc = c1 * c1 - 4 * c2 * c0
    sq = torch.sqrt(torch.where(disc < 0, torch.nan, disc))
    qq = -(c1 + torch.sign(c1) * sq) / 2
    qq = torch.where(c1 == 0, -sq / 2, qq)    # sign(0) = 0 would zero q
    safe_c2 = torch.where(lin, 1.0, c2)
    r1 = qq / safe_c2
    safe_q = torch.where(qq == 0, 1.0, qq)
    r2 = torch.where(qq == 0, 0.0, c0 / safe_q)
    r1 = torch.where(lin, xlin, r1)
    r2 = torch.where(lin, xlin, r2)
    return torch.minimum(r1, r2), torch.maximum(r1, r2)

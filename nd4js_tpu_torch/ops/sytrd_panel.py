"""One latrd panel of symmetric tridiagonalisation with its rank-2b update:
the CUDA kernel ``csrc/sytrd_panel.cu`` (the port of
``nd4js_tpu/ops/sytrd_panel.py::sytrd_panel``), its plain PyTorch
version, and a launch counter.

For each of the ``bk`` leading columns j of a batch of symmetric blocks C
(Nb, m, m), column j of the panel-updated matrix C − V·Wᵀ − W·Vᵀ gives
d[j] = its diagonal entry and a Householder reflector H_j = I − τ·v·vᵀ
(unit at row j + 1, zeros above) that zeroes it below the subdiagonal,
with e[j] = β; then w = τ·(C·v − V·(Wᵀv) − W·(Vᵀv)), less ½τ(wᵀv)·v, as
in LAPACK's latrd. A column already zero below the subdiagonal gives τ = 0
and β = its subdiagonal entry. The trailing block of C − V·Wᵀ − W·Vᵀ is
returned exactly symmetric: each entry (i, j ≥ i) is computed once as
(c_ij − x_ij) − x_ji with X = V·Wᵀ and mirrored, so that the next panel
may read a column of it as a row. (The TPU kernel computes the full block
as c − X − Xᵀ, whose two triangles round differently.)
"""
from __future__ import annotations

import torch

from ..core.mm import mm, mt
from . import _build

__all__ = ["MAX_BK", "sytrd_panel", "sytrd_panel_ref"]

MAX_BK = 64        # widest panel the kernel takes

# Kernel launches since the last reset; only sytrd_panel's CUDA branch adds
# to it.
launches = 0


def sytrd_panel_ref(c: torch.Tensor, bk: int):
    """Plain PyTorch version of the kernel: ``_sytrd_panel``
    (``nd4js_tpu/la/sytrd.py:43-88``) with the batch axis written out,
    then the mirrored rank-2b update. Returns (C_trailing, V, W, taus, d,
    e)."""
    nb, m, _ = c.shape
    rows = torch.arange(m, device=c.device)
    V = c.new_zeros((nb, m, bk))
    W = c.new_zeros((nb, m, bk))
    taus, dd, ee = (c.new_zeros((nb, bk)) for _ in range(3))
    for j in range(bk):
        # finished column j of the panel-updated matrix
        col = c[:, :, j] - mm(V, W[:, j, :, None])[..., 0] \
            - mm(W, V[:, j, :, None])[..., 0]
        dd[:, j] = col[:, j]
        x0 = col[:, j + 1]
        sigma = torch.where(rows > j + 1, col * col, 0.0).sum(dim=1)
        nrm = torch.sqrt(x0 * x0 + sigma)
        beta = torch.where(x0 >= 0, -nrm, nrm)
        beta = torch.where(sigma == 0, x0, beta)     # no-op reflector
        den = x0 - beta
        safe_den = torch.where(den == 0, 1.0, den)
        v = torch.where(rows > j + 1, col / safe_den[:, None], 0.0)
        v[:, j + 1] = 1.0
        safe_beta = torch.where(beta == 0, 1.0, beta)
        tau = torch.where(sigma == 0, 0.0, (beta - x0) / safe_beta)
        ee[:, j] = beta
        taus[:, j] = tau
        # w = τ·(C·v − V·Wᵀ·v − W·Vᵀ·v);  w −= ½·τ·(wᵀ·v)·v
        vc = v[..., None]
        cv = mm(c, vc) - mm(V, mm(mt(W), vc)) - mm(W, mm(mt(V), vc))
        w = tau[:, None] * cv[..., 0]
        w = w - (0.5 * tau * (w * v).sum(dim=1))[:, None] * v
        V[:, :, j] = v
        W[:, :, j] = w
    x = mm(V[:, bk:], mt(W[:, bk:]))
    full = c[:, bk:, bk:] - x - mt(x)
    # the upper triangle, mirrored: exactly symmetric, as the kernel's
    trail = torch.triu(full) + mt(torch.triu(full, 1))
    return trail, V, W, taus, dd, ee


def sytrd_panel(c: torch.Tensor, bk: int):
    """One latrd panel of ``bk`` columns on a batch of exactly symmetric
    blocks C (Nb, m, m), 1 ≤ bk ≤ min(MAX_BK, m − 1) → (C_trailing
    (Nb, m − bk, m − bk), V (Nb, m, bk), W (Nb, m, bk), taus, d, e (Nb,
    bk)), with C_trailing = (C − V·Wᵀ − W·Vᵀ)[:, bk:, bk:], exactly
    symmetric.

    A CUDA tensor runs the kernel (or raises); a CPU tensor runs
    :func:`sytrd_panel_ref`. The kernel returns V and W as transposed
    views of its (Nb, bk, m) panels.
    """
    global launches
    on_card = _build.check_operand(c, "sytrd_panel", 3)
    nb, m, m2 = c.shape
    if m != m2 or not 1 <= bk <= min(MAX_BK, m - 1):
        raise ValueError(f"sytrd_panel: needs square blocks and 1 <= bk <= "
                         f"min({MAX_BK}, m - 1), got {tuple(c.shape)}, "
                         f"bk={bk}")
    if not on_card:
        return sytrd_panel_ref(c, bk)
    c = c.contiguous()
    trail = c.new_empty((nb, m - bk, m - bk))
    vt = c.new_empty((nb, bk, m))
    wt = c.new_empty((nb, bk, m))
    taus, dd, ee = (c.new_empty((nb, bk)) for _ in range(3))
    f64 = c.dtype == torch.float64
    _build.launch("nd4js_sytrd_panel_f64" if f64 else "nd4js_sytrd_panel_f32",
                  c.device, c, trail, vt, wt, taus, dd, ee, nb, m, bk)
    launches += 1
    return trail, mt(vt), mt(wt), taus, dd, ee

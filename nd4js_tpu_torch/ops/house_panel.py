"""Householder QR panel factorisation (the port of
``nd4js_tpu/ops/house_panel.py``): on the card the stripe-WY body of
``csrc/house_stripe.cuh``, through the kernel ``house_stripe_t`` launches
(``ops.house_stripe``), its plain PyTorch version, and a launch counter of
its own.

Outputs (R_panel, V, taus) of a batched panel (Nb, M, B): R_panel's top
rows are the R block (zeros below), V holds unit-diagonal reflectors
(zeros above the diagonal), H_0···H_{B−1} = I − V·T·Vᵀ with T from
``la.qr._form_t_batched``.
"""
from __future__ import annotations

import torch

from . import _build, house_stripe

__all__ = ["house_panel", "house_panel_ref", "householder_step"]

# Kernel launches since the last reset; only house_panel's CUDA branch
# adds to it.
launches = 0


def householder_step(a: torch.Tensor, j: int):
    """Householder step j, in place on a batch ``a`` (Nb, M, C): the
    reflector of column j (rows j..M−1) with the sign and zero rules of
    ``nd4js_tpu/ops/house_panel.py:43-53``, applied to columns > j;
    column j becomes beta·e_j below row j. Returns (v (Nb, M), tau (Nb,))."""
    x = a[:, :, j]
    x0 = x[:, j]
    sigma = (x[:, j + 1:] ** 2).sum(-1)
    nrm = torch.sqrt(x0 * x0 + sigma)
    beta = torch.where(x0 >= 0, -nrm, nrm)
    den = x0 - beta
    den = torch.where(den == 0, torch.ones_like(den), den)
    safe_beta = torch.where(beta == 0, torch.ones_like(beta), beta)
    tau = torch.where(nrm == 0, torch.zeros_like(beta), (beta - x0) / safe_beta)
    v = torch.zeros_like(x)
    v[:, j] = 1
    v[:, j + 1:] = x[:, j + 1:] / den[:, None]
    w = tau[:, None] * torch.matmul(v[:, None, j:], a[:, j:, j + 1:])[:, 0]
    a[:, j:, j + 1:] -= v[:, j:, None] * w[:, None, :]
    a[:, j + 1:, j] = 0
    a[:, j, j] = beta
    return v, tau


def house_panel_ref(panel: torch.Tensor):
    """Plain PyTorch version of the kernel: the reflector loop of
    ``nd4js_tpu/la/qr.py:40-80``, batched."""
    r = panel.clone()
    nb, m, b = panel.shape
    V = torch.zeros_like(panel)
    taus = panel.new_zeros((nb, b))
    for j in range(min(m, b)):
        V[:, :, j], taus[:, j] = householder_step(r, j)
    return r, V, taus


def house_panel(panel: torch.Tensor):
    """Householder-factor a batched panel (Nb, M, B) → (R_panel, V, taus).

    A CUDA tensor runs the stripe-WY body in the regime and cluster size
    of ``house_stripe.stripe_plan`` (or raises); a CPU tensor runs
    :func:`house_panel_ref`.
    """
    if not _build.check_operand(panel, "house_panel", 3):
        return house_panel_ref(panel)
    if not panel.is_contiguous():
        raise ValueError("house_panel: the panel must be contiguous")
    if 0 in panel.shape:
        nb, _, b = panel.shape
        return panel.clone(), torch.zeros_like(panel), panel.new_zeros((nb, b))
    return _house_panel_in(panel, *house_stripe.stripe_plan(panel))


def _house_panel_in(panel: torch.Tensor, cluster: int, shared: bool):
    """:func:`house_panel` on a contiguous CUDA panel in the given regime
    and cluster size (the card's checks run every one); one that does not
    fit raises."""
    global launches
    out = house_stripe._stripe_panel(panel, cluster, shared, "house_panel")
    launches += 1
    return out

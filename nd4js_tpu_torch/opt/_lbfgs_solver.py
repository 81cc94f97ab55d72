"""Compact L-BFGS two-loop recursion on a ring buffer, the counterpart of
``nd4js_tpu/opt/_lbfgs_solver.py``: ``lbfgs_update`` with the curvature
guard, ``lbfgs_forget`` (drop the oldest pairs) and ``lbfgs_hv``, all
masked tensor operations over an (m, n) ring buffer, so the solver state
is a NamedTuple of fixed shapes. The guard selects with ``torch.where``
and the loops over the buffer's m slots are Python loops: no host read.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import config
from ._tree import vdot, where_tree

__all__ = ["LBFGSState", "lbfgs_init", "lbfgs_update", "lbfgs_forget",
           "lbfgs_hv"]


class LBFGSState(NamedTuple):
    s: torch.Tensor          # (m, n) steps dx
    y: torch.Tensor          # (m, n) gradient changes dg
    rho: torch.Tensor        # (m,)   1/(s·y)
    head: torch.Tensor       # () int32, next insert slot
    count: torch.Tensor      # () int32, number of valid entries
    gamma: torch.Tensor      # () initial Hessian scale s·y/y·y


def lbfgs_init(m: int, n: int, dtype=torch.float32,
               device=None) -> LBFGSState:
    """An empty buffer of m pairs of length n on ``device`` (default
    ``config.default_device``)."""
    dev = config.default_device if device is None else device
    return LBFGSState(
        s=torch.zeros((m, n), dtype=dtype, device=dev),
        y=torch.zeros((m, n), dtype=dtype, device=dev),
        rho=torch.zeros((m,), dtype=dtype, device=dev),
        head=torch.zeros((), dtype=torch.int32, device=dev),
        count=torch.zeros((), dtype=torch.int32, device=dev),
        gamma=torch.ones((), dtype=dtype, device=dev))


def lbfgs_update(st: LBFGSState, dx, dg) -> LBFGSState:
    """Append (dx, dg) if the curvature condition
    dx·dg > eps·‖dx‖·‖dg‖ holds."""
    dxdg = vdot(dx, dg)
    dgdg = vdot(dg, dg)
    eps = torch.finfo(st.s.dtype).eps
    ok = dxdg > eps * torch.sqrt(vdot(dx, dx) * dgdg)
    m = st.s.shape[0]
    slot = torch.arange(m, device=st.s.device) == st.head
    new = LBFGSState(
        s=torch.where(slot[:, None], dx.reshape(1, -1), st.s),
        y=torch.where(slot[:, None], dg.reshape(1, -1), st.y),
        rho=torch.where(slot, 1.0 / dxdg, st.rho),
        head=(st.head + 1) % m,
        count=torch.clamp(st.count + 1, max=m),
        gamma=dxdg / torch.where(dgdg == 0, 1.0, dgdg))
    return where_tree(ok, new, st)


def lbfgs_forget(st: LBFGSState, k) -> LBFGSState:
    """Drop the k oldest pairs."""
    return st._replace(count=torch.clamp(st.count - k, min=0))


def lbfgs_hv(st: LBFGSState, g):
    """H·g by the two-loop recursion, masked over the ring buffer. Returns
    the ascent direction H·g.

    The buffer is gathered once in each loop's order (newest to oldest,
    then oldest to newest), so that each step indexes by a Python int: a
    view, not a gather on the device."""
    m = st.s.shape[0]
    k = torch.arange(m, device=st.s.device)
    valid = (k < st.count).to(g.dtype)      # the i-th pair of either order
    new = (st.head - 1 - k) % m             # slots, newest -> oldest
    old = (st.head - st.count + k) % m      # slots, oldest -> newest
    s_n, y_n, rho_n = st.s[new], st.y[new], st.rho[new]
    q = g
    alphas = []
    for i in range(m):
        alpha = rho_n[i] * vdot(s_n[i], q) * valid[i]
        q = q - alpha * y_n[i]
        alphas.append(alpha)
    # each slot's alpha, read back in the second loop's order
    by_slot = st.rho.new_zeros((m,)).index_put((new,), torch.stack(alphas))
    a_o, s_o, y_o, rho_o = by_slot[old], st.s[old], st.y[old], st.rho[old]
    q = q * st.gamma
    for i in range(m):
        beta = rho_o[i] * vdot(y_o[i], q)
        q = q + s_o[i] * ((a_o[i] - beta) * valid[i])
    return q

"""The complete real Schur form of small upper Hessenberg matrices: the
CUDA kernel ``csrc/schur_small.cu`` (the port of
``nd4js_tpu/ops/schur_small.py::schur_small``), its plain PyTorch
version, and a launch counter.

The Francis iteration of ``la.schur``'s n < 192 regime on one W×W block,
W ≤ 128: each round zeroes negligible subdiagonals (16·eps neighbour
test with the eps·‖T‖_F floor, and the entries next to a locked pair),
finds the active window [lo, hi), and either standardises a 2×2 window
(a cancellation-free rotation, or a lock when its eigenvalues are
complex) or chases one double-shift bulge through it (Wilkinson shift,
exceptional every 10 stagnant rounds). At most 40·W rounds. The input
must be upper Hessenberg.
"""
from __future__ import annotations

import functools
import math

import torch

from . import _build

__all__ = ["MAX_W", "blocks_per_sm", "plan", "schur_small", "schur_small_ref"]

MAX_W = 128        # widest block the kernel takes
# the most warps of each of the kernel's two groups (csrc/schur_small.cu
# kMaxWarps)
MAX_WARPS = MAX_W // 32

# Kernel launches since the last reset; only schur_small's CUDA branch adds
# to it, one per call (one call is the whole batch).
launches = 0


def _house3(p0: float, p1: float, p2: float):
    """``la/schur.py::_house3`` on host floats: (v1, v2, tau), v0 = 1."""
    sigma = p1 * p1 + p2 * p2
    nrm = math.sqrt(p0 * p0 + sigma)
    beta = -nrm if p0 >= 0 else nrm
    den = p0 - beta
    sden = 1.0 if den == 0 else den
    if sigma == 0:
        return 0.0, 0.0, 0.0
    tau = 0.0 if nrm == 0 else (beta - p0) / (1.0 if beta == 0 else beta)
    return p1 / sden, p2 / sden, tau


def _rot2(g1: float, g2: float):
    nrm = math.sqrt(g1 * g1 + g2 * g2)
    if nrm == 0:
        return 1.0, 0.0
    return g1 / nrm, g2 / nrm


def _apply_rot2(tq, W: int, k: int, cs: float, sn: float):
    """T ← Gᵀ·T·G, Q ← Q·G with G = [[cs, −sn], [sn, cs]] at (k, k+1), on
    tq = [T; Q] (2W, W)."""
    g = torch.tensor([[cs, -sn], [sn, cs]], dtype=tq.dtype, device=tq.device)
    tq[k:k + 2] = g.T @ tq[k:k + 2]
    tq[:, k:k + 2] = tq[:, k:k + 2] @ g


def _schur_small_one(a, max_iter: int):
    """One matrix: ``_make_kernel``'s iteration
    (``nd4js_tpu/ops/schur_small.py:105-233``) with the control and the
    reflectors' scalars on the host, and per chase step one 3-row update
    of T and one 3-column update of T and Q together (T and Q are kept
    stacked, tq = [T; Q]). Returns (t, q, locked, rounds, moves): moves
    lists the window (lo, hi) of each round that transformed T, a chase
    over [lo, hi) or a 2×2 rotation at lo = hi − 2."""
    W = a.shape[-1]
    dt = a.dtype
    eps = torch.finfo(dt).eps
    tq = torch.cat([a, torch.eye(W, dtype=dt, device=a.device)])
    t = tq[:W]
    lk = [False] * W
    it, stuck, hi_prev = 0, 0, -1
    moves = []
    while hi_prev != 0 and it < max_iter:
        # deflation scan with the norm floor, in the working precision
        d = torch.diagonal(t).abs()
        sub = torch.diagonal(t, -1)
        floor = eps * torch.sqrt((t * t).sum())
        small = sub.abs() <= torch.maximum(16 * eps * (d[:-1] + d[1:]), floor)
        jj = torch.arange(W - 1, device=a.device)
        t[jj + 1, jj] = torch.where(small, 0.0, sub)
        subl = torch.diagonal(t, -1).tolist()
        # re-zero next to locked pairs
        for j in range(W - 1):
            nbr = (j > 0 and lk[j - 1]) or lk[j + 1]
            if nbr and not lk[j] and subl[j] != 0:
                t[j + 1, j] = 0.0
                subl[j] = 0.0
        nz = [not lk[j] and subl[j] != 0 for j in range(W - 1)]
        hi = max((j + 2 for j in range(W - 1) if nz[j]), default=0)
        lo = max((j + 1 for j in range(hi - 1) if not nz[j]), default=0)
        if hi > 0 and hi - lo == 2:
            (aa, bb), (cc, dd) = t[lo:lo + 2, lo:lo + 2].tolist()
            disc = (aa - dd) * (aa - dd) + 4 * bb * cc
            if disc >= 0:
                p = 0.5 * (aa - dd)
                sq = math.sqrt(max(disc, 0.0)) * 0.5
                sgn = 1.0 if p >= 0 else -1.0
                lam_m_aa = -sgn * (abs(p) + sq)
                den = sq + abs(p)
                lam_m_dd = -sgn * bb * cc / (1.0 if den == 0 else den)
                big_b = abs(bb) >= abs(cc)
                cs, sn = _rot2(bb if big_b else lam_m_dd,
                               lam_m_aa if big_b else cc)
                _apply_rot2(tq, W, lo, cs, sn)
                t[lo + 1, lo] = 0.0
                moves.append((lo, hi))
            else:
                lk[lo] = True
        elif hi > 0:
            m = hi - 2
            blk = t[m - 1:hi, m - 1:hi].tolist()      # rows/cols m−1..hi−1
            h_mm, h_mn = blk[1][1], blk[1][2]
            h_nm, h_nn = blk[2][1], blk[2][2]
            tr = h_mm + h_nn
            det = h_mm * h_nn - h_mn * h_nm
            if stuck % 10 == 9:
                lam = h_nn + 0.75 * (abs(h_nm) + abs(blk[1][0]))
                tr, det = 2 * lam, lam * lam
            (h00, h01, _), (h10, h11, _), (_, h21, _) = \
                t[lo:lo + 3, lo:lo + 3].tolist()
            p0 = h00 * h00 + h01 * h10 - tr * h00 + det
            p1 = h10 * (h00 + h11 - tr)
            p2 = h10 * h21
            for k in range(lo, hi - 2):
                v1, v2, tau = _house3(p0, p1, p2)
                if tau != 0:
                    vt = torch.tensor([1.0, v1, v2], dtype=dt, device=a.device)
                    rows = t[k:k + 3]
                    rows.addr_(vt, vt @ rows, alpha=-tau)
                    cols = tq[:, k:k + 3]
                    cols.addr_(cols @ vt, vt, alpha=-tau)
                nxt = t[k + 1:k + 4, k].tolist()
                p0, p1 = nxt[0], nxt[1]
                p2 = nxt[2] if k + 3 < hi else 0.0
            _apply_rot2(tq, W, hi - 2, *_rot2(p0, p1))
            moves.append((lo, hi))
        if hi > 0:
            stuck = 0 if hi - lo == 2 else stuck + 1
        if hi != hi_prev:
            stuck = 0
        hi_prev = hi
        it += 1
    locked = torch.tensor([float(x) for x in lk], dtype=dt, device=a.device)
    return t, tq[W:], locked, it, moves


@functools.lru_cache(maxsize=256)
def plan(W: int, dtype: torch.dtype):
    """Launch layout of the kernel on (W, W) blocks: (ld, warps of each
    group, Q in shared memory, shared-memory bytes a block).

    ld = W rounded up to an odd number, the leading dimension of T and Q
    in shared memory (a column of 32 rows then hits 32 banks). T's group
    and Q's group each get W threads rounded up to whole warps. T, the
    locks and the scratch always sit in shared memory, Q too when both fit
    227 KB, else it is updated in place in global memory. Raises ValueError
    for W outside 1..MAX_W.
    """
    if not 1 <= W <= MAX_W:
        raise ValueError(f"schur_small: needs 1 <= W <= {MAX_W}, got {W}")
    elem = torch.finfo(dtype).bits // 8
    ld = W | 1
    nwarps = -(-W // 32)
    core = elem * (W * ld + W + MAX_WARPS + 8) + 4 * MAX_WARPS
    q_in_smem = core + elem * W * ld <= _build.SMEM_MAX
    return ld, nwarps, q_in_smem, core + (elem * W * ld if q_in_smem else 0)


def blocks_per_sm(W: int, dtype: torch.dtype) -> int:
    """Blocks of a launch on (W, W) blocks that one SM holds at once, from
    the built kernel's registers and the bytes of :func:`plan` (needs the
    card): a batch of up to that many times the SMs runs in one wave."""
    _, nwarps, _, smem = plan(W, dtype)
    return _build.library().nd4js_schur_small_blocks_per_sm(
        int(dtype == torch.float64), nwarps, smem)


def schur_small_ref(a, max_iter_factor: int = 40):
    """Plain PyTorch version of the kernel, one matrix at a time. Returns
    (t_raw, q, locked, iters) as :func:`schur_small`."""
    W = a.shape[-1]
    out = [_schur_small_one(m, max_iter_factor * W) for m in a]
    if not out:
        return (a.clone(), a.clone(), a.new_zeros(a.shape[:-1]),
                torch.zeros((0,), dtype=torch.int32, device=a.device))
    t, q, lk, its, _ = zip(*out)
    return (torch.stack(t), torch.stack(q), torch.stack(lk),
            torch.tensor(its, dtype=torch.int32, device=a.device))


def schur_small(a, max_iter_factor: int = 40):
    """Real Schur form of a batch of upper Hessenberg blocks a (Nb, W, W),
    W ≤ 128, in one launch. Returns (t_raw, q, locked, iters):

    t_raw: the quasi-triangular T (or the state at the iteration cap) with
        the chase's roundoff below the subdiagonal left in place;
    q: the accumulated orthogonal similarity, A = q·t·qᵀ;
    locked: (Nb, W) 0/1 per subdiagonal position locked as a complex pair;
    iters: (Nb,) int32 rounds taken.

    A CUDA tensor runs the kernel in the layout of :func:`plan` (or
    raises); a CPU tensor runs :func:`schur_small_ref`.
    """
    global launches
    on_card = _build.check_operand(a, "schur_small", 3)
    nb, W, W2 = a.shape
    if W != W2 or not 1 <= W <= MAX_W:
        raise ValueError(f"schur_small: needs square blocks of at most "
                         f"{MAX_W}, got {tuple(a.shape)}")
    if not on_card:
        return schur_small_ref(a, max_iter_factor)
    ld, nwarps, q_in_smem, smem = plan(W, a.dtype)
    a = a.contiguous()
    t = torch.empty_like(a)
    q = torch.empty_like(a)
    lk = a.new_empty((nb, W))
    its = torch.empty((nb,), dtype=torch.int32, device=a.device)
    f64 = a.dtype == torch.float64
    _build.launch("nd4js_schur_small_f64" if f64 else "nd4js_schur_small_f32",
                  a.device, a, t, q, lk, its, nb, W, max_iter_factor * W, ld,
                  nwarps, int(q_in_smem), smem)
    launches += 1
    return t, q, lk, its

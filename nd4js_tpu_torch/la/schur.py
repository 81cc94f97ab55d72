"""Real Schur decomposition by multishift Francis QR with aggressive early
deflation, and eigenvalues and eigenvectors from it: the counterpart of
``nd4js_tpu/la/schur.py``.

``schur_decomp`` reduces to Hessenberg form and then:

* 8 ≤ n ≤ 128: one ``schur_small`` launch for the whole batch, one block
  per matrix (the window is the whole matrix);
* otherwise a host loop per matrix, the JAX package's ``while_loop``
  state machine read one iteration at a time: each iteration zeroes the
  negligible subdiagonals (and those next to a locked complex pair), reads
  the active window [lo, hi) to the host, and takes one branch:
  a 2×2 window standardises every isolated 2×2 block at once; a window of
  at most 128 is resolved whole by ``schur_small`` (``small_win``); for
  n ≥ 192 a window wide enough takes AED on its trailing 48×48 block and,
  unless that deflated enough, a sweep of 16 bulges with the AED window's
  shifts (``chase_ms``); anything else, and every 10th stagnant
  iteration's exceptional shift, takes one classic double-shift chase.
  The chases run one ``bulge_chase_steps`` launch per slide of a 128×128
  window along the diagonal, plus three GEMMs off the window.

Under the JAX package's ``vmap`` every ``lax.cond`` is a select and a
finished element's carry is frozen, so running the loop one matrix at a
time gives what its batched run gives. The matrix is padded with an
inert identity (zero subdiagonals): 3·NB rows on the left for the bulge
train and W on the right, so every window slice lies inside it.

``schur_eigen`` turns (Q, T) into complex triangular form, solves for all
eigenvectors with ``trevc_solve`` (n > 128, n % 64 == 0), its plain
blocked form (other n > 128) or the unblocked loop (n ≤ 128), refines the
columns whose residual is above the healthy band by one inverse-iteration
pass, and normalises.

Every slice that was a ``lax.dynamic_slice`` goes through
:func:`_dslice`, which places its start as JAX does (clamped so that the
slice fits), so that a slice is never cut short.
"""
from __future__ import annotations

import torch

from ..config import default_float_for
from ..convert import as_tensor
from ..core import cpx
from ..core.batch import batched
from ..core.debug import dcheck_finite
from ..core.mm import mm, mt
from ..ops.bulge_chase import bulge_chase_steps
from ..ops.schur_small import schur_small
from ..ops.trevc_solve import trevc_solve, trevc_solve_ref
from .hessenberg import _hessenberg_core

__all__ = ["schur_decomp", "schur_eigenvals", "schur_eigen"]

# the JAX package's multishift knobs at their shipped defaults
# (nd4js_tpu/la/schur.py:54-63): bulges per sweep, AED window, the nibble
# (skip the sweep when AED deflated ≥ NS/_NIBBLE), chase window
_NB = 16
_SW = 48
_NIBBLE = 4
_WCHASE = 128
_SMW = 128         # widest window small_win resolves whole

# What the host loops did since the last reset: loop iterations, AED calls
# and the sweeps after them, small_win resolutions, standardize2 calls,
# classic chases, window slides (one bulge_chase_steps call each), and the
# matrices whose eigenvectors took the refinement.
branches = {"iterations": 0, "aed": 0, "sweep": 0, "small_win": 0,
            "standardize2": 0, "chase": 0, "slides": 0, "refine": 0}


def _dslice_start(start: int, size: int, dim: int) -> int:
    """``lax.dynamic_slice``'s start: a negative one counts from the end,
    then it is clamped so that the slice fits."""
    if start < 0:
        start += dim
    return min(max(start, 0), dim - size)


def _dslice(x, starts, sizes):
    """The (sizes) block of x at starts, each start clamped as
    ``lax.dynamic_slice`` clamps it. A view."""
    return x[tuple(slice(b, b + n) for b, n in (
        (_dslice_start(s, n, d), n) for s, n, d in zip(starts, sizes, x.shape)
    ))]


def _get(h, i: int, j: int):
    """h[i, j] with JAX's clamping, as a 0-d tensor of its own."""
    return _dslice(h, (i, j), (1, 1))[0, 0].clone()


def _subdiag_floor(h, eps):
    """Norm-relative deflation floor eps·‖H‖_F
    (``nd4js_tpu/la/schur.py:68-77``)."""
    return eps * torch.sqrt((h * h).sum((-2, -1)))


def _subdiag(h):
    return torch.diagonal(h, offset=-1, dim1=-2, dim2=-1)


def _sig_subdiag(h, eps):
    """Subdiagonal entries above the deflation test: 16·eps·(neighbouring
    |diagonal|s) and the norm floor."""
    dh = torch.diagonal(h).abs()
    return _subdiag(h).abs() > torch.maximum(16 * eps * (dh[:-1] + dh[1:]),
                                             _subdiag_floor(h, eps))


def _kill_zero(h, locked, eps):
    """The global deflation pass (``_zero_small_subdiags``) and the re-zero
    of unlocked subdiagonals next to a locked pair: a new h."""
    n = h.shape[-1]
    small = ~_sig_subdiag(h, eps)
    nbr = torch.zeros_like(locked)
    nbr[:-1] |= locked[1:]
    nbr[1:] |= locked[:-1]
    kill = small | (nbr & ~locked)
    idx = torch.arange(n - 1, device=h.device)
    h = h.clone()
    h[idx + 1, idx] = torch.where(kill, 0.0, _subdiag(h))
    return h


def _window(h, locked):
    """(lo, hi) of the active window as 0-d device tensors: hi − 2 the last
    live subdiagonal, lo after the last dead one below it."""
    idx = torch.arange(h.shape[-1] - 1, device=h.device)
    nz = torch.where(locked, 0.0, _subdiag(h)) != 0
    hi = torch.where(nz, idx + 2, 0).max()
    lo = torch.where((idx < hi - 1) & ~nz, idx + 1, 0).max()
    return lo, hi


def _house3(p0, p1, p2):
    """Householder annihilating components 1, 2 of (p0, p1, p2), on 0-d
    tensors: (v0, v1, v2, tau) (``nd4js_tpu/la/schur.py:100-113``)."""
    sigma = p1 * p1 + p2 * p2
    nrm = torch.sqrt(p0 * p0 + sigma)
    beta = torch.where(p0 >= 0, -nrm, nrm)
    den = p0 - beta
    safe_den = torch.where(den == 0, 1.0, den)
    v1 = torch.where(sigma == 0, 0.0, p1 / safe_den)
    v2 = torch.where(sigma == 0, 0.0, p2 / safe_den)
    safe_beta = torch.where(beta == 0, 1.0, beta)
    tau = torch.where(nrm == 0, 0.0, (beta - p0) / safe_beta)
    tau = torch.where(sigma == 0, 0.0, tau)
    return torch.ones_like(p0), v1, v2, tau


def _apply_house3_rows(h, k: int, v, tau):
    """rows k..k+2 of h ← (I − tau·v·vᵀ)·rows, in place."""
    rows = _dslice(h, (k, 0), (3, h.shape[1]))
    rows -= v[:, None] * (tau * (v @ rows))[None, :]


def _apply_house3_cols(h, k: int, v, tau):
    cols = _dslice(h, (0, k), (h.shape[0], 3))
    cols -= (tau * (cols @ v))[:, None] * v[None, :]


def _apply_rot2_rows(h, k: int, cs, sn):
    rows = _dslice(h, (k, 0), (2, h.shape[1]))
    r0, r1 = rows[0].clone(), rows[1].clone()
    rows[0] = cs * r0 + sn * r1
    rows[1] = -sn * r0 + cs * r1


def _apply_rot2_cols(h, k: int, cs, sn):
    cols = _dslice(h, (0, k), (h.shape[0], 2))
    c0, c1 = cols[:, 0].clone(), cols[:, 1].clone()
    cols[:, 0] = cs * c0 + sn * c1
    cols[:, 1] = -sn * c0 + cs * c1


def _rot2(g1, g2):
    nrm = torch.sqrt(g1 * g1 + g2 * g2)
    safe = torch.where(nrm == 0, 1.0, nrm)
    return (torch.where(nrm == 0, 1.0, g1 / safe),
            torch.where(nrm == 0, 0.0, g2 / safe))


def _std2_rot(aa, bb, cc, dd):
    """The cancellation-free rotation that triangularises [[aa, bb], [cc,
    dd]] when its discriminant is ≥ 0: λ−aa = −sgn(p)(|p|+sq) and λ−dd =
    −sgn(p)·bc/(sq+|p|), p = (aa−dd)/2. Returns (cs, sn, disc)."""
    disc = (aa - dd) * (aa - dd) + 4 * bb * cc
    p = 0.5 * (aa - dd)
    sq = torch.sqrt(torch.clamp(disc, min=0.0)) * 0.5
    sgn = torch.where(p >= 0, 1.0, -1.0)
    lam_m_aa = -sgn * (p.abs() + sq)
    den = sq + p.abs()
    lam_m_dd = -sgn * bb * cc / torch.where(den == 0, 1.0, den)
    big_b = bb.abs() >= cc.abs()
    cs, sn = _rot2(torch.where(big_b, bb, lam_m_dd),
                   torch.where(big_b, lam_m_aa, cc))
    return cs, sn, disc


def _transform_window(h, q, w0: int, u):
    """H ← Uᵀ·H on rows w0.., H ← H·U and Q ← Q·U on columns w0.. for the
    (W, W) window transform U, three GEMMs against the full matrix, in
    place."""
    W = u.shape[-1]
    s = _dslice_start(w0, W, h.shape[0])
    h[s:s + W, :] = mm(mt(u), h[s:s + W, :])
    h[:, s:s + W] = mm(h[:, s:s + W], u)
    q[:, s:s + W] = mm(q[:, s:s + W], u)


def _chase_multishift(hp, qp, lo: int, hi: int, trs, dets, W: int, NB: int,
                      n: int):
    """Small-bulge multishift sweep (``nd4js_tpu/la/schur.py:157-223``):
    NB double-shift bulges 3 rows apart chased through [lo, hi), one
    ``bulge_chase_steps`` launch per slide of the (W, W) window, whose
    accumulated transform reaches the rows and columns off the window and
    Q as three GEMMs. NB = 1 is the classic single-bulge chase. hp/qp are
    updated in place."""
    OFF = 3 * (NB - 1)
    SL = W - 3 * NB
    n_slides = -(-(n - 1 + 3 * NB) // SL)
    shifts = torch.stack([trs.to(hp.dtype), dets.to(hp.dtype)], dim=1)
    P = hp.new_zeros((NB, 3))
    for s in range(n_slides):
        w0 = lo + s * SL - OFF
        if w0 > hi - 2:        # the tail bulge has left: so have the rest
            break
        b = _dslice(hp, (w0, w0), (W, W))
        branches["slides"] += 1
        v, P = bulge_chase_steps(b, P, shifts, lo + s * SL, lo, hi, SL,
                                 seed=s == 0)
        _transform_window(hp, qp, w0, v)


def _house_seg(x, head: int, limit: int, aw: int):
    """Householder compressing rows [head, limit) of x into row head
    (``nd4js_tpu/la/schur.py:226-245``)."""
    idxr = torch.arange(aw, device=x.device)
    inseg = (idxr >= head) & (idxr < limit)
    seg = torch.where(inseg, x, 0.0)
    h0 = seg[head]
    sigma = torch.clamp((seg * seg).sum() - h0 * h0, min=0.0)
    nrm = torch.sqrt(h0 * h0 + sigma)
    beta = torch.where(h0 >= 0, -nrm, nrm)
    den = h0 - beta
    safe_den = torch.where(den == 0, 1.0, den)
    v = torch.where(inseg & (idxr != head), seg / safe_den, 0.0)
    v = v + torch.where(inseg & (idxr == head), 1.0, 0.0)
    safe_beta = torch.where(beta == 0, 1.0, beta)
    tau = torch.where((sigma == 0) | (nrm == 0), 0.0, (beta - h0) / safe_beta)
    return v, tau


def _window_schur(blk, eps):
    """``schur_small`` of one window: (T cleaned below the subdiagonal, Q,
    whether the raw T converged: its junk below the subdiagonal within
    16·eps·max|T|)."""
    tw_raw, qw, _, _ = schur_small(blk[None].contiguous())
    tw_raw, qw = tw_raw[0], qw[0]
    W = blk.shape[-1]
    r = torch.arange(W, device=blk.device)
    keep = r[:, None] <= r[None, :] + 1
    tw = torch.where(keep, tw_raw, 0.0)
    wjunk = torch.where(keep, 0.0, tw_raw).abs().max()
    wconv = wjunk <= 16 * eps * torch.clamp(tw.abs().max(),
                                            min=torch.finfo(blk.dtype).tiny)
    return tw, qw, wconv


def _aed(h, q, locked, lo: int, hi: int, AW: int, NS: int, eps):
    """Aggressive early deflation (``nd4js_tpu/la/schur.py:248-368``):
    the real Schur form of the trailing AW×AW window, the spike
    s·Q_w[0, :] tested block by block from the bottom, and, where blocks
    deflated, the window similarity committed and the surviving rows
    re-Hessenbergised. Updates h, q, locked in place; returns (d, trs,
    dets): the deflation count (0 when the window did not converge) and
    NS/2 double-shift polynomials from the surviving window eigenvalues."""
    dt = h.dtype
    tiny = torch.finfo(dt).tiny
    aw = AW
    w0 = hi - aw
    sw = _dslice(h, (w0, w0), (aw, aw))
    s_spike = _get(h, w0, w0 - 1)
    tw, qw, wconv = _window_schur(sw, eps)
    sp = s_spike * qw[0, :]
    idxa = torch.arange(aw, device=h.device)
    dvec = torch.diagonal(tw).abs()
    zero1 = tw.new_zeros((1,))
    sub = torch.cat([_subdiag(tw), zero1])        # sub[j] = T[j+1, j]
    subm = torch.cat([zero1, _subdiag(tw)])       # subm[j] = T[j, j−1]
    isstart = sub != 0
    is2nd = subm != 0
    blkmag = dvec + torch.where(isstart, torch.roll(dvec, -1), 0.0) \
        + torch.where(is2nd, torch.roll(dvec, 1), 0.0)
    tol = 8 * eps * torch.clamp(blkmag, min=tiny)
    ok = sp.abs() <= tol
    # a 2×2 block deflates only whole, and never inside coupled junk
    sane = ~(isstart & is2nd)
    ok = ok & sane & (~isstart | torch.roll(sane, -1)) \
        & (~is2nd | torch.roll(sane, 1))
    okblk = ok & (~isstart | torch.roll(ok, -1)) & (~is2nd | torch.roll(ok, 1))
    lastbad = torch.where(~okblk, idxa, -1).max()
    d = torch.where(wconv, aw - 1 - lastbad, 0)
    d = int(d)                                       # the host read
    if d > 0:
        spm = torch.where(idxa < aw - d, sp, 0.0)
        mloc = torch.cat([spm[:, None], tw], dim=1)  # (aw, aw + 1)
        z = torch.eye(aw, dtype=dt, device=h.device)
        # columns whose live segment has ≤ 1 entry get τ = 0: left out
        for c in range(aw - d - 1):
            v, tau = _house_seg(mloc[:, c], c, aw - d, aw)
            mloc = mloc - v[:, None] * (tau * (v @ mloc))[None, :]
            mw = mloc[:, 1:]
            mw = mw - (tau * (mw @ v))[:, None] * v[None, :]
            mloc = torch.cat([mloc[:, :1], mw], dim=1)
            z = z - tau * torch.outer(z @ v, v)
        _transform_window(h, q, w0, mm(qw, z))
        # the spike column with its deflated tail zeroed
        s0 = _dslice_start(w0, aw, h.shape[0])
        c0 = _dslice_start(w0 - 1, 1, h.shape[1])
        h[s0:s0 + aw, c0] = mloc[:, 0]
        # lock the deflated complex pairs, significant subdiagonals only
        jall = torch.arange(h.shape[0] - 1, device=h.device)
        region = (jall >= hi - d) & (jall < hi - 1)
        locked |= region & _sig_subdiag(h, eps)
    # fresh shifts: the trailing NS eigenvalues of the surviving window,
    # not splitting a 2×2 pair at the selection boundary
    re, im = _block_eigvals_reim(tw)
    start = torch.tensor(max(aw - d - NS, 0), device=h.device)
    start = start - ((start > 0) & (subm[start] != 0)).long()
    sel = torch.clamp(start, 0, aw - NS) + torch.arange(NS, device=h.device)
    rr, ri = re[sel], im[sel]
    trs = rr[0::2] + rr[1::2]
    dets = rr[0::2] * rr[1::2] - ri[0::2] * ri[1::2]
    return d, trs, dets


def _iso_pairs(h, locked):
    """Isolated unconverged 2×2 blocks and their standardising rotations,
    at every pair position at once (``nd4js_tpu/la/schur.py:468-500``)."""
    sd = _subdiag(h)
    live = torch.where(locked, 0.0, sd) != 0
    tt = torch.ones((1,), dtype=torch.bool, device=h.device)
    left_ok = torch.cat([tt, ~live[:-1]])
    right_ok = torch.cat([~live[1:], tt])
    iso = live & left_ok & right_ok
    d0 = torch.diagonal(h)
    cs, sn, disc = _std2_rot(d0[:-1], torch.diagonal(h, offset=1), sd, d0[1:])
    rot = iso & (disc >= 0)
    lock_new = iso & (disc < 0)
    return rot, lock_new, torch.where(rot, cs, 1.0), torch.where(rot, sn, 0.0)


def _standardize2(h, q, locked, eps):
    """Standardise every isolated unconverged 2×2 block at once, rounds
    until none is left (at most 64), each followed by the deflation pass
    (``nd4js_tpu/la/schur.py:502-578``). Returns (h, q, locked)."""
    npad = h.shape[0]
    ff = torch.zeros((1,), dtype=torch.bool, device=h.device)
    one = h.new_ones((1,))
    zero = h.new_zeros((1,))
    idx = torch.arange(npad - 1, device=h.device)
    for _ in range(64):
        rot, lock_new, cs, sn = _iso_pairs(h, locked)
        if not bool((rot | lock_new).any()):          # the host read
            break
        # row i is the first of pair i, row i+1 the second (disjoint)
        first = torch.cat([rot, ff])[:, None]
        second = torch.cat([ff, rot])[:, None]
        cs_f = torch.cat([cs, one])[:, None]
        sn_f = torch.cat([sn, zero])[:, None]
        cs_s = torch.cat([one, cs])[:, None]
        sn_s = torch.cat([zero, sn])[:, None]
        # rows: Gᵀ·H
        h = torch.where(first, cs_f * h + sn_f * torch.roll(h, -1, 0),
                        torch.where(second,
                                    cs_s * h - sn_s * torch.roll(h, 1, 0), h))
        # columns: H·G and Q·G
        fc, sc = first.T, second.T
        cfr, sfr, csr, ssr = cs_f.T, sn_f.T, cs_s.T, sn_s.T
        h, q = (torch.where(fc, cfr * m + sfr * torch.roll(m, -1, 1),
                            torch.where(sc,
                                        csr * m - ssr * torch.roll(m, 1, 1), m))
                for m in (h, q))
        h[idx + 1, idx] = torch.where(rot, 0.0, _subdiag(h))
        locked = locked | lock_new
        h = _kill_zero(h, locked, eps)
    return h, q, locked


def _small_win(h, q, locked, lo: int, hi: int, eps):
    """Resolve the whole active window (3 ≤ hi − lo ≤ 128) by one
    ``schur_small`` launch and three GEMMs (``nd4js_tpu/la/schur.py:
    691-753``): the window padded to 128 with the identity outside
    [lo, hi), its similarity committed when it converged, its clean T
    spliced in and its surviving complex pairs locked. Updates in place;
    returns whether it converged."""
    npad = h.shape[0]
    W = _SMW
    w0 = max(hi - W, 0)
    ridx = w0 + torch.arange(W, device=h.device)
    inwin = (ridx >= lo) & (ridx < hi)
    m2 = inwin[:, None] & inwin[None, :]
    eyeS = torch.eye(W, dtype=h.dtype, device=h.device)
    blk = torch.where(m2, _dslice(h, (w0, w0), (W, W)), eyeS)
    tw, qw, wconv = _window_schur(blk, eps)
    wconv = bool(wconv)                               # the host read
    if wconv:
        _transform_window(h, q, w0, qw)
        s = _dslice_start(w0, W, npad)
        bw = h[s:s + W, s:s + W]
        bw.copy_(torch.where(m2, tw, bw))
        jall = torch.arange(npad - 1, device=h.device)
        region = (jall >= lo) & (jall < hi - 1)
        locked |= region & _sig_subdiag(h, eps)
    return wconv


def _exc_shift(h, m: int, hi: int, exc: bool):
    """(tr, det) of the trailing 2×2 of the window, or of the exceptional
    shift λ = H[n,n] + 0.75·(|H[n,m]| + |H[m,m−1]|) (dlahqr)."""
    h_mm, h_nn = _get(h, m, m), _get(h, hi - 1, hi - 1)
    h_mn, h_nm = _get(h, m, hi - 1), _get(h, hi - 1, m)
    if exc:
        s_mag = h_nm.abs() + (_get(h, m, max(m - 1, 0)).abs() if m >= 1
                              else torch.zeros_like(h_nm))
        lam = h_nn + 0.75 * s_mag
        return 2 * lam, lam * lam
    return h_mm + h_nn, h_mm * h_nn - h_mn * h_nm


def _chase_unwindowed(h, q, lo: int, hi: int, tr, det, n: int):
    """One classic double-shift chase on the unpadded matrix (n < 8), step
    by step, and the final 2-vector rotation at hi − 2."""
    h00, h01 = _get(h, lo, lo), _get(h, lo, lo + 1)
    h10, h11 = _get(h, lo + 1, lo), _get(h, lo + 1, lo + 1)
    h21 = _get(h, lo + 2, lo + 1)
    p0 = h00 * h00 + h01 * h10 - tr * h00 + det
    p1 = h10 * (h00 + h11 - tr)
    p2 = h10 * h21
    for k in range(lo, max(hi - 2, lo)):
        v0, v1, v2, tau = _house3(p0, p1, p2)
        v = torch.stack([v0, v1, v2])
        _apply_house3_rows(h, k, v, tau)
        _apply_house3_cols(h, k, v, tau)
        _apply_house3_cols(q, k, v, tau)
        p0, p1 = _get(h, k + 1, k), _get(h, k + 2, k)
        p2 = _get(h, min(k + 3, n - 1), k) if k + 3 < hi \
            else torch.zeros_like(p0)
    cs, sn = _rot2(p0, p1)
    _apply_rot2_rows(h, hi - 2, cs, sn)
    _apply_rot2_cols(h, hi - 2, cs, sn)
    _apply_rot2_cols(q, hi - 2, cs, sn)


def _schur_loop(h, q, max_iter_factor: int):
    """The windowed state machine on one Hessenberg matrix h (n, n), n ≥ 3,
    with its Q (``nd4js_tpu/la/schur.py:424-844``). Returns (T, Q)."""
    n = h.shape[-1]
    dt = h.dtype
    eps = torch.finfo(dt).eps
    use_win = n >= 8
    NB, SW = _NB, _SW
    use_ms = n >= 192
    W = min(max(_WCHASE, 3 * NB + 16) if use_ms else 128, n)
    P0 = 3 * NB if use_ms else 0
    npad = P0 + n + W if use_win else n
    if use_win:
        pad = torch.eye(npad, dtype=dt, device=h.device)
        hp, qp = pad.clone(), pad
        hp[P0:P0 + n, P0:P0 + n] = h
        qp[P0:P0 + n, P0:P0 + n] = q
        h, q = hp, qp
    else:
        h, q = h.clone(), q.clone()
    use_small = use_win and npad >= _SMW
    max_iter = max_iter_factor * n
    locked = torch.zeros((npad - 1,), dtype=torch.bool, device=h.device)
    it, stuck, hi_prev = 0, 0, -1
    while it < max_iter:
        # the while_loop's test reads the window of the carry; the body's
        # window comes after the deflation pass: one read for both
        hk = _kill_zero(h, locked, eps)
        lo, hi = _window(hk, locked)
        _, hi_c = _window(h, locked)
        hi_c, lo, hi = torch.stack([hi_c, lo, hi]).tolist()
        if hi_c == 0:
            break
        h = hk
        if hi > 0:
            exc = stuck % 10 == 9
            if hi - lo == 2:
                branches["standardize2"] += 1
                h, q, locked = _standardize2(h, q, locked, eps)
                stuck = 0
            elif use_small and hi - lo <= _SMW and not exc:
                branches["small_win"] += 1
                stuck = 0 if _small_win(h, q, locked, lo, hi, eps) \
                    else stuck + 1
            elif use_ms and hi - lo >= SW + 3 * NB + 8 and not exc:
                branches["aed"] += 1
                NS = 2 * NB
                d, trs, dets = _aed(h, q, locked, lo, hi, SW, NS, eps)
                if d < NS // _NIBBLE:
                    branches["sweep"] += 1
                    _chase_multishift(h, q, lo, hi - d, trs, dets, W, NB, n)
                stuck += 1
            else:
                branches["chase"] += 1
                tr, det = _exc_shift(h, hi - 2, hi, exc)
                if use_win:
                    _chase_multishift(h, q, lo, hi, tr[None], det[None], W, 1,
                                      n)
                else:
                    _chase_unwindowed(h, q, lo, hi, tr, det, n)
                stuck += 1
        if hi != hi_prev:
            stuck = 0
        hi_prev = hi
        it += 1
    branches["iterations"] += it
    if use_win:
        h, q = h[P0:P0 + n, P0:P0 + n], q[P0:P0 + n, P0:P0 + n]
    r = torch.arange(n, device=h.device)
    return torch.where(r[:, None] <= r[None, :] + 1, h, 0.0), q


def _schur_2x2(a):
    """Closed-form standardisation of a batch of 2×2 matrices
    (``nd4js_tpu/la/schur.py:378-405``): (T, G)."""
    cs, sn, disc = _std2_rot(a[:, 0, 0], a[:, 0, 1], a[:, 1, 0], a[:, 1, 1])
    real = disc >= 0
    cs = torch.where(real, cs, 1.0)
    sn = torch.where(real, sn, 0.0)
    g = torch.stack([torch.stack([cs, -sn], -1), torch.stack([sn, cs], -1)],
                    -2)
    t = mm(mm(mt(g), a), g)
    t[:, 1, 0] = torch.where(real, 0.0, t[:, 1, 0])
    return t, g


def _schur_core(a, max_iter_factor: int = 40):
    """Real Schur form of a batch a (B, n, n): (T, Q). The raw T that
    AED and small_win measure comes from ``schur_small`` itself."""
    B, n, _ = a.shape
    if n == 1:
        return a.clone(), torch.ones_like(a)
    if n == 2:
        return _schur_2x2(a)
    h, q = _hessenberg_core(a)
    if 8 <= n <= 128:
        # the whole iteration in one launch for the whole batch
        tk, qk, _, its = schur_small(h.contiguous(), max_iter_factor)
        branches["iterations"] += int(its.sum())
        q = mm(q, qk)
        r = torch.arange(n, device=a.device)
        return torch.where(r[:, None] <= r[None, :] + 1, tk, 0.0), q
    if B == 0 and n < 8:
        # an empty batch, shaped as the reference returns it (at n ≥ 129
        # the reference refuses one, and so does this loop)
        return h, q
    outs = [_schur_loop(h[b], q[b], max_iter_factor) for b in range(B)]
    t, qq = zip(*outs)
    return torch.stack(t), torch.stack(qq)


@batched((2,))
def _schur(a, max_iter_factor: int):
    a3 = a.reshape((-1,) + a.shape[-2:])
    t, q = _schur_core(a3, max_iter_factor)
    return q.reshape(a.shape), t.reshape(a.shape)


def schur_decomp(a, max_iter_factor: int = 40, device=None):
    """[Q, T] with A = Q·T·Qᵀ, T quasi-upper-triangular (1×1 blocks for
    real eigenvalues, 2×2 for complex pairs)
    (``nd4js_tpu/la/schur.py:848``). Batched over leading dims. An
    array-like ``a`` goes to ``device`` (default
    ``config.default_device``)."""
    a = as_tensor(a, device)
    if a.shape[-1] != a.shape[-2]:
        raise ValueError("schur_decomp requires square matrices")
    q, t = _schur(a.to(default_float_for(a.dtype)), max_iter_factor)
    dcheck_finite((q, t), "schur_decomp (q, t)")
    return q, t


def _block_eigvals_reim(t):
    """Eigenvalues of quasi-triangular T over the diagonal, batched over
    leading dims (``nd4js_tpu/la/schur.py:862-898``): (re, im)."""
    d = torch.diagonal(t, dim1=-2, dim2=-1)
    sub = torch.diagonal(t, offset=-1, dim1=-2, dim2=-1)
    sup = torch.diagonal(t, offset=1, dim1=-2, dim2=-1)
    pad1 = t.new_zeros(sub.shape[:-1] + (1,))
    sub = torch.cat([sub, pad1], -1)
    sup = torch.cat([sup, pad1], -1)
    # a 2×2 block starts at i where the subdiagonal is significant
    eps = torch.finfo(t.dtype).eps
    dn_ = torch.cat([d[..., 1:].abs(), pad1], -1)
    floor = eps * torch.sqrt((t * t).sum((-2, -1)))
    is_start = sub.abs() > torch.maximum(16 * eps * (d.abs() + dn_),
                                         floor[..., None])
    padb = torch.zeros(is_start.shape[:-1] + (1,), dtype=torch.bool,
                       device=t.device)
    is_second = torch.cat([padb, is_start[..., :-1]], -1)
    dnext = torch.cat([d[..., 1:], pad1], -1)
    dprev = torch.cat([pad1, d[..., :-1]], -1)
    bc_next = sup * sub
    bc_prev = torch.cat([pad1, bc_next[..., :-1]], -1)
    mu_s = (d + dnext) * 0.5
    disc_s = (d - dnext) * (d - dnext) * 0.25 + bc_next
    mu_p = (dprev + d) * 0.5
    disc_p = (dprev - d) * (dprev - d) * 0.25 + bc_prev
    sq_s = torch.sqrt(disc_s.abs())
    sq_p = torch.sqrt(disc_p.abs())
    re = torch.where(is_start, torch.where(disc_s >= 0, mu_s + sq_s, mu_s),
                     torch.where(is_second,
                                 torch.where(disc_p >= 0, mu_p - sq_p, mu_p),
                                 d))
    im = torch.where(is_start, torch.where(disc_s >= 0, 0.0, sq_s),
                     torch.where(is_second,
                                 torch.where(disc_p >= 0, 0.0, -sq_p), 0.0))
    return re, im


def schur_eigenvals(t, split: bool = False, device=None):
    """Eigenvalues from a real Schur form T (``nd4js_tpu/la/schur.py:901``).
    ``split=True`` returns a (re, im) pair of real tensors, ``split=False``
    one complex tensor. An array-like ``t`` goes to ``device`` (default
    ``config.default_device``)."""
    t = as_tensor(t, device)
    lam = _block_eigvals_reim(t.to(default_float_for(t.dtype)))
    return lam if split else cpx.to_complex(lam)


def _complex_triangularize_reim(q, t):
    """Real quasi-triangular (Q, T) (B, n, n) → complex triangular (Qc, Tc)
    in split-complex form: each 2×2 complex-pair block diagonalised by a
    unitary rotation (``nd4js_tpu/la/schur.py:910-960``). Returns (qc, tc,
    lam)."""
    n = t.shape[-1]
    dt = t.dtype
    B = t.shape[0]
    sub = torch.diagonal(t, offset=-1, dim1=-2, dim2=-1)
    pad1 = t.new_zeros((B, 1))
    d_ = torch.diagonal(t, dim1=-2, dim2=-1).abs()
    eps_ = torch.finfo(dt).eps
    sig = sub.abs() > torch.maximum(16 * eps_ * (d_[:, :-1] + d_[:, 1:]),
                                    _subdiag_floor(t, eps_)[:, None])
    is_start = torch.cat([sig, torch.zeros((B, 1), dtype=torch.bool,
                                           device=t.device)], -1)
    lam = _block_eigvals_reim(t)
    d = torch.diagonal(t, dim1=-2, dim2=-1)
    sup = torch.cat([torch.diagonal(t, offset=1, dim1=-2, dim2=-1), pad1], -1)
    subp = torch.cat([sub, pad1], -1)
    dn = torch.cat([d[:, 1:], pad1], -1)
    # eigenvector of [[a, b], [c, d]] for λ: (b, λ−a) or (λ−d, c)
    use_b = sup.abs() >= subp.abs()
    v1 = cpx.where(use_b, cpx.cpx(sup), cpx.sub(lam, cpx.cpx(dn)))
    v2 = cpx.where(use_b, cpx.sub(lam, cpx.cpx(d)), cpx.cpx(subp))
    nrm = torch.sqrt(cpx.abs2(v1) + cpx.abs2(v2))
    safe = torch.where(nrm == 0, 1.0, nrm)
    v1 = cpx.scale(v1, 1 / safe)
    v2 = cpx.scale(v2, 1 / safe)
    # unitary block-diagonal G: rows i, i+1 get [[v1, −conj(v2)],
    # [v2, conj(v1)]] where a block starts at i
    is_second = torch.cat([torch.zeros((B, 1), dtype=torch.bool,
                                       device=t.device), is_start[:, :-1]], -1)
    v1_prev = (torch.cat([pad1 + 1, v1[0][:, :-1]], -1),
               torch.cat([pad1, v1[1][:, :-1]], -1))
    gd_re = torch.where(is_start, v1[0],
                        torch.where(is_second, v1_prev[0], 1.0))
    gd_im = torch.where(is_start, v1[1],
                        torch.where(is_second, -v1_prev[1], 0.0))
    st = is_start[:, :-1]
    low_re = torch.where(st, v2[0][:, :-1], 0.0)
    low_im = torch.where(st, v2[1][:, :-1], 0.0)
    up_re = torch.where(st, -v2[0][:, :-1], 0.0)
    up_im = torch.where(st, v2[1][:, :-1], 0.0)
    de = torch.diag_embed
    g = (de(gd_re) + de(low_re, -1) + de(up_re, 1),
         de(gd_im) + de(low_im, -1) + de(up_im, 1))
    gh = (mt(g[0]), -mt(g[1]))
    tc = cpx.matmul(cpx.matmul(gh, cpx.cpx(t)), g)
    qc = cpx.matmul(cpx.cpx(q), g)
    r = torch.arange(n, device=t.device)
    upper = r[:, None] <= r[None, :]
    tc = (torch.where(upper, tc[0], 0.0), torch.where(upper, tc[1], 0.0))
    lam_out = (torch.diagonal(tc[0], dim1=-2, dim2=-1),
               torch.diagonal(tc[1], dim1=-2, dim2=-1))
    return qc, tc, lam_out


def _refine_row(tii, lam, smallnum, acc, rhs):
    """One row of the refinement solve: (rhs − acc)/(T[i, i] − λ) with
    |den| < smallnum clamped, then the 1e18 growth factor."""
    den = (tii[0][:, None] - lam[0], tii[1][:, None] - lam[1])
    clamp = cpx.cabs(den) < smallnum
    den = (torch.where(clamp, smallnum, den[0]),
           torch.where(clamp, 0.0, den[1]))
    yi = cpx.div(cpx.sub(rhs, acc), den)
    m = torch.maximum(yi[0].abs(), yi[1].abs())
    return yi, torch.where(m > 1e18, 1.0 / torch.where(m > 1e18, m, 1.0), 1.0)


def _trevc_refine(tc, lam, smallnum, xs, nbk: int):
    """One inverse-iteration pass, (Tc − λ_k)·y_k = x_k for every column by
    backward substitution in row blocks of nbk (``_trevc_refine_blocked``,
    ``nd4js_tpu/la/schur.py:1038-1104``; nbk = n is the unblocked loop
    of ``:1210-1236``), batched. Returns y."""
    B, n, _ = tc[0].shape
    small = smallnum[:, None]
    y = (tc[0].new_zeros((B, n, n)), tc[0].new_zeros((B, n, n)))
    xs = (xs[0].clone(), xs[1].clone())
    b1 = n
    while b1 > 0:
        b0 = max(0, b1 - nbk)
        nb = b1 - b0
        tb = (tc[0][:, b0:b1, b0:b1], tc[1][:, b0:b1, b0:b1])
        accp = cpx.matmul((tc[0][:, b0:b1, b1:], tc[1][:, b0:b1, b1:]),
                          (y[0][:, b1:], y[1][:, b1:]))
        yb = (y[0][:, b0:b1].clone(), y[1][:, b0:b1].clone())
        xsb = (xs[0][:, b0:b1].clone(), xs[1][:, b0:b1].clone())
        ftot = tc[0].new_ones((B, n))
        for il in range(nb - 1, -1, -1):
            trow = (tb[0][:, il, il + 1:, None], tb[1][:, il, il + 1:, None])
            prod = cpx.mul(trow, (yb[0][:, il + 1:], yb[1][:, il + 1:]))
            acc = (prod[0].sum(1) + accp[0][:, il],
                   prod[1].sum(1) + accp[1][:, il])
            yi, f = _refine_row((tb[0][:, il, il], tb[1][:, il, il]), lam,
                                small, acc, (xsb[0][:, il], xsb[1][:, il]))
            fr = f[:, None, :]
            yb = (yb[0] * fr, yb[1] * fr)
            yb[0][:, il] = yi[0] * f
            yb[1][:, il] = yi[1] * f
            accp = (accp[0] * fr, accp[1] * fr)
            xsb = (xsb[0] * fr, xsb[1] * fr)
            ftot = ftot * f
        fr = ftot[:, None, :]
        y = (torch.cat([y[0][:, :b0], yb[0], y[0][:, b1:] * fr], 1),
             torch.cat([y[1][:, :b0], yb[1], y[1][:, b1:] * fr], 1))
        xs = (xs[0][:, :b0] * fr, xs[1][:, :b0] * fr)
        b1 = b0
    return y


def _eigen_core(q, t):
    """Eigenvalues and normalised eigenvectors from (Q, T) (B, n, n)
    (``nd4js_tpu/la/schur.py:1117-1270``): (lam re, im (B, n), v re, im
    (B, n, n))."""
    B, n, _ = t.shape
    dt = t.dtype
    fi = torch.finfo(dt)
    qc, tc, lam = _complex_triangularize_reim(q, t)
    # xTREVC safeguards: near-singular pivots clamped to eps·‖T‖_F, and a
    # per-column growth rescale
    tnorm = torch.sqrt((tc[0] * tc[0] + tc[1] * tc[1]).sum((-2, -1)))
    smallnum = fi.eps * tnorm + fi.tiny
    bignum = (fi.max ** 0.5) / max(n, 1)
    if n > 128 and n % 64 == 0:
        x = trevc_solve(tc[0], tc[1], lam[0], lam[1], smallnum, bignum)
    else:
        # the blocked form on the card, and for n ≤ 128 one block of all
        # rows: the row-at-a-time loop of nd4js_tpu/la/schur.py:1147-1177
        x = trevc_solve_ref(tc[0], tc[1], lam[0], lam[1], smallnum, bignum,
                            nbk=64 if n > 128 else n)

    def tri_resid(z):
        r_ = cpx.sub(cpx.matmul(tc, z),
                     cpx.mul(z, (lam[0][:, None, :], lam[1][:, None, :])))
        nrm_ = torch.sqrt(cpx.abs2(z).sum(-2))
        return torch.sqrt(cpx.abs2(r_).sum(-2)) / torch.where(nrm_ == 0, 1.0,
                                                              nrm_)

    # the refinement pass is gated: only where a column's residual leaves
    # the healthy band (run when any matrix needs it, kept per matrix)
    rx = tri_resid(x)
    need = rx.amax(-1) > 64 * fi.eps * tnorm
    if bool(need.any()):                              # the host read
        branches["refine"] += int(need.sum())
        y = _trevc_refine(tc, lam, smallnum, x, 64 if n > 128 else n)
        ynrm = torch.sqrt(cpx.abs2(y).sum(-2, keepdim=True))
        y = cpx.scale(y, 1 / torch.where(ynrm == 0, 1.0, ynrm))
        keep = need[:, None, None] & (tri_resid(y) < rx)[:, None, :]
        x = cpx.where(keep, y, x)
    v = _back_transform(qc, x)
    return lam[0], lam[1], v[0], v[1]


def _back_transform(qc, x):
    """V = Qc·X with unit columns."""
    v = cpx.matmul(qc, x)
    nrm = torch.sqrt(cpx.abs2(v).sum(-2, keepdim=True))
    return cpx.scale(v, 1 / torch.where(nrm == 0, 1.0, nrm))


@batched((2, 2))
def _schur_eigen(q, t):
    n = t.shape[-1]
    lr, li, vr, vi = _eigen_core(q.reshape((-1, n, n)), t.reshape((-1, n, n)))
    lead = t.shape[:-2]
    return (lr.reshape(lead + (n,)), li.reshape(lead + (n,)),
            vr.reshape(t.shape), vi.reshape(t.shape))


def schur_eigen(q, t, split: bool = False, device=None):
    """[Λ, V] from a real Schur form (``nd4js_tpu/la/schur.py:1107``):
    A = Q·T·Qᵀ ⇒ A·V = V·diag(Λ), columns normalised. Computed in
    split-complex form; ``split=True`` returns ((Λre, Λim), (Vre, Vim)),
    ``split=False`` complex tensors. Batched over leading dims. Array-like
    inputs go to ``device`` (default ``config.default_device``)."""
    q, t = as_tensor(q, device), as_tensor(t, device)
    dt = default_float_for(t.dtype)
    lr, li, vr, vi = _schur_eigen(q.to(dt), t.to(dt))
    if split:
        return (lr, li), (vr, vi)
    return cpx.to_complex((lr, li)), cpx.to_complex((vr, vi))

"""Strong-Wolfe line-search engine with polynomial trial selection, the
counterpart of ``nd4js_tpu/opt/line_search/_engine.py``.

One state machine for the three searches of the reference:

  * a bracketing phase with secant-extrapolated growth clipped to
    [α·growMin, α·growMax] (``abc``, ``u123``) or a fixed growth factor
    (``af``),
  * a zoom phase with the Moré-Thuente trial selection (cubic, quadratic
    or secant by the (fLo, fHi, pLo, pHi) cases) or, for ``af``, the
    quadratic alone, safeguarded by the ``shrinkLeast`` interval floor
    and falling back to bisection on degenerate data; a NaN trial fails
    the clamp comparisons and lands on the safeguard,
  * an αMax bound with BoundReached semantics.

Status codes stand for the error classes: 0 ok, 1 no progress,
2 bisection collapse, 3 bound reached, 4 max_iter; the factories in
``__init__`` raise the matching exceptions. The JAX package's
``lax.while_loop`` is a Python loop here that reads one flag an
iteration on the host (``core.host.read``): whether the search goes on.
Everything else stays on the tensors' device.
"""
from __future__ import annotations

import math

import torch

from ...core.host import read
from .._tree import vdot

__all__ = ["wolfe_line_search", "line_search_engine",
           "OK", "NO_PROGRESS", "BISECTION", "BOUND_REACHED", "MAX_ITER"]

_BRACKET, _ZOOM, _DONE = 0, 1, 2
OK, NO_PROGRESS, BISECTION, BOUND_REACHED, MAX_ITER = 0, 1, 2, 3, 4


def _up(a):
    return torch.nextafter(a, torch.full_like(a, math.inf))


def _down(a):
    return torch.nextafter(a, torch.full_like(a, -math.inf))


def _interp_gg(x1, x2, g1, g2):
    """Secant zero of the derivative."""
    dg = g2 - g1
    safe = torch.where(dg == 0, 1.0, dg)
    out = x1 - (x2 - x1) / safe * g1
    return torch.where(dg == 0, torch.nan, out)


def _interp_ffg(x1, x2, f1, f2, g1):
    """Quadratic-model minimiser from (f1, f2, g1)."""
    dx = x2 - x1
    safe_dx = torch.where(dx == 0, 1.0, dx)
    dfdx = (f2 - f1) / safe_dx
    den = g1 - dfdx
    safe = torch.where(den == 0, 1.0, den)
    out = x1 + 0.5 * dx * g1 / safe
    return torch.where((dx == 0) | (den == 0), torch.nan, out)


def _interp_ffgg(x1, x2, f1, f2, g1, g2):
    """Cubic (two-point Hermite) minimiser from (f1, f2, g1, g2) in the
    numerically stable form; NaN when the cubic has no interior
    minimiser."""
    dx = x2 - x1
    d1 = g1 + g2 - 3 * (f1 - f2) / (x1 - x2 + torch.where(dx == 0, 1.0, 0.0))
    rad = d1 * d1 - g1 * g2
    ok = rad >= 0
    d2 = torch.sign(dx) * torch.sqrt(torch.where(ok, rad, 0.0))
    den = g2 - g1 + 2 * d2
    safe_den = torch.where(den == 0, 1.0, den)
    out = x2 - dx * (g2 + d2 - d1) / safe_den
    return torch.where(ok & (den != 0) & (dx != 0), out, torch.nan)


def _safeguards(a_lo, a_hi, shrink):
    a_lil = torch.minimum(a_lo, a_hi)
    a_big = torch.maximum(a_lo, a_hi)
    a_lst = torch.maximum(_up(a_lil), shrink * a_big + (1 - shrink) * a_lil)
    a_mst = torch.minimum(_down(a_big), shrink * a_lil + (1 - shrink) * a_big)
    return a_lst, a_mst


def _clamp_trial(a, a_lo, a_hi, f_hi, p_hi, a_lst, a_mst):
    # NaN-safe clamping (a NaN trial fails both comparisons -> a_lst)
    a = torch.where(a_lst <= a, a, a_lst)
    a = torch.where(a_mst >= a, a, a_mst)
    degenerate = ~(a_lst < a_mst) | ~torch.isfinite(f_hi) \
        | ~torch.isfinite(p_hi)
    return torch.where(degenerate, a_lo + (a_hi - a_lo) / 2, a)


def _zoom_trial_mt(a_lo, f_lo, p_lo, a_hi, f_hi, p_hi, shrink):
    """Moré-Thuente trial-value selection with the αLst/αMst safeguards."""
    a_lst, a_mst = _safeguards(a_lo, a_hi, shrink)
    ac = _interp_ffgg(a_lo, a_hi, f_lo, f_hi, p_lo, p_hi)
    aq = _interp_ffg(a_lo, a_hi, f_lo, f_hi, p_lo)
    as_ = _interp_gg(a_lo, a_hi, p_lo, p_hi)
    case1 = f_lo < f_hi
    case2 = torch.sign(p_lo) * p_hi < 0
    a1 = torch.where((ac - a_lo).abs() < (aq - a_lo).abs(), ac, (ac + aq) / 2)
    a2 = torch.where((as_ - a_hi).abs() <= (ac - a_hi).abs(), ac, as_)
    a = torch.where(case1, a1, torch.where(case2, a2, aq))
    return _clamp_trial(a, a_lo, a_hi, f_hi, p_hi, a_lst, a_mst)


def _zoom_trial_quad(a_lo, f_lo, p_lo, a_hi, f_hi, p_hi, shrink):
    """Albaali-Fletcher zoom trial: quadratic only."""
    a_lst, a_mst = _safeguards(a_lo, a_hi, shrink)
    a = _interp_ffg(a_lo, a_hi, f_lo, f_hi, p_lo)
    return _clamp_trial(a, a_lo, a_hi, f_hi, p_hi, a_lst, a_mst)


def line_search_engine(fg, x0, f0, g0, neg_dir, *,
                       fRed, gRed, growMin, growMax, shrinkLeast,
                       variant: str = "abc",
                       alpha0=None, alpha_max=math.inf, max_iter: int = 30):
    """Strong-Wolfe search along −neg_dir from x0 (tensors on one device).
    Returns (x, f, g, α, status, evaluations).

    variant: 'abc' | 'u123' | 'af' selects the Armijo forms and trial
    rules of the corresponding reference search."""
    d = -neg_dir
    dt = f0.dtype
    dev = f0.device

    def scalar(v):
        return torch.as_tensor(v, dtype=dt, device=dev)

    p0 = vdot(g0, d).to(dt)
    a_max = scalar(alpha_max)
    a0 = torch.minimum(scalar(1.0), a_max / 2) if alpha0 is None \
        else scalar(alpha0)

    def phi(a):
        x = x0 + a * d
        f, g = fg(x)
        return x, f.to(dt), vdot(g, d).to(dt), g

    zoom_trial = _zoom_trial_quad if variant == "af" else _zoom_trial_mt

    def bracket_armijo(a, f, st):
        if variant == "u123":
            return f - st["f_lo"] > fRed * (a - st["a_lo"]) * p0
        if variant == "af":
            return (f - f0 > fRed * a * p0) \
                | ((st["a_lo"] > 0) & (f >= st["f_lo"]))
        return f > st["f_lo"]                      # abc

    def zoom_armijo(a, f, st):
        if variant == "u123":
            return f - st["f_lo"] > fRed * (a - st["a_lo"]) * p0
        if variant == "af":
            return (f - f0 > fRed * a * p0) | (f >= st["f_lo"])
        return f > st["f_lo"]                      # abc

    def where(c, a, b):
        return torch.where(c, a, b)

    def body(st):
        a = st["a"]
        x, f, p, g = phi(a)
        conv = (f - f0 <= fRed * a * p0) & (p.abs() <= -gRed * p0)
        is_b = st["phase"] == _BRACKET

        # ---- bracket phase ------------------------------------------
        b_fail = bracket_armijo(a, f, st)          # -> zoom(lo, a)
        b_pos = p >= 0                             # -> zoom(a, lo)
        at_bound = a >= a_max
        # secant-extrapolated growth, clipped (abc/u123); af fixes
        # growMin == growMax so the clip gives exactly α·grow
        a_try = a * growMin
        if variant != "af":
            a_sec = _interp_gg(st["a_lo"], a, st["p_lo"], p)
            a_try = where(st["p_lo"] < p, a_sec, a_try)
        a_try = torch.minimum(a_try, a * growMax)
        a_try = torch.maximum(a_try, a * growMin)
        a_try = where(a_try > a, a_try, _up(a))
        a_try = where(a_max >= a_try, a_try, a_max)

        b_to_zoom = b_fail | b_pos
        # bracket interval on transition
        b_a_lo = where(b_fail, st["a_lo"], a)
        b_f_lo = where(b_fail, st["f_lo"], f)
        b_p_lo = where(b_fail, st["p_lo"], p)
        b_a_hi = where(b_fail, a, st["a_lo"])
        b_f_hi = where(b_fail, f, st["f_lo"])
        b_p_hi = where(b_fail, p, st["p_lo"])
        # continue bracketing: lo <- a
        b_a_lo = where(b_to_zoom, b_a_lo, a)
        b_f_lo = where(b_to_zoom, b_f_lo, f)
        b_p_lo = where(b_to_zoom, b_p_lo, p)

        i32 = st["phase"]
        done, zoom, brk = (torch.full_like(i32, v)
                           for v in (_DONE, _ZOOM, _BRACKET))
        b_phase = where(conv, done,
                        where(b_to_zoom, zoom, where(at_bound, done, brk)))
        b_status = where(
            conv, torch.full_like(i32, OK),
            where(b_to_zoom, st["status"],
                  where(at_bound, torch.full_like(i32, BOUND_REACHED),
                        st["status"])))
        b_next_a = where(b_to_zoom & ~conv,
                         zoom_trial(b_a_lo, b_f_lo, b_p_lo,
                                    b_a_hi, b_f_hi, b_p_hi, shrinkLeast),
                         a_try)

        # ---- zoom phase ---------------------------------------------
        z_fail = zoom_armijo(a, f, st)
        z_stuck_hi = z_fail & (a == st["a_hi"])
        flip = torch.sign(st["a_hi"] - st["a_lo"]) * p >= 0
        z_a_lo = where(z_fail, st["a_lo"], a)
        z_f_lo = where(z_fail, st["f_lo"], f)
        z_p_lo = where(z_fail, st["p_lo"], p)
        z_a_hi = where(z_fail, a, where(flip, st["a_lo"], st["a_hi"]))
        z_f_hi = where(z_fail, f, where(flip, st["f_lo"], st["f_hi"]))
        z_p_hi = where(z_fail, p, where(flip, st["p_lo"], st["p_hi"]))
        z_stuck_lo = (~z_fail) & (a == st["a_lo"])
        z_stuck = z_stuck_hi | z_stuck_lo
        z_phase = where(conv | z_stuck, done, zoom)
        z_status = where(
            conv, torch.full_like(i32, OK),
            where(z_stuck,
                  where(st["a_lo"] == 0, torch.full_like(i32, NO_PROGRESS),
                        torch.full_like(i32, BISECTION)),
                  st["status"]))
        z_next_a = zoom_trial(z_a_lo, z_f_lo, z_p_lo,
                              z_a_hi, z_f_hi, z_p_hi, shrinkLeast)

        # ---- merge ---------------------------------------------------
        new = {
            "phase": where(is_b, b_phase, z_phase),
            "status": where(is_b, b_status, z_status),
            "a": where(is_b, b_next_a, z_next_a),
            "a_lo": where(is_b, b_a_lo, z_a_lo),
            "f_lo": where(is_b, b_f_lo, z_f_lo),
            "p_lo": where(is_b, b_p_lo, z_p_lo),
            "a_hi": where(is_b, b_a_hi, z_a_hi),
            "f_hi": where(is_b, b_f_hi, z_f_hi),
            "p_hi": where(is_b, b_p_hi, z_p_hi),
            "it": st["it"] + 1,
            "nev": st["nev"] + 1,
        }
        done_now = new["phase"] == _DONE
        accept = done_now & ((new["status"] == OK)
                             | (new["status"] == BOUND_REACHED))
        better = f < st["best_f"]
        keep = accept | (better & ~st["has_acc"])
        new["best_a"] = where(keep, a, st["best_a"])
        new["best_f"] = where(keep, f, st["best_f"])
        new["best_x"] = where(keep, x, st["best_x"])
        new["best_g"] = where(keep, g, st["best_g"])
        new["has_acc"] = st["has_acc"] | accept
        return new

    zero_i = torch.zeros((), dtype=torch.int32, device=dev)
    st = {
        "phase": zero_i + _BRACKET, "status": zero_i + MAX_ITER,
        "a": a0, "a_lo": scalar(0.0), "f_lo": f0, "p_lo": p0,
        "a_hi": scalar(math.inf), "f_hi": scalar(math.nan),
        "p_hi": scalar(math.nan), "it": zero_i, "nev": zero_i,
        "best_a": scalar(0.0), "best_f": f0, "best_x": x0, "best_g": g0,
        "has_acc": torch.zeros((), dtype=torch.bool, device=dev),
    }
    while read((st["phase"] < _DONE) & (st["it"] < max_iter)):
        st = body(st)
    # degenerate input: p0 >= 0 means no descent direction
    bad_dir = p0 >= 0
    status = torch.where(bad_dir, NO_PROGRESS, st["status"])
    x = torch.where(bad_dir, x0, st["best_x"])
    f = torch.where(bad_dir, f0, st["best_f"])
    g = torch.where(bad_dir, g0, st["best_g"])
    a = torch.where(bad_dir, 0.0, st["best_a"])
    return x, f, g, a, status, st["nev"]


def wolfe_line_search(fg, x0, f0, g0, neg_dir, c1=1e-4, c2=0.9,
                      alpha0=1.0, grow=2.0, max_iter=40,
                      alpha_max=math.inf, variant: str = "abc"):
    """The engine with the old signature: (x, f, g, alpha, ok)."""
    x, f, g, a, status, _ = line_search_engine(
        fg, x0, f0, g0, neg_dir, fRed=c1, gRed=c2,
        growMin=grow, growMax=max(grow, 2.71828 - 1.5),
        shrinkLeast=0.1, variant=variant,
        alpha0=alpha0, alpha_max=alpha_max, max_iter=max_iter)
    return x, f, g, a, status == OK

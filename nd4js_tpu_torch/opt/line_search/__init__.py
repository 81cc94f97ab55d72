"""Line searches, the counterpart of ``nd4js_tpu/opt/line_search/``.

Each search is a factory ``opt => fg => (x0, f0, g0, negDir, αMin=0,
α0=None, αMax=inf) => (x, f, g)``, the reference's calling convention.
All three share the strong-Wolfe engine of ``_engine.py`` and keep their
own mechanisms:

  * ``more_thuente_abc``: plain-Armijo bracketing, Moré-Thuente
    cubic/quadratic/secant trial selection;
  * ``more_thuente_u123``: the (U1, U2, U3) auxiliary-function variant
    with αMax bound support;
  * ``albaali_fletcher``: a fixed growth factor, quadratic-only zoom.

``strong_wolfe`` is the deprecated alias of ``albaali_fletcher``.
Defaults are the reference's (abc/u123: fRed 1e-2, gRed 0.9, growMin
π/3, growMax e − 1.5, shrinkLeast 0.1; af: fRed 0.1, gRed 0.9, grow π/3,
shrinkLeast 0.2); each search stops after ``max_iter`` (40) trials.
"""
from __future__ import annotations

import math
import warnings

from ...config import default_float_for
from ...convert import as_tensor
from ...core.host import read
from ._engine import (line_search_engine, wolfe_line_search,  # noqa: F401
                      OK, NO_PROGRESS, BISECTION, BOUND_REACHED,
                      MAX_ITER)

__all__ = ["albaali_fletcher", "more_thuente_abc", "more_thuente_u123",
           "strong_wolfe", "LineSearchError", "LineSearchNoProgressError",
           "LineSearchBisectionError", "LineSearchBoundReachedError"]


class LineSearchError(RuntimeError):
    """A failed search; carries the best point found."""

    def __init__(self, message="line search failed", x=None, f=None, g=None):
        super().__init__(message)
        self.x, self.f, self.g = x, f, g


class LineSearchNoProgressError(LineSearchError):
    pass


class LineSearchBisectionError(LineSearchError):
    pass


class LineSearchBoundReachedError(LineSearchError):
    pass


_ERRORS = {
    NO_PROGRESS: (LineSearchNoProgressError, "line search: no progress"),
    BISECTION: (LineSearchBisectionError,
                "line search: zoom interval collapsed"),
    BOUND_REACHED: (LineSearchBoundReachedError,
                    "line search: alpha_max reached"),
    MAX_ITER: (LineSearchError, "line search: max iterations"),
}


def _raise_for_status(status, x, f, g):
    code = read(status)
    if code == OK:
        return
    cls, msg = _ERRORS.get(code, (LineSearchError, "line search failed"))
    raise cls(msg, x=x, f=f, g=g)


def _make(variant, defaults):
    def factory(opt=None):
        opt = dict(opt or {})
        fRed = opt.pop("fRed", defaults["fRed"])
        gRed = opt.pop("gRed", defaults["gRed"])
        if variant == "af":
            growMin = opt.pop("grow", opt.pop("growMin",
                                              defaults["growMin"]))
            growMax = growMin        # fixed growth factor
        else:
            growMin = opt.pop("growMin", defaults["growMin"])
            growMax = opt.pop("growMax", defaults.get("growMax", growMin))
        shrink = opt.pop("shrinkLeast", defaults["shrinkLeast"])
        maxit = opt.pop("max_iter", 40)
        if not 0 < fRed < gRed < 1:
            raise ValueError(
                "line search: need 0 < fRed < gRed < 1 "
                f"(got fRed={fRed}, gRed={gRed})")
        if not growMin > 1:
            raise ValueError("line search: growMin must exceed 1")
        if not growMax >= growMin:
            raise ValueError("line search: growMax must be >= growMin")
        if not 0 <= shrink <= 0.5:
            raise ValueError("line search: shrinkLeast must be in [0, 0.5]")
        if opt:
            warnings.warn(f"line search: unknown options {sorted(opt)}")

        def with_fg(fg):
            def search(x0, f0, g0, neg_dir, alpha_min=0, alpha0=None,
                       alpha_max=math.inf, device=None):
                """Array-likes go to ``device`` (default
                ``config.default_device``); the rest follow x0."""
                if alpha_min != 0:
                    raise ValueError(
                        "line search: alpha_min != 0 not supported "
                        "(matching the reference)")
                x0 = as_tensor(x0, device)
                x0 = x0.to(default_float_for(x0.dtype))
                f0, g0, neg_dir = (as_tensor(t, x0.device).to(x0.dtype)
                                   for t in (f0, g0, neg_dir))
                x, f, g, a, status, _ = line_search_engine(
                    fg, x0, f0, g0, neg_dir,
                    fRed=fRed, gRed=gRed, growMin=growMin,
                    growMax=growMax, shrinkLeast=shrink,
                    variant=variant, alpha0=alpha0,
                    alpha_max=alpha_max, max_iter=maxit)
                _raise_for_status(status, x, f, g)
                return x, f, g
            return search

        return with_fg

    return factory


# the reference's defaults
more_thuente_abc = _make("abc", {
    "fRed": 1e-2, "gRed": 0.9, "growMin": math.pi / 3,
    "growMax": math.e - 1.5, "shrinkLeast": 0.1})
more_thuente_u123 = _make("u123", {
    "fRed": 1e-2, "gRed": 0.9, "growMin": math.pi / 3,
    "growMax": math.e - 1.5, "shrinkLeast": 0.1})
albaali_fletcher = _make("af", {
    "fRed": 0.1, "gRed": 0.9, "growMin": math.pi / 3,
    "shrinkLeast": 0.2})


def strong_wolfe(opt=None):
    """Deprecated alias of :func:`albaali_fletcher`."""
    warnings.warn("strong_wolfe is deprecated; use albaali_fletcher",
                  DeprecationWarning)
    return albaali_fletcher(opt)

"""Nonlinear optimisation, the counterpart of ``nd4js_tpu/opt/`` up to
``odr_lm`` and ``lbfgs_minimize``: the line searches, L-BFGS, trust-region
Levenberg-Marquardt and dogleg, and orthogonal distance regression.
Each solver has a ``*_gen`` generator (one step a yield; the user owns
convergence) and a driver that runs to its tolerances.

The JAX package runs each solver as one ``lax.while_loop`` with
``lax.cond`` inside; here the control flow runs on the host, by one rule:

  * a ``lax.while_loop`` is a Python loop whose condition is read on the
    host once an iteration, as one boolean (``core.host.read``, which
    counts the reads);
  * a ``lax.cond`` whose branches are both cheap and NaN-safe (accept or
    reject a step, L-BFGS's success or failure, the curvature guard)
    computes both and selects with ``torch.where``: no read;
  * a ``lax.cond`` that skips work (the URV branch for a rank-deficient
    J, the Gauss-Newton step inside the radius against Moré's λ
    iteration, dogleg's Newton, Cauchy or leg) is a host branch on one
    read;
  * the iteration caps are the reference's: 32 λ steps, stuckLimit 32, 3
    failed line searches, 40 line-search trials.

Derivatives come from ``torch.func`` (``jacfwd``, ``jvp``, ``jacrev``,
``grad_and_value``), so user functions are torch functions. Float32 is
the default dtype, as elsewhere in the port. Entry points put array-like
inputs on ``config.default_device`` unless given ``device``.

Not ported yet (their JAX modules): ``num_grad``, ``root1d``, ``gss``,
``lbfgsb`` with the rest of ``_lbfgsb_solver``, ``nelder_mead``,
``newton``, ``fit_lin`` and ``test_fn``.
"""
from .polyquad import roots1d_polyquad
from . import line_search
from .line_search import (albaali_fletcher, more_thuente_abc,
                          more_thuente_u123, strong_wolfe,
                          LineSearchError)
from .lbfgs import min_lbfgs_gen, lbfgs_minimize, lsq_lbfgs_gen, fit_lbfgs_gen
from .optimization_error import OptimizationNoProgressError
from .lm import lsq_lm_gen, lsq_lm, fit_lm_gen, fit_lm
from .dogleg import (lsq_dogleg_gen, lsq_dogleg, fit_dogleg_gen,
                     min_dogleg_gen, min_dogleg)
from .odr import (odr_lm_gen, odr_dogleg_gen, odr_lm, odr_dogleg,
                  tls_lm_gen, tls_dogleg_gen, fit_odr_lm, fit_odr_dogleg)

__all__ = ["roots1d_polyquad", "line_search", "albaali_fletcher",
           "more_thuente_abc", "more_thuente_u123", "strong_wolfe",
           "LineSearchError", "min_lbfgs_gen", "lbfgs_minimize",
           "lsq_lbfgs_gen", "fit_lbfgs_gen", "OptimizationNoProgressError",
           "lsq_lm_gen", "lsq_lm", "fit_lm_gen", "fit_lm", "lsq_dogleg_gen",
           "lsq_dogleg", "fit_dogleg_gen", "min_dogleg_gen", "min_dogleg",
           "odr_lm_gen", "odr_dogleg_gen", "odr_lm", "odr_dogleg",
           "tls_lm_gen", "tls_dogleg_gen", "fit_odr_lm", "fit_odr_dogleg"]

"""Nonlinear optimisation, the counterpart of ``nd4js_tpu/opt/``: numerical
gradients, the 1-D root finders and golden-section search, the line
searches, L-BFGS and box-constrained L-BFGS-B, trust-region
Levenberg-Marquardt and dogleg, orthogonal distance regression,
Nelder-Mead, Newton's method for roots, linear least-squares fits and the
analytic test functions. Each iterative solver has a ``*_gen`` generator
(one step a yield; the user owns convergence) and a driver that runs to
its tolerances.

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
    iteration, dogleg's Newton, Cauchy or leg, Nelder-Mead's shrink) is
    a host branch on one read;
  * the iteration caps are the reference's: 32 λ steps, stuckLimit 32, 3
    failed line searches, 40 line-search trials.

Derivatives come from ``torch.func`` (``jacfwd``, ``jvp``, ``jacrev``,
``grad_and_value``, ``grad``, ``hessian``), and ``jax.vmap`` of a user's
function is ``torch.func.vmap``, so user functions are torch functions.
Float32 is the default dtype, as elsewhere in the port. Entry points put
array-like inputs on ``config.default_device`` unless given ``device``.
"""
from .num_grad import num_grad, num_grad_forward
from .root1d import root1d_bisect, root1d_brent, root1d_illinois
from .gss import min1d_gss
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
from .lbfgsb import min_lbfgsb_gen, lbfgsb_minimize
from .odr import (odr_lm_gen, odr_dogleg_gen, odr_lm, odr_dogleg,
                  tls_lm_gen, tls_dogleg_gen, fit_odr_lm, fit_odr_dogleg)
from .nelder_mead import min_nelder_mead_gen, min_nelder_mead
from .newton import root_newton_gen, root_newton
from .fit_lin import fit_lin
from . import test_fn

__all__ = ["num_grad", "num_grad_forward", "root1d_bisect", "root1d_brent",
           "root1d_illinois", "min1d_gss", "roots1d_polyquad", "line_search", "albaali_fletcher",
           "more_thuente_abc", "more_thuente_u123", "strong_wolfe",
           "LineSearchError", "min_lbfgs_gen", "lbfgs_minimize",
           "lsq_lbfgs_gen", "fit_lbfgs_gen", "OptimizationNoProgressError",
           "lsq_lm_gen", "lsq_lm", "fit_lm_gen", "fit_lm", "lsq_dogleg_gen",
           "lsq_dogleg", "fit_dogleg_gen", "min_dogleg_gen", "min_dogleg",
           "odr_lm_gen", "odr_dogleg_gen", "odr_lm", "odr_dogleg",
           "tls_lm_gen", "tls_dogleg_gen", "fit_odr_lm", "fit_odr_dogleg",
           "min_lbfgsb_gen", "lbfgsb_minimize", "min_nelder_mead_gen",
           "min_nelder_mead", "root_newton_gen", "root_newton", "fit_lin",
           "test_fn"]

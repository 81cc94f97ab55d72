"""nd4js_tpu_torch — the PyTorch + CUDA port of nd4js_tpu.

A second package beside the JAX one, with the same public surface and
conventions, ported slice by slice (ROADMAP.md). Plain tensor code is
PyTorch; every Pallas kernel of the JAX package becomes a CUDA kernel
written for Hopper (``csrc/``), built with nvcc on first use and bound
with ctypes (``ops/_build.py``). Entry points run on the CUDA device
unless they are given CPU tensors or ``device="cpu"``; on the CPU each
kernel's plain PyTorch version runs in its place.

Ported so far: batched Householder QR and QR least squares
(``la.qr_decomp``, ``la.qr_decomp_full``, ``la.qr_lstsq``,
``la.qr_solve``, ``la.qr_lstsq_fused``) with the kernels ``house_panel``
and ``qr_gesv``, and ``ops.house_stripe.house_stripe_t``, the stripe-WY
panel that ``qr_gesv`` shares its elimination with; LU, Cholesky and
determinants with ``chol_leaf``, ``lu_panel`` and ``lu_gesv``; symmetric
eigen (``la.eigh``, ``la.eigh_jacobi``, ``la.eigh_tridiag_dc``,
``la.tridiag_eigh_dc``) with
``sytrd_panel``; the SVD (``la.svd_decomp``, ``la.svd_gram``,
``la.svd_jac_1sided``, ``la.svd_lstsq``, ``la.svd_solve``, ``la.rank``,
``la.lstsq``, ``la.eigh_via_svd``) with ``jacobi_sweeps``; and the
rank-revealing QR and solves (``la.rrqr_decomp``, ``la.rrqr_lstsq``,
``la.rrqr_solve``, ``la.solve``, ``la.permute_rows`` and kin) with
``rrqr_kernel``; and general eigen (``la.hessenberg_decomp``,
``la.schur_decomp``, ``la.schur_eigenvals``, ``la.schur_eigen``,
``la.eigen``, ``la.eigenvals``, ``la.eigen_balance_pre``) with
``schur_small``, ``bulge_chase_steps`` and ``trevc_solve``; the strong
RRQR and URV (``la.srrqr_decomp_full``, ``la.urv_decomp_full``,
``la.urv_lstsq``, ``la.lstsq(method="urv")``), ``la.tri_inv`` and the
``scan``/``inv`` solves; ``dt``; all of ``opt``: the line searches,
L-BFGS, LM, dogleg and orthogonal distance regression, whose structured
solve runs ``chol_leaf`` on the card, box-constrained L-BFGS-B
(``opt.lbfgsb_minimize``, ``opt.min_lbfgsb_gen``), Newton's method for
roots (``opt.root_newton``, whose LU runs ``lu_panel``), linear
least-squares fits (``opt.fit_lin``, through ``la.lstsq``:
``house_panel`` and ``jacobi_sweeps``), Nelder-Mead, numerical
gradients, golden-section search, the 1-D root finders and the test
functions; ``utils`` (``regular_simplex``, ``KDTree``, ``odeint_rk4``,
the iteration and plain-array helpers); and the rest of ``la``: the SVD
by divide and conquer (``la.svd_dc``, whose orthogonality polish runs
``chol_leaf``), block Jacobi (``la.svd_jac_blocked``), Kogbetliantz
(``la.svd_jac_2sided``) and classic Jacobi (``la.svd_jac_classic``),
whose tall inputs go through ``house_panel``; ``la.bidiag_decomp``; LDLᵀ
and Bunch-Kaufman (``la.ldl_decomp``, ``la.pldlp_decomp`` and their
solves and factors); ``la.norm``, the n-ary ``la.matmul``, ``la.eye``,
``la.diag``, ``la.diag_mat`` and ``la.transpose_inplace``; and ``rand``
(``RNG``, ``rand_normal``, ``rand_ortho``); and the core surface: array
creation and elementwise maps (``array``, ``asarray``, ``tabulate``,
``zip_elems``, ``concat``, ``stack``, ``map_elems``, ``reduce_elems``,
``slice_elems``, with ``device=`` for host data), compensated sums
(``core.kahan_sum``, ``kahan_dot``, ``two_sum``) with the kernel
``kahan_sum``, the ``NDArray`` wrapper, ``math``, ``help``, ``io``
(``.npy``, base64, ``istr``, PyON) and ``parallel`` (``make_mesh``,
``shard_batch``, ``batch_sharded`` on ``torch.distributed``), with
``entry.dryrun_multichip`` as its dry run. Every public name of the JAX
package has its counterpart here.
"""
from . import config, dt
from . import math
from .core import (array, asarray, tabulate, zip_elems, concat, stack,
                   map_elems, reduce_elems, slice_elems)
from . import la
from . import opt
from . import rand
from . import io
from . import utils
from . import parallel
from .utils import (linspace, cartesian_prod, KDTree, odeint_rk4,
                    regular_simplex)
from .core.wrapper import NDArray, wrap
from .help import help
from . import entry

# flat namespace aliases, as in the JAX package
iter = utils.iter
spatial = utils.spatial
geom = utils.geom
integrate = utils.integrate
arrays = utils.arrays

__version__ = "0.1.0"

__all__ = ["config", "dt", "math", "array", "asarray", "tabulate",
           "zip_elems", "concat", "stack", "map_elems", "reduce_elems",
           "slice_elems", "la", "opt", "rand", "io", "utils", "parallel",
           "linspace", "cartesian_prod", "KDTree", "odeint_rk4",
           "regular_simplex", "NDArray", "wrap", "help", "entry", "iter",
           "spatial", "geom", "integrate", "arrays", "__version__"]

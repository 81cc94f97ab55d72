"""Interactive help, the counterpart of ``nd4js_tpu/help.py``: the
documentation lives in docstrings on every public name; ``help()``
prints the overview of the port and ``help(obj)`` a name's signature and
docstring."""
from __future__ import annotations

import inspect
import textwrap

__all__ = ["help"]

_TOPLEVEL = """nd4js_tpu_torch — dense linear algebra & optimization in PyTorch, with CUDA kernels
===================================================================================

Subpackages
-----------
  la        dense linear algebra: matmul, LU, Cholesky (inv=True
            returns the fused L-inverse), LDL, Bunch-Kaufman,
            QR/RRQR/SRRQR/URV (qr_decomp method='householder'|
            'cholqr2'|'auto'; qr_lstsq_fused solves without forming Q),
            bidiag, Hessenberg, Schur, eigen, eigh
            (method='auto'|'jacobi'|'dc'|'via_svd'), the SVD engines
            (svd_decomp method='auto'|'jacobi'|'gram'|'blocked'|'dc';
            svd_jac_classic, svd_jac_2sided Kogbetliantz),
            solve/lstsq/rank/det, triangular solves
  opt       optimization: L-BFGS(-B), trust-region Levenberg-Marquardt,
            dogleg, ODR/TLS, Nelder-Mead, Newton, line searches, 1-D
            root finders, fit_lin, test functions
  rand      seeded RNG (uniform/normal/int/shuffle/ortho/rankdef)
  io        .npy serialization, base64, istr text format, PyON
  utils     iter/spatial(KDTree)/geom/integrate(RK4)/arrays helpers
  parallel  data parallelism over the batch axis with torch.distributed
            (make_mesh, shard_batch, batch_sharded)
  core      array creation (array/tabulate/zip_elems/...), batching,
            compensated sums, split-complex layer, NDArray wrapper
  ops       the hand-written CUDA kernels, each beside its plain
            PyTorch version

Conventions
-----------
  * every la/ routine accepts (..., M, N) with NumPy broadcasting over
    the leading dims; the batch is one axis of each kernel launch
  * float32 is the default dtype; float64 is supported throughout
  * array-like inputs go to device= (default config.default_device,
    "cuda"); tensors keep their device. On a CUDA tensor each kernel
    runs (or raises); on a CPU tensor its plain PyTorch version runs
  * the kernels are built from csrc/ by one nvcc call on first use
  * data-dependent failures raise typed exceptions
  * use help(nd.la.qr_decomp) for a name's signature and docstring
"""


def help(obj=None):
    """Print documentation for ``obj``, or the library overview."""
    if obj is None:
        print(_TOPLEVEL)
        return
    doc = inspect.getdoc(obj)
    if doc:
        name = getattr(obj, "__name__", type(obj).__name__)
        try:
            sig = str(inspect.signature(obj))
        except (TypeError, ValueError):
            sig = ""
        print(f"{name}{sig}\n\n{textwrap.indent(doc, '    ')}")
    else:
        print(f"(no documentation for {obj!r})")

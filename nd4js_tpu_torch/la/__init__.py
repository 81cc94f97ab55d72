"""Dense linear algebra, batched over leading dims."""
from .cholesky import cholesky_decomp, cholesky_solve
from .det import det, det_tri, slogdet, slogdet_tri
from .eigh import eigh, eigh_jacobi, eigh_tridiag_dc
from .lu import lu_decomp, lu_solve, lu_solve_fused
from .matmul import matmul2
from .norm import norm_fro
from .qr import (qr_decomp, qr_decomp_full, qr_lstsq, qr_lstsq_fused,
                 qr_solve)
from .tri import tril, tril_solve, tril_t_solve, triu, triu_solve, triu_t_solve
from .tridiag_dc import tridiag_eigh_dc

__all__ = ["cholesky_decomp", "cholesky_solve", "det", "det_tri", "eigh",
           "eigh_jacobi", "eigh_tridiag_dc", "lu_decomp", "lu_solve",
           "lu_solve_fused", "matmul2", "norm_fro",
           "qr_decomp", "qr_decomp_full", "qr_lstsq", "qr_lstsq_fused",
           "qr_solve", "slogdet", "slogdet_tri", "tril", "tril_solve",
           "tril_t_solve", "tridiag_eigh_dc", "triu", "triu_solve",
           "triu_t_solve"]

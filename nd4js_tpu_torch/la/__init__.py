"""Dense linear algebra, batched over leading dims."""
from .cholesky import cholesky_decomp, cholesky_solve
from .det import det, det_tri, slogdet, slogdet_tri
from .eigen import eigen, eigen_balance_pre, eigenvals
from .eigh import eigh, eigh_jacobi, eigh_tridiag_dc, eigh_via_svd
from .hessenberg import hessenberg_decomp
from .lu import lu_decomp, lu_solve, lu_solve_fused
from .matmul import matmul2
from .norm import norm_fro
from .permute import (invert_permutation, permute_cols, permute_rows,
                      unpermute_cols, unpermute_rows)
from .qr import (qr_decomp, qr_decomp_full, qr_lstsq, qr_lstsq_fused,
                 qr_solve)
from .rrqr import (rrqr_decomp, rrqr_decomp_full, rrqr_lstsq, rrqr_rank,
                   rrqr_solve)
from .schur import schur_decomp, schur_eigen, schur_eigenvals
from .singular_matrix_solve_error import SingularMatrixSolveError
from .solve import solve
from .srrqr import srrqr_decomp_full, srrqr_rank
from .svd import lstsq, rank, svd_decomp, svd_lstsq, svd_rank, svd_solve
from .svd_gram import svd_gram
from .svd_jac import svd_jac_1sided
from .tri import (tri_inv, tril, tril_solve, tril_t_solve, triu, triu_solve,
                  triu_t_solve)
from .tridiag_dc import tridiag_eigh_dc
from .urv import urv_decomp_full, urv_lstsq

__all__ = ["SingularMatrixSolveError", "cholesky_decomp", "cholesky_solve",
           "det", "det_tri", "eigen", "eigen_balance_pre", "eigenvals", "eigh",
           "eigh_jacobi", "eigh_tridiag_dc", "eigh_via_svd",
           "hessenberg_decomp", "invert_permutation", "lstsq", "lu_decomp",
           "lu_solve", "lu_solve_fused", "matmul2", "norm_fro", "permute_cols",
           "permute_rows", "qr_decomp", "qr_decomp_full", "qr_lstsq",
           "qr_lstsq_fused", "qr_solve", "rank", "rrqr_decomp",
           "rrqr_decomp_full", "rrqr_lstsq", "rrqr_rank", "rrqr_solve",
           "schur_decomp", "schur_eigen", "schur_eigenvals", "slogdet",
           "slogdet_tri", "solve", "srrqr_decomp_full", "srrqr_rank",
           "svd_decomp", "svd_gram", "svd_jac_1sided", "svd_lstsq", "svd_rank",
           "svd_solve", "tri_inv", "tridiag_eigh_dc", "tril", "tril_solve",
           "tril_t_solve", "triu", "triu_solve", "triu_t_solve",
           "unpermute_cols", "unpermute_rows", "urv_decomp_full", "urv_lstsq"]

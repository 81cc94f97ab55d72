"""Dense linear algebra, batched over leading dims."""
from .bidiag import bidiag_decomp
from .cholesky import cholesky_decomp, cholesky_solve
from .det import det, det_tri, slogdet, slogdet_tri
from .eigen import eigen, eigen_balance_pre, eigenvals
from .eigh import eigh, eigh_jacobi, eigh_tridiag_dc, eigh_via_svd
from .eye_diag import diag, diag_mat, eye
from .hessenberg import hessenberg_decomp
from .ldl import ldl_decomp, ldl_solve
from .lu import lu_decomp, lu_solve, lu_solve_fused
from .matmul import matmul, matmul2
from .misc import transpose_inplace
from .norm import norm, norm_fro, safe_norm_2
from .permute import (invert_permutation, permute_cols, permute_rows,
                      unpermute_cols, unpermute_rows)
from .pldlp import pldlp_d, pldlp_decomp, pldlp_l, pldlp_p, pldlp_solve
from .qr import (qr_decomp, qr_decomp_full, qr_lstsq, qr_lstsq_fused,
                 qr_solve)
from .rrqr import (rrqr_decomp, rrqr_decomp_full, rrqr_lstsq, rrqr_rank,
                   rrqr_solve)
from .schur import schur_decomp, schur_eigen, schur_eigenvals
from .singular_matrix_solve_error import SingularMatrixSolveError
from .solve import solve
from .srrqr import srrqr_decomp_full, srrqr_rank
from .svd import lstsq, rank, svd_decomp, svd_lstsq, svd_rank, svd_solve
from .svd_block_jac import svd_jac_blocked
from .svd_dc import svd_dc
from .svd_gram import svd_gram
from .svd_jac import (svd_jac_1sided, svd_jac_2sided, svd_jac_2sided_blocked,
                      svd_jac_classic)
from .tri import (tri_inv, tril, tril_solve, tril_t_solve, triu, triu_solve,
                  triu_t_solve)
from .tridiag_dc import tridiag_eigh_dc
from .urv import urv_decomp_full, urv_lstsq
from ..rand.rng import rand_ortho

__all__ = ["SingularMatrixSolveError", "bidiag_decomp", "cholesky_decomp",
           "cholesky_solve", "det", "det_tri", "diag", "diag_mat", "eigen",
           "eigen_balance_pre", "eigenvals", "eigh", "eigh_jacobi",
           "eigh_tridiag_dc", "eigh_via_svd", "eye", "hessenberg_decomp",
           "invert_permutation", "ldl_decomp", "ldl_solve", "lstsq",
           "lu_decomp", "lu_solve", "lu_solve_fused", "matmul", "matmul2",
           "norm", "norm_fro", "permute_cols", "permute_rows", "pldlp_d",
           "pldlp_decomp", "pldlp_l", "pldlp_p", "pldlp_solve", "qr_decomp",
           "qr_decomp_full", "qr_lstsq", "qr_lstsq_fused", "qr_solve",
           "rand_ortho", "rank", "rrqr_decomp", "rrqr_decomp_full",
           "rrqr_lstsq", "rrqr_rank", "rrqr_solve", "safe_norm_2",
           "schur_decomp", "schur_eigen", "schur_eigenvals", "slogdet",
           "slogdet_tri", "solve", "srrqr_decomp_full", "srrqr_rank",
           "svd_dc", "svd_decomp", "svd_gram", "svd_jac_1sided",
           "svd_jac_2sided", "svd_jac_2sided_blocked", "svd_jac_blocked",
           "svd_jac_classic", "svd_lstsq", "svd_rank", "svd_solve",
           "transpose_inplace", "tri_inv", "tridiag_eigh_dc", "tril",
           "tril_solve", "tril_t_solve", "triu", "triu_solve",
           "triu_t_solve", "unpermute_cols", "unpermute_rows",
           "urv_decomp_full", "urv_lstsq"]

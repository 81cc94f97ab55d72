"""Dense linear algebra, batched over leading dims."""
from .matmul import matmul2
from .norm import norm_fro
from .qr import (qr_decomp, qr_decomp_full, qr_lstsq, qr_lstsq_fused,
                 qr_solve)
from .tri import triu_solve

__all__ = ["matmul2", "norm_fro", "qr_decomp", "qr_decomp_full", "qr_lstsq",
           "qr_lstsq_fused", "qr_solve", "triu_solve"]

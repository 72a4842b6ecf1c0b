"""Hand-written CUDA kernels for the solver's hot ops, each beside its
plain PyTorch version."""

from .chol import batched_cholesky_inverse, cholesky, cholesky_inverse
from .gram import scaled_gram
from .solve import batched_fused_k1_solve, fused_k1_solve

__all__ = ["batched_cholesky_inverse", "cholesky", "cholesky_inverse",
           "scaled_gram", "batched_fused_k1_solve", "fused_k1_solve"]

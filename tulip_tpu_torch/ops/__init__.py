"""Hand-written CUDA kernels for the solver's hot ops, each beside its
plain PyTorch version."""

from .chol import batched_cholesky_inverse, cholesky, cholesky_inverse
from .gram import scaled_gram

__all__ = ["batched_cholesky_inverse", "cholesky", "cholesky_inverse",
           "scaled_gram"]

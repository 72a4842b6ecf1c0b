"""Batched scaled Gram matrix: the CUDA kernel and its plain version.

Counterpart of ``tulip_tpu/kkt/pallas_chol.py:scaled_gram``, made
batch-first like every port backend. ``scaled_gram(A, d)`` returns
K = A·diag(d)·Aᵀ per lane for A (B, m, n) and d (B, n), with d applied to
the row side, as the TPU kernel applies it:

- on a CUDA tensor it launches ``csrc/scaled_gram.cu`` (built at first
  use, see :mod:`tulip_tpu_torch._build`) or raises; there is no fallback;
- on a CPU tensor it runs :func:`scaled_gram_plain`.

The kernel computes the tiles on and below the diagonal and mirrors them,
so its K is exactly symmetric; the plain version's is symmetric up to
rounding. It runs on the tensor cores: each f32 product is made of three
TF32 products of the operands' high and low parts, summed in f32, which
keeps K within ~1e-6·max|K| of the product in f64 (the plain f32 version
is no closer). There is no diagonal term: the caller adds Rd.
"""

from __future__ import annotations

import ctypes

import torch

# Launches of the CUDA kernel since the process started (or the caller last
# reset it); the plain version does not count.
KERNEL_LAUNCHES = 0


def scaled_gram_plain(A: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """(A·diag(d))·Aᵀ per lane, any device, in full f32 (never TF32)."""
    from ..ipm.hsd import full_matmul_precision

    with full_matmul_precision():
        return (A * d.unsqueeze(-2)) @ A.transpose(-1, -2)


def _launch(A: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    global KERNEL_LAUNCHES
    from .. import _build

    if A.dtype != torch.float32 or d.dtype != torch.float32:
        raise TypeError(f"scaled_gram kernel takes float32, got "
                        f"{A.dtype} and {d.dtype}")
    if A.dim() != 3 or d.dim() != 2 or d.shape != (A.shape[0], A.shape[2]):
        raise ValueError(f"expected A (B, m, n) and d (B, n), got "
                         f"{tuple(A.shape)} and {tuple(d.shape)}")
    if not (A.is_contiguous() and d.is_contiguous()):
        raise ValueError("scaled_gram kernel needs contiguous A and d")
    if d.device != A.device:
        raise ValueError(f"A on {A.device}, d on {d.device}")
    B, m, n = A.shape
    if B > 65535:
        raise ValueError(f"scaled_gram kernel takes B <= 65535, got {B}")
    K = torch.empty(B, m, m, dtype=A.dtype, device=A.device)
    if B == 0 or m == 0:
        return K
    if n == 0:
        return K.zero_()
    lib = _build.load("scaled_gram")
    fn = lib.tulip_scaled_gram_f32
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = fn(A.data_ptr(), d.data_ptr(), K.data_ptr(), B, m, n,
             A.device.index, stream)
    if err != 0:
        raise RuntimeError(f"scaled_gram kernel launch failed: cudaError {err}")
    KERNEL_LAUNCHES += 1
    return K


def scaled_gram(A: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """K = A·diag(d)·Aᵀ per lane for A (B, m, n), d (B, n).

    CUDA tensors go to the hand-written kernel (float32, contiguous;
    anything else raises); CPU tensors to the plain version. bfloat16 A
    and d (which the reference's kernel takes) run in float32 on upcast
    copies, on either device, and K is rounded to bfloat16.
    """
    if A.dtype == torch.bfloat16 and d.dtype == torch.bfloat16:
        return scaled_gram(A.float(), d.float()).to(A.dtype)
    if A.device.type == "cuda":
        return _launch(A, d)
    if A.device.type == "cpu":
        return scaled_gram_plain(A, d)
    raise ValueError(f"unsupported device {A.device}")

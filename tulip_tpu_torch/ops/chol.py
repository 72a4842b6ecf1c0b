"""Batched inverse Cholesky factor: the CUDA kernel and its plain version.

Counterpart of ``tulip_tpu/ops/chol.py``. ``batched_cholesky_inverse``
returns L⁻¹ with K = L Lᵀ for a batch of SPD matrices K (B, m, m):

- on a CUDA tensor it launches ``csrc/chol_inv.cu`` (built at first use,
  see :mod:`tulip_tpu_torch._build`) or raises; there is no fallback.
  Both of its paths factor in 32-column panels and form L⁻¹ by blocks. Up
  to m = 224 one group of threads (a warp up to m = 64) holds an instance
  in shared memory, one group per thread block or, with ``pack=p``, p
  per block (the port of the reference's lane-packed kernel); above, the
  panel products, trailing updates and block inverse are spread over
  many thread blocks per instance;
- on a CPU tensor it runs :func:`batched_cholesky_inverse_plain`, the
  same function in plain PyTorch.

Failure signalling follows the reference: a non-SPD instance gives
non-finite values in its own output (and in no other); nothing is raised.
The strict upper triangle is exactly zero.
"""

from __future__ import annotations

import ctypes
import sys

import torch

# Launches of the CUDA kernel that ran since the process started (or the
# caller last reset them), one instance per block and packed (several
# instances per block) apart; the plain version does not count. A launch
# inside a device program (ipm/graph.py) counts once for every replay of its
# pass, credited when the solve ends; CAPTURED_LAUNCHES counts the launches
# recorded into captured graphs (nodes, not runs), and the warm-up before a
# capture counts in neither (ipm/graph.py:count_launch).
# KERNEL_LAUNCHES_BLOCKED counts those of KERNEL_LAUNCHES that took the
# blocked path (m > SHARED_MAX_M). SHAPES holds the (B, m, instances per
# block) of every launch that ran, so that a caller can hold the kernel
# against its plain version at the shapes a run gave it.
KERNEL_LAUNCHES = 0
KERNEL_LAUNCHES_PACKED = 0
KERNEL_LAUNCHES_BLOCKED = 0
CAPTURED_LAUNCHES = 0
SHAPES: set = set()

_THIS = sys.modules[__name__]

MAX_M = 1024
# Largest m whose instance fits in one block's shared memory; above it the
# kernel's blocked path runs, on scratch that the wrapper allocates.
SHARED_MAX_M = 224


def batched_cholesky_inverse_plain(K: torch.Tensor) -> torch.Tensor:
    """L⁻¹ for a batch K (B, m, m) with torch.linalg, any device.

    ``cholesky_ex`` does not produce NaN on a non-SPD input: it returns
    ``info > 0`` and a partial factor. Those lanes are overwritten with NaN
    to keep the reference's contract (``tulip_tpu/ops/chol.py:27-29``).
    """
    L, info = torch.linalg.cholesky_ex(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    Li = torch.linalg.solve_triangular(L, eye.expand_as(K), upper=False)
    return torch.tril(Li).masked_fill((info > 0)[:, None, None],
                                      float("nan"))


def _launch(K: torch.Tensor, pack: int) -> torch.Tensor:
    from .. import _build
    from ..ipm import graph

    if K.dtype != torch.float32:
        raise TypeError(f"chol_inv kernel takes float32, got {K.dtype}")
    if K.dim() != 3 or K.shape[-1] != K.shape[-2]:
        raise ValueError(f"expected (B, m, m), got {tuple(K.shape)}")
    B, m = K.shape[0], K.shape[-1]
    if not 1 <= m <= MAX_M:
        raise ValueError(f"chol_inv kernel takes 1 <= m <= {MAX_M}, got {m}")
    if not K.is_contiguous():
        raise ValueError("chol_inv kernel needs a contiguous K")
    if pack < 0:
        raise ValueError(f"pack must be >= 0, got {pack}")
    out = torch.empty_like(K)
    if B == 0:
        return out
    lib = _build.load("chol_inv")
    stream = torch.cuda.current_stream(K.device).cuda_stream
    need = lib.tulip_chol_inv_scratch_floats
    need.argtypes = [ctypes.c_int, ctypes.c_int]
    need.restype = ctypes.c_longlong
    # The blocked path's working copy (no floats up to SHARED_MAX_M). Freed
    # on return, which is safe: the allocator hands it out again only to
    # work that this stream runs after the kernel.
    scratch = torch.empty(need(B, m), dtype=K.dtype, device=K.device)
    used = 1
    if pack <= 1:
        fn = lib.tulip_chol_inv_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err = fn(K.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, m,
                 K.device.index, stream)
    else:
        fn = lib.tulip_chol_inv_packed_f32
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p,
                       ctypes.POINTER(ctypes.c_int)]
        fn.restype = ctypes.c_int
        got = ctypes.c_int(0)
        err = fn(K.data_ptr(), out.data_ptr(), scratch.data_ptr(), B, m,
                 pack, K.device.index, stream, ctypes.byref(got))
        used = got.value
    if err != 0:
        raise RuntimeError(f"chol_inv kernel launch failed: cudaError {err}")
    if used > 1:
        graph.count_launch(_THIS, (B, m, used), KERNEL_LAUNCHES_PACKED=1)
    else:
        graph.count_launch(_THIS, (B, m, used), KERNEL_LAUNCHES=1,
                           KERNEL_LAUNCHES_BLOCKED=int(m > SHARED_MAX_M))
    return out


def batched_cholesky_inverse(K: torch.Tensor, block: int = 0,
                             pack: int = 0) -> torch.Tensor:
    """L⁻¹ for a batch of SPD matrices K (B, m, m), K = L Lᵀ.

    CUDA tensors go to the hand-written kernel (float32, contiguous,
    m ≤ 1024; anything else raises; above m = 224 its blocked path, which
    works on B·⌈m/32⌉·32·(⌈m/32⌉·32 + 32) floats of scratch allocated
    here); CPU tensors to the plain version.

    ``pack`` is the count of instances per thread block, the counterpart
    of the reference's lane packing (``tulip_tpu/ops/chol.py:95``): 0 or 1
    gives one instance per block; p > 1 puts p instances in a block, each
    on its own group of threads. Where p instances do not fit in one
    block's shared memory (always for m > 224) or in its 512 threads, the
    kernel's launcher lowers p to what fits, down to 1, as
    the reference's ``_pick_block_packed`` shrinks its block to the VMEM
    budget. The output does not depend on ``pack``. ``block`` is the TPU
    kernel's count of instances per grid step; the CUDA kernel has no such
    step, so it is accepted for parity and unused.

    bfloat16 K (which the reference's kernel takes) runs in float32 on an
    upcast copy, on either device, and L⁻¹ is rounded to bfloat16.
    """
    del block
    if K.dtype == torch.bfloat16:
        return batched_cholesky_inverse(K.float(), pack=pack).to(K.dtype)
    if K.device.type == "cuda":
        return _launch(K, pack)
    if K.device.type == "cpu":
        return batched_cholesky_inverse_plain(K)
    raise ValueError(f"unsupported device {K.device}")


def cholesky_inverse(K: torch.Tensor) -> torch.Tensor:
    """Inverse lower Cholesky factor L⁻¹ of one matrix (m, m) or a batch
    (B, m, m). Solves of ``K x = r`` become ``x = L⁻ᵀ (L⁻¹ r)``."""
    if K.dim() == 2:
        return batched_cholesky_inverse(K.unsqueeze(0).contiguous())[0]
    return batched_cholesky_inverse(K)


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD matrix or batch, as
    L = (L⁻¹)⁻¹ from the inverse-factor kernel and one triangular solve."""
    Li = cholesky_inverse(K)
    eye = torch.eye(K.shape[-1], dtype=K.dtype, device=K.device)
    return torch.linalg.solve_triangular(Li, eye.expand_as(Li), upper=False)

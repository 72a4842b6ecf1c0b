"""Fused K1 solve: the CUDA kernel and its plain version.

Counterpart of ``tulip_tpu/ops/solve.py``. ``batched_fused_k1_solve``
solves the normal-equations (K1) form of the augmented system with a
precomputed inverse factor Li = L⁻¹ (K = L Lᵀ = A D Aᵀ + Rd), RHS assembly,
both factor applications, dx recovery and ``refine`` refinement sweeps in
one launch:

- on a CUDA tensor it launches ``csrc/fused_solve.cu`` (built at first use,
  see :mod:`tulip_tpu_torch._build`) or raises; there is no fallback;
  when an instance fits in shared memory (the staged layout) the kernel
  loads it in one asynchronous burst: TMA bulk copies when m and n are
  multiples of 4 and every input starts on 16 bytes, else 4-byte
  ``cp.async`` copies (the C launcher decides from the pointers and the
  shapes); either way the output is the same, bit for bit;
- on a CPU tensor it runs :func:`batched_fused_k1_solve_plain`, the same
  arithmetic in plain PyTorch.

Both follow the TPU kernel (``tulip_tpu/ops/solve.py:34-89``), not
``DenseK1Backend.solve``: each sweep's Aᵀdy is accumulated from the
increments, never recomputed.
"""

from __future__ import annotations

import ctypes

import torch

from .chol import MAX_M

# Launches of the CUDA kernel since the process started (or the caller last
# reset it); the plain version does not count. STREAMED_LAUNCHES counts the
# launches among them that read A and Li from device memory, because the
# instance did not fit in shared memory, and WIDE_LAUNCHES those among the
# latter whose n-long vectors lived in device memory too. BULK_LAUNCHES counts
# the launches that staged A and Li in shared memory by TMA bulk copies rather
# than 4-byte copies. SHAPES holds the
# (B, m, n, refine) of every launch, so that a caller can hold the kernel
# against its plain version at the shapes a run gave it.
KERNEL_LAUNCHES = 0
STREAMED_LAUNCHES = 0
WIDE_LAUNCHES = 0
BULK_LAUNCHES = 0
SHAPES: set = set()


def _bmv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M @ v.unsqueeze(-1)).squeeze(-1)


def _bmtv(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (M.transpose(-1, -2) @ v.unsqueeze(-1)).squeeze(-1)


def batched_fused_k1_solve_plain(A, Li, d, treg, regD, xi_p, xi_d,
                                 refine: int = 0):
    """(dx (B, n), dy (B, m)) in plain PyTorch, any device: the kernel's
    arithmetic, one product at a time. Only the lower triangle of ``Li``
    is used."""
    Li = torch.tril(Li)

    def base(xp, xd):
        rhs = _bmv(A, d * xd) + xp
        dy = _bmtv(Li, _bmv(Li, rhs))
        atdy = _bmtv(A, dy)
        return d * (atdy - xd), dy, atdy

    dx, dy, atdy = base(xi_p, xi_d)
    for _ in range(refine):
        rd = xi_d - (-(treg * dx) + atdy)
        rp = xi_p - (_bmv(A, dx) + regD * dy)
        ddx, ddy, datdy = base(rp, rd)
        dx = dx + ddx
        dy = dy + ddy
        atdy = atdy + datdy
    return dx, dy


def _launch(A, Li, d, treg, regD, xi_p, xi_d, refine: int):
    global KERNEL_LAUNCHES, STREAMED_LAUNCHES, WIDE_LAUNCHES, BULK_LAUNCHES
    from .. import _build

    if A.dim() != 3:
        raise ValueError(f"expected A (B, m, n), got {tuple(A.shape)}")
    B, m, n = A.shape
    shapes = {"Li": (Li, (B, m, m)), "d": (d, (B, n)), "treg": (treg, (B, n)),
              "regD": (regD, (B, m)), "xi_p": (xi_p, (B, m)),
              "xi_d": (xi_d, (B, n))}
    for name, (t, want) in [("A", (A, (B, m, n))), *shapes.items()]:
        if t.dtype != torch.float32:
            raise TypeError(f"fused_k1_solve kernel takes float32, got "
                            f"{name} {t.dtype}")
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: expected shape {want}, got "
                             f"{tuple(t.shape)}")
        if t.device != A.device:
            raise ValueError(f"{name} on {t.device}, A on {A.device}")
        if not t.is_contiguous():
            raise ValueError(f"fused_k1_solve kernel needs a contiguous {name}")
    if not (1 <= m <= MAX_M and n >= 1):
        raise ValueError(f"fused_k1_solve kernel takes 1 <= m <= {MAX_M} and "
                         f"n >= 1, got m = {m}, n = {n}")
    if refine < 0:
        raise ValueError(f"refine must be >= 0, got {refine}")
    dx = torch.empty_like(d)
    dy = torch.empty_like(regD)
    if B == 0:
        return dx, dy
    lib = _build.load("fused_solve")
    per = ctypes.c_longlong(0)
    ws = lib.tulip_fused_k1_solve_workspace
    ws.argtypes = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_longlong)]
    ws.restype = ctypes.c_int
    err = ws(m, n, A.device.index, ctypes.byref(per))
    if err != 0:
        raise RuntimeError(f"fused_k1_solve workspace query failed: "
                           f"cudaError {err}")
    work = (torch.empty((B, per.value), dtype=torch.float32, device=A.device)
            if per.value else None)
    fn = lib.tulip_fused_k1_solve_f32
    fn.argtypes = ([ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 5
                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int)])
    fn.restype = ctypes.c_int
    layout = ctypes.c_int(-1)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = fn(A.data_ptr(), Li.data_ptr(), d.data_ptr(), treg.data_ptr(),
             regD.data_ptr(), xi_p.data_ptr(), xi_d.data_ptr(), dx.data_ptr(),
             dy.data_ptr(), None if work is None else work.data_ptr(), B, m,
             n, refine, A.device.index, stream, ctypes.byref(layout))
    if err != 0:
        raise RuntimeError(f"fused_k1_solve kernel launch failed: "
                           f"cudaError {err}")
    KERNEL_LAUNCHES += 1
    STREAMED_LAUNCHES += layout.value <= 1
    WIDE_LAUNCHES += layout.value == 0
    BULK_LAUNCHES += layout.value == 3
    SHAPES.add((B, m, n, refine))
    return dx, dy


def batched_fused_k1_solve(A, Li, d, treg, regD, xi_p, xi_d,
                           refine: int = 0, block: int = 0):
    """Batched fused solve: A (B, m, n), Li (B, m, m), d/treg (B, n),
    regD (B, m), xi_p (B, m), xi_d (B, n) → (dx (B, n), dy (B, m)).

    CUDA tensors go to the hand-written kernel (float32, contiguous, same
    device, m ≤ 1024, any n; anything else raises); CPU tensors to the
    plain version. ``block`` exists for parity with the reference: it is
    the TPU kernel's count of instances per grid step, while the CUDA
    kernel always gives each instance its own thread block.

    bfloat16 inputs (which the reference's kernel takes) run in float32 on
    upcast copies, on either device, and dx, dy are rounded to bfloat16.
    """
    del block
    args = (A, Li, d, treg, regD, xi_p, xi_d)
    if all(t.dtype == torch.bfloat16 for t in args):
        dx, dy = batched_fused_k1_solve(*(t.float() for t in args),
                                        refine=refine)
        return dx.to(A.dtype), dy.to(A.dtype)
    if A.device.type == "cuda":
        return _launch(A, Li, d, treg, regD, xi_p, xi_d, refine)
    if A.device.type == "cpu":
        return batched_fused_k1_solve_plain(A, Li, d, treg, regD, xi_p, xi_d,
                                            refine)
    raise ValueError(f"unsupported device {A.device}")


def fused_k1_solve(A, Li, d, treg, regD, xi_p, xi_d, refine: int = 0):
    """One instance (A of shape (m, n), vectors 1-D) or a batch (A of shape
    (B, m, n)), as ``tulip_tpu.ops.solve.fused_k1_solve`` takes them."""
    if A.dim() == 2:
        args = [t.unsqueeze(0).contiguous()
                for t in (A, Li, d, treg, regD, xi_p, xi_d)]
        dx, dy = batched_fused_k1_solve(*args, refine=refine)
        return dx[0], dy[0]
    return batched_fused_k1_solve(A, Li, d, treg, regD, xi_p, xi_d,
                                  refine=refine)

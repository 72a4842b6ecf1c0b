"""Generic KKT backend conformance test kit.

Counterpart of ``tulip_tpu/kkt/testkit.py`` (the reference's
``KKT.run_ls_tests``, src/KKT/Test/test.jl:9-47, plus the JAX package's
late-IPM ill-conditioning sweeps). Shipped inside the package so that a
third-party backend can check itself against the augmented-system
contract. It drives a backend through this package's batch-first
contract with one LP (a batch of one), on the device of the ``A`` it is
given.
"""

from __future__ import annotations

import numpy as np
import torch


def _lane(v) -> torch.Tensor:
    return v.unsqueeze(0)


def _solve1(backend, state, xi_p, xi_d):
    dx, dy = backend.solve(state, _lane(xi_p), _lane(xi_d))
    return dx[0], dy[0]


def _augmented_rel_resid(A, backend, state, theta_inv, regP, regD, rng):
    """Solve with a random right-hand side; return the scale-aware
    relative residual, the max over the two augmented-system rows."""
    m, n = A.shape
    xi_p = torch.as_tensor(rng.standard_normal(m), dtype=A.dtype,
                           device=A.device)
    xi_d = torch.as_tensor(rng.standard_normal(n), dtype=A.dtype,
                           device=A.device)
    dx, dy = _solve1(backend, state, xi_p, xi_d)
    rd = xi_d - (-(theta_inv + regP) * dx + A.T @ dy)
    rp = xi_p - (A @ dx + regD * dy)

    def mx(v):
        return float(v.abs().max())

    scale_d = mx(xi_d) + mx((theta_inv + regP) * dx) + mx(A.T @ dy)
    scale_p = mx(xi_p) + mx(A @ dx) + mx(regD * dy)
    return max(mx(rd) / max(scale_d, 1.0), mx(rp) / max(scale_p, 1.0))


def run_ls_tests(A, backend, atol: float = None, sweep: bool = True,
                 sweep_atol: float = None, seed: int = 0,
                 strict_sweep: bool = False) -> None:
    """Assert that ``backend`` satisfies the setup/update/solve contract on
    the (m, n) matrix ``A`` (a tensor, or an array placed on the CPU).

    1. Benign configuration (reference parity, test.jl:9-47): unit θ⁻¹
       and regularizations, unit right-hand side, absolute residuals
       ≤ ``atol`` (default 10·√eps of A's dtype).
    2. Late-IPM sweeps, in f64 only: θ⁻¹ uniform at 1e8 and log-spread
       over 16 decades, regularizations at the √eps floors, random
       right-hand sides; the scale-aware relative residual ≤ the gate,
       ``sweep_atol`` if given, else the backend's ``sweep_resid_atol``
       (None opts out). An ``update`` that reports failure inside a sweep
       is accepted, unless ``strict_sweep``.
    """
    A = torch.as_tensor(A)
    m, n = A.shape
    dt, dev = A.dtype, A.device
    if atol is None:
        atol = float(np.sqrt(torch.finfo(dt).eps)) * 10

    state = backend.setup(_lane(A))

    theta_inv = torch.ones(n, dtype=dt, device=dev)
    regP = torch.ones(n, dtype=dt, device=dev)
    regD = torch.ones(m, dtype=dt, device=dev)
    state, ok = backend.update(state, _lane(theta_inv), _lane(regP),
                               _lane(regD))
    assert bool(ok.all()), f"{backend.name}: update failed on a benign system"

    xi_p = torch.ones(m, dtype=dt, device=dev)
    xi_d = torch.ones(n, dtype=dt, device=dev)
    dx, dy = _solve1(backend, state, xi_p, xi_d)

    # Augmented-system residuals (reference: test.jl:33-44):
    #   rd = ξd + (Θ⁻¹+Rp) dx - Aᵀ dy ;  rp = ξp - A dx - Rd dy
    rd_nrm = float((xi_d - (-(theta_inv + regP) * dx + A.T @ dy))
                   .abs().max())
    rp_nrm = float((xi_p - (A @ dx + regD * dy)).abs().max())
    assert rd_nrm <= atol, (
        f"{backend.name}: dual residual {rd_nrm:.3e} > {atol:.3e}")
    assert rp_nrm <= atol, (
        f"{backend.name}: primal residual {rp_nrm:.3e} > {atol:.3e}")

    # ---- late-IPM ill-conditioning sweeps ------------------------------
    gate = sweep_atol if sweep_atol is not None else getattr(
        backend, "sweep_resid_atol", 1e-6)
    if not sweep or gate is None or dt != torch.float64:
        return
    rng = np.random.default_rng(seed)
    se = float(np.sqrt(np.finfo(np.float64).eps))
    regP_f = torch.full((n,), se, dtype=dt, device=dev)
    regD_f = torch.full((m,), se, dtype=dt, device=dev)
    sweeps = [
        ("theta-uniform-1e8", torch.full((n,), 1e8, dtype=dt, device=dev)),
        ("theta-mixed-16-decades",
         torch.as_tensor(10.0 ** rng.uniform(-8, 8, n), dtype=dt,
                         device=dev)),
    ]
    for label, ti in sweeps:
        st, ok = backend.update(state, _lane(ti), _lane(regP_f),
                                _lane(regD_f))
        if not bool(ok.all()):
            # An honest failure is the IPM's regularization ladder's to
            # handle; ``strict_sweep`` is for backends that claim
            # direct-method robustness at the √eps floors.
            assert not strict_sweep, (
                f"{backend.name}: update reported failure on the {label} "
                f"sweep at the √eps regularization floors")
            continue
        r = _augmented_rel_resid(A, backend, st, ti, regP_f, regD_f, rng)
        assert r <= gate, (
            f"{backend.name}: relative residual {r:.3e} > {gate:.3e} on "
            f"the {label} sweep — this backend would lose the late-IPM "
            f"accuracy the regularization floors assume")

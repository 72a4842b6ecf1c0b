"""Solver options.

Layered options bag mirroring the reference's parameter system
(reference: src/parameters.jl:5-21, src/IPM/options.jl:1-25,
src/KKT/KKT.jl:49-52) with string-prefix routing handled in
:mod:`tulip_tpu.api` ("IPM_*", "KKT_*", "Presolve_*").

Device-side numerical knobs (tolerances, regularization floors, damping)
default to ``sqrt(eps(dtype))``-style values resolved lazily against the
model dtype, like the reference's ``sqrt(eps(T))`` defaults.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

_AUTO = None  # sentinel: resolve against dtype at solve time


def _eps(dtype) -> float:
    return float(np.finfo(np.dtype(dtype)).eps)


def sqrt_eps(dtype) -> float:
    return float(np.sqrt(_eps(dtype)))


@dataclasses.dataclass
class IPMOptions:
    """Interior-point options (reference: src/IPM/options.jl:1-25)."""

    OutputLevel: int = 0

    # User limits
    IterationsLimit: int = 100
    TimeLimit: float = float("inf")

    # Numerical tolerances; None means sqrt(eps(dtype)).
    TolerancePFeas: Optional[float] = _AUTO
    ToleranceDFeas: Optional[float] = _AUTO
    ToleranceRGap: Optional[float] = _AUTO
    ToleranceIFeas: Optional[float] = _AUTO

    # Algorithmic parameters
    CorrectionLimit: int = 3
    StepDampFactor: float = 0.9995
    GammaMin: float = 0.1
    CentralityOutlierThreshold: float = 0.1

    # Regularization floors; None means sqrt(eps(dtype)).
    PRegMin: Optional[float] = _AUTO
    DRegMin: Optional[float] = _AUTO

    # Start HSD from the Mehrotra least-squares point (the reference uses
    # it only for MPC). Costs one extra factorization + two solves.
    MehrotraStart: bool = False
    # Solve the predictor / centrality corrections with the backend's
    # unrefined base solve (the taken corrector direction keeps full
    # accuracy). Op-count reduction for latency-bound platforms.
    FastPredictor: bool = False
    FastCorrections: bool = False

    # Which algorithm: "HSD" (homogeneous self-dual, default) or "MPC"
    # (reference: options.jl:24 Factory(HSD)).
    Algorithm: str = "HSD"

    def resolved(self, dtype) -> "IPMOptions":
        """Return a copy with all _AUTO fields resolved for ``dtype``."""
        se = sqrt_eps(dtype)
        out = dataclasses.replace(self)
        for f in ("TolerancePFeas", "ToleranceDFeas", "ToleranceRGap",
                  "ToleranceIFeas", "PRegMin", "DRegMin"):
            if getattr(out, f) is None:
                setattr(out, f, se)
        return out


@dataclasses.dataclass
class KKTOptions:
    """KKT linear-solver options (reference: src/KKT/KKT.jl:49-52).

    ``Backend``/``System`` name a registered backend (see
    :mod:`tulip_tpu.kkt`). ``None`` selects the default for the problem
    (dense K1 normal equations on TPU).
    """

    Backend: Optional[str] = None   # "dense", "cholesky-pallas", "cg", ...
    System: Optional[str] = None    # "K1" (normal eqs) or "K2" (augmented)
    # Iterative-refinement steps applied after each KKT solve. Essential for
    # f32/bf16 on TPU near convergence; the reference leaves this as a TODO
    # (src/KKT/Dense/lapack.jl:117). ``None`` = per-backend default
    # (2 for sparse-smw / sparse-ldl — SMW's forward error at late-IPM Θ
    # needs two sweeps on the true system to hold 1e-8; 1 for the f32
    # Pallas path; 0 otherwise). Set explicitly to override.
    RefinementSteps: Optional[int] = None
    # Sparse-first standard form: build the IPM data in support-compressed
    # tile form straight from COO, never materializing the dense (m, n)
    # constraint matrix (the CHOLMOD-at-any-scale role, reference:
    # src/KKT/Cholmod/sqd.jl:42-53 + src/problemData.jl:43-44 sparse
    # storage). ``None`` = auto (on for K1 problems with
    # m >= SparseFirstThreshold whose pattern tiles; off otherwise);
    # True forces the attempt (falls back to dense if the pattern does
    # not tile); False disables.
    SparseFirst: Optional[bool] = None
    SparseFirstThreshold: int = 8192


@dataclasses.dataclass
class PresolveOptions:
    """Presolve options (reference: src/Presolve/Presolve.jl options usage)."""

    Level: int = 1  # 0 = disabled
    # Pass-loop engine: "auto" uses the native C++ engine
    # (native/presolve.cpp — identical op streams to the Python engine,
    # differentially fuzz-tested) when the library is available, falling
    # back to Python; "native" requires it; "python" forces the Python
    # engine.
    Engine: str = "auto"


@dataclasses.dataclass
class Parameters:
    """Top-level options bag (reference: src/parameters.jl:5-21)."""

    OutputLevel: int = 0
    Threads: int = 1  # kept for API parity; XLA manages device parallelism
    # numpy dtype for all device arrays; float64 for Tulip-parity tolerances.
    ArithmeticDtype: str = "float64"
    # When set, the IPM phase runs under jax.profiler.trace(ProfileDir):
    # the device-side analogue of the reference's TimerOutputs tracing
    # (reference: src/IPM/HSD/HSD.jl:22 @timeit annotations); host-side
    # phase timers live in Model.timings. View with TensorBoard/XProf.
    ProfileDir: str = ""

    Presolve: PresolveOptions = dataclasses.field(default_factory=PresolveOptions)
    IPM: IPMOptions = dataclasses.field(default_factory=IPMOptions)
    KKT: KKTOptions = dataclasses.field(default_factory=KKTOptions)

"""User-facing convenience API.

Mirrors the reference's Julia API surface
(reference: src/Interfaces/tulip_julia_api.jl): file loading, attribute
get/set by name, and parameter get/set with "IPM_"/"KKT_"/"Presolve_"
prefix routing into the nested option structs
(reference: tulip_julia_api.jl:209-231).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .io.mps import read_mps
from .model import Model
from .status import SolutionStatus


def load_problem(m: Model, fname: str) -> Model:
    """Read an MPS file (optionally .gz/.bz2) into the model
    (reference: tulip_julia_api.jl:18-39)."""
    m.empty()
    m.pbdata = read_mps(fname)
    return m


# ---------------------------------------------------------------------------
# Parameters (reference: tulip_julia_api.jl:209-231)
# ---------------------------------------------------------------------------

def _route(m: Model, name: str):
    if name.startswith("IPM_"):
        return m.params.IPM, name[4:]
    if name.startswith("KKT_"):
        return m.params.KKT, name[4:]
    if name.startswith("Presolve_"):
        return m.params.Presolve, name[9:]
    return m.params, name


def get_parameter(m: Model, name: str):
    obj, field = _route(m, name)
    if not any(f.name == field for f in dataclasses.fields(obj)):
        raise KeyError(f"Unknown parameter {name!r}")
    return getattr(obj, field)


def set_parameter(m: Model, name: str, value) -> None:
    obj, field = _route(m, name)
    if not any(f.name == field for f in dataclasses.fields(obj)):
        raise KeyError(f"Unknown parameter {name!r}")
    setattr(obj, field, value)


# ---------------------------------------------------------------------------
# Attributes (reference: tulip_julia_api.jl:46-304, src/attributes.jl)
# ---------------------------------------------------------------------------

def _objective_value(m: Model, dual: bool) -> float:
    """Objective recomputed in the original space, ray-aware; the dual value
    is negated for max problems per MOI duality convention
    (reference: tulip_julia_api.jl:242-304)."""
    sol = m.solution
    if sol is None:
        raise ValueError("No solution available")
    if not dual:
        if sol.primal_status == SolutionStatus.UNKNOWN:
            return 0.0
        z = float(np.dot(np.asarray(m.pbdata.obj), sol.x))
        z0 = 0.0 if sol.is_primal_ray else m.pbdata.obj0
        return z + z0
    else:
        if sol.dual_status == SolutionStatus.UNKNOWN:
            return 0.0
        lcon = np.asarray(m.pbdata.lcon)
        ucon = np.asarray(m.pbdata.ucon)
        lvar = np.asarray(m.pbdata.lvar)
        uvar = np.asarray(m.pbdata.uvar)
        z = (np.sum(np.where(np.isfinite(lcon), lcon, 0.0) * sol.y_lower)
             - np.sum(np.where(np.isfinite(ucon), ucon, 0.0) * sol.y_upper)
             + np.sum(np.where(np.isfinite(lvar), lvar, 0.0) * sol.s_lower)
             - np.sum(np.where(np.isfinite(uvar), uvar, 0.0) * sol.s_upper))
        if not m.pbdata.objsense:
            z = -z
        z0 = 0.0 if sol.is_dual_ray else m.pbdata.obj0
        return z + z0


def get_attribute(m: Model, name: str, index: int = None):
    pb = m.pbdata
    if name == "ModelName":
        return pb.name
    if name == "NumberOfConstraints":
        return pb.ncon
    if name == "NumberOfVariables":
        return pb.nvar
    if name == "ObjectiveValue":
        return _objective_value(m, dual=False)
    if name == "DualObjectiveValue":
        return _objective_value(m, dual=True)
    if name == "ObjectiveConstant":
        return pb.obj0
    if name == "ObjectiveSense":
        return "min" if pb.objsense else "max"
    if name == "Status":
        return m.status
    if name == "BarrierIterations":
        return m.barrier_iterations
    if name == "SimplexIterations":
        return 0  # no simplex (reference: MOI/attributes.jl:231)
    if name == "SolutionTime":
        return m.solve_time
    if name == "RawStatusString":
        return m.status.name
    if name == "RelativeGap":
        # |zp - zd| / (1e-6 + |zd|). The reference's implementation
        # (reference: src/Interfaces/MOI/attributes.jl:199-204) has a
        # misparenthesized denominator; this is the intended formula.
        if m.solution is None:
            return float("nan")
        zp, zd = m.solution.z_primal, m.solution.z_dual
        return abs(zp - zd) / (1e-6 + abs(zd))
    if name == "ResultCount":
        # (reference: MOI/attributes.jl:217-226)
        from .status import TerminationStatus as Trm
        if (m.solution is None
                or m.status in (Trm.NOT_CALLED, Trm.UNKNOWN,
                                Trm.MEMORY_LIMIT)):
            return 0
        return 1
    if name == "VariableLowerBound":
        return pb.lvar[index]
    if name == "VariableUpperBound":
        return pb.uvar[index]
    if name == "VariableObjectiveCoeff":
        return pb.obj[index]
    if name == "VariableName":
        return pb.var_names[index]
    if name == "ConstraintLowerBound":
        return pb.lcon[index]
    if name == "ConstraintUpperBound":
        return pb.ucon[index]
    if name == "ConstraintName":
        return pb.con_names[index]
    raise KeyError(f"Unknown attribute {name!r}")


def set_attribute(m: Model, name: str, value, index: int = None) -> None:
    pb = m.pbdata
    if name == "ModelName":
        pb.name = value
    elif name == "ObjectiveConstant":
        pb.obj0 = float(value)
    elif name == "ObjectiveSense":
        pb.objsense = value in ("min", "minimize", True)
    elif name == "VariableLowerBound":
        pb.lvar[index] = float(value)
    elif name == "VariableUpperBound":
        pb.uvar[index] = float(value)
    elif name == "VariableObjectiveCoeff":
        pb.obj[index] = float(value)
    elif name == "VariableName":
        pb.var_names[index] = value
    elif name == "ConstraintLowerBound":
        pb.lcon[index] = float(value)
    elif name == "ConstraintUpperBound":
        pb.ucon[index] = float(value)
    elif name == "ConstraintName":
        pb.con_names[index] = value
    else:
        raise KeyError(f"Unknown or read-only attribute {name!r}")

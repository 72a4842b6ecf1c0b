"""Shared MPS semantics: bound-type and range application.

One behavioral definition used by BOTH the pure-Python parser
(:mod:`.mps`) and the native C++ tokenizer path (:mod:`.native`) — the
C++ side only tokenizes; meaning is assigned here.
"""

from __future__ import annotations

from typing import Dict, Tuple

from ..problem import INF


def apply_bound(lo: Dict[int, float], up: Dict[int, float], j: int,
                btype: str, val: float) -> None:
    """Apply one BOUNDS record (reference semantics: standard MPS;
    integer types accepted as their continuous relaxations)."""
    btype = btype.upper()
    if btype == "LO":
        lo[j] = val
    elif btype == "UP":
        up[j] = val
        # Classic MPS quirk: UP with negative value and no explicit lower
        # bound makes the variable lower bound -inf.
        if val < 0.0 and j not in lo:
            lo[j] = -INF
    elif btype == "FX":
        lo[j] = val
        up[j] = val
    elif btype == "FR":
        lo[j] = -INF
        up[j] = INF
    elif btype == "MI":
        lo[j] = -INF
    elif btype == "PL":
        up[j] = INF
    elif btype == "BV":
        lo[j] = 0.0
        up[j] = 1.0
    elif btype == "LI":
        lo[j] = val
    elif btype == "UI":
        up[j] = val
    else:
        raise ValueError(f"Unknown bound type {btype}")


def row_bounds(rtype: str, b: float, has_range: bool, r: float,
               ) -> Tuple[float, float]:
    """Row bounds from type + rhs (+ optional RANGES record)."""
    if rtype == "E":
        lb, ub = b, b
    elif rtype == "L":
        lb, ub = -INF, b
    else:  # G
        lb, ub = b, INF
    if has_range:
        if rtype == "E":
            lb, ub = (b, b + r) if r >= 0 else (b + r, b)
        elif rtype == "L":
            lb, ub = b - abs(r), b
        else:  # G
            lb, ub = b, b + abs(r)
    return lb, ub

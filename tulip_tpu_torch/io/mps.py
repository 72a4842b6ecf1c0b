"""Free-format MPS reader with transparent .gz / .bz2 decompression.

Plays the role of the reference's QPSReader usage
(reference: src/Interfaces/tulip_julia_api.jl:18-39): parses the LP subset
of MPS — NAME / OBJSENSE / ROWS / COLUMNS / RHS / RANGES / BOUNDS / ENDATA —
into a :class:`tulip_tpu.problem.ProblemData`.

Conventions:
- First N row is the objective (later N rows are ignored rows).
- An RHS entry on the objective row sets the objective constant to its
  negation (standard MPS convention).
- RANGES on row with rhs b and range r: E row → [b, b+r] if r >= 0 else
  [b+r, b]; L row → [b-|r|, b]; G row → [b, b+|r|].
- Default variable bounds are [0, +inf). Bound types LO/UP/FX/FR/MI/PL are
  supported; BV/LI/UI are accepted and treated as their continuous
  relaxations.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..problem import INF, ProblemData
from ..utils import open_maybe_compressed
from .semantics import apply_bound, row_bounds


class MPSError(ValueError):
    pass


def read_mps(fname: str, use_native: bool = True) -> ProblemData:
    """Read an MPS file (.mps / .mps.gz / .mps.bz2).

    Uses the native C++ tokenizer when available (built on demand from
    native/mps_tokenizer.cpp); semantics are shared with the pure-Python
    parser, which remains the fallback and the error-message authority.
    """
    with open_maybe_compressed(fname) as f:
        text = f.read()
    if use_native:
        from .native import parse_mps_native
        try:
            pb = parse_mps_native(text.encode(), name_hint=fname)
            if pb is not None:
                return pb
        except ValueError:
            pass  # re-parse in Python for the canonical error
    return parse_mps_lines(text.splitlines(), name_hint=fname)


def parse_mps_lines(lines, name_hint: str = "") -> ProblemData:
    section = None
    name = ""
    objsense_min = True

    row_types: Dict[str, str] = {}
    row_order: List[str] = []
    obj_row: Optional[str] = None

    col_order: List[str] = []
    col_idx: Dict[str, int] = {}
    obj_coefs: Dict[int, float] = {}
    entries: List[Tuple[str, int, float]] = []  # (row name, col idx, val)

    rhs: Dict[str, float] = {}
    obj_const = 0.0
    ranges: Dict[str, float] = {}

    lo: Dict[int, float] = {}
    up: Dict[int, float] = {}

    for raw in lines:
        line = raw.rstrip("\n")
        if not line.strip() or line.lstrip().startswith("*"):
            continue
        is_header = not line[0].isspace()
        tok = line.split()

        if is_header:
            head = tok[0].upper()
            if head == "NAME":
                name = tok[1] if len(tok) > 1 else ""
                section = "NAME"
            elif head in ("ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS",
                          "OBJSENSE", "ENDATA"):
                section = head
                if head == "ENDATA":
                    break
            else:
                raise MPSError(f"Unknown MPS section: {tok[0]}")
            continue

        if section == "OBJSENSE":
            objsense_min = tok[0].upper() in ("MIN", "MINIMIZE")
        elif section == "ROWS":
            rtype = tok[0].upper()
            rname = tok[1]
            if rtype == "N":
                if obj_row is None:
                    obj_row = rname
                row_types[rname] = "N"
            elif rtype in ("E", "L", "G"):
                row_types[rname] = rtype
                row_order.append(rname)
            else:
                raise MPSError(f"Unknown row type {rtype}")
        elif section == "COLUMNS":
            # Marker lines toggle integrality (accepted, relaxed).
            if len(tok) >= 3 and tok[1].strip("'\"").upper() == "MARKER":
                continue  # integrality markers: relaxed for LP
            cname = tok[0]
            if cname not in col_idx:
                col_idx[cname] = len(col_order)
                col_order.append(cname)
            j = col_idx[cname]
            pairs = tok[1:]
            if len(pairs) % 2 != 0:
                raise MPSError(f"Malformed COLUMNS line: {line!r}")
            for rname, val in zip(pairs[::2], pairs[1::2]):
                v = float(val)
                if rname == obj_row:
                    obj_coefs[j] = obj_coefs.get(j, 0.0) + v
                elif rname in row_types:
                    if row_types[rname] != "N":
                        entries.append((rname, j, v))
                else:
                    raise MPSError(f"Unknown row {rname} in COLUMNS")
        elif section == "RHS":
            pairs = tok[1:]
            if len(pairs) % 2 != 0:
                raise MPSError(f"Malformed RHS line: {line!r}")
            for rname, val in zip(pairs[::2], pairs[1::2]):
                v = float(val)
                if rname == obj_row:
                    obj_const = -v
                elif rname in row_types:
                    rhs[rname] = v
                else:
                    raise MPSError(f"Unknown row {rname} in RHS")
        elif section == "RANGES":
            pairs = tok[1:]
            for rname, val in zip(pairs[::2], pairs[1::2]):
                ranges[rname] = float(val)
        elif section == "BOUNDS":
            btype = tok[0].upper()
            # BOUNDS lines: <type> <bndname> <colname> [value]
            cname = tok[2] if len(tok) >= 3 else tok[1]
            if cname not in col_idx:
                col_idx[cname] = len(col_order)
                col_order.append(cname)
            j = col_idx[cname]
            val = float(tok[3]) if len(tok) >= 4 else 0.0
            try:
                apply_bound(lo, up, j, btype, val)
            except ValueError as e:
                raise MPSError(str(e))
        elif section in ("NAME", None):
            continue

    # Assemble ProblemData.
    pb = ProblemData(name or name_hint)
    pb.objsense = objsense_min
    pb.obj0 = obj_const

    for jj, cname in enumerate(col_order):
        pb.add_variable((), (), obj_coefs.get(jj, 0.0),
                        lo.get(jj, 0.0), up.get(jj, INF), cname)

    # Row bounds from type + rhs + ranges.
    row_entries: Dict[str, Dict[int, float]] = {r: {} for r in row_order}
    for rname, j, v in entries:
        row_entries[rname][j] = row_entries[rname].get(j, 0.0) + v

    for rname in row_order:
        rtype = row_types[rname]
        b = rhs.get(rname, 0.0)
        lb, ub = row_bounds(rtype, b, rname in ranges,
                            ranges.get(rname, 0.0))
        cols = sorted(row_entries[rname])
        pb.add_constraint(cols, [row_entries[rname][j] for j in cols],
                          lb, ub, rname)

    return pb


def write_mps(pb: ProblemData, fname: str) -> None:
    """Write a :class:`ProblemData` as free-format MPS (.mps, or
    compressed when the name ends in .gz / .bz2).

    No reference analogue (QPSReader only reads); provided so models
    built programmatically can be exported/archived and round-tripped
    through the reader. Row bounds map back to E/L/G + RANGES using the
    same conventions the reader applies; the objective constant is
    emitted as a negated RHS entry on the objective row.
    """
    lines = [f"NAME          {pb.name or 'TULIP_TPU'}"]
    if not pb.objsense:
        lines += ["OBJSENSE", "    MAX"]

    def rname(i):
        return pb.con_names[i] or f"R{i + 1}"

    def cname(j):
        return pb.var_names[j] or f"C{j + 1}"

    # ROWS: classify each constraint.
    lines.append("ROWS")
    lines.append(" N  OBJ")
    rtypes = []
    for i in range(pb.ncon):
        lo_, up_ = pb.lcon[i], pb.ucon[i]
        if lo_ == up_:
            t = "E"
        elif lo_ == -INF and up_ < INF:
            t = "L"
        elif up_ == INF and lo_ > -INF:
            t = "G"
        elif lo_ == -INF and up_ == INF:
            t = "N"            # free row (ignored non-objective N row)
        else:
            t = "L"            # range row, emitted as L + RANGES
        rtypes.append(t)
        lines.append(f" {t}  {rname(i)}")

    lines.append("COLUMNS")
    for j in range(pb.nvar):
        if pb.obj[j] != 0.0:
            lines.append(f"    {cname(j)}  OBJ  {pb.obj[j]!r}")
        for i, v in pb.acols[j].items():
            lines.append(f"    {cname(j)}  {rname(i)}  {v!r}")

    lines.append("RHS")
    if pb.obj0 != 0.0:
        lines.append(f"    RHS  OBJ  {-pb.obj0!r}")
    for i in range(pb.ncon):
        lo_, up_ = pb.lcon[i], pb.ucon[i]
        t = rtypes[i]
        b = {"E": lo_, "L": up_, "G": lo_, "N": 0.0}[t]
        if t != "N" and b != 0.0:
            lines.append(f"    RHS  {rname(i)}  {b!r}")

    range_lines = []
    for i in range(pb.ncon):
        lo_, up_ = pb.lcon[i], pb.ucon[i]
        if rtypes[i] == "L" and lo_ > -INF and lo_ != up_:
            range_lines.append(f"    RNG  {rname(i)}  {up_ - lo_!r}")
    if range_lines:
        lines.append("RANGES")
        lines += range_lines

    bound_lines = []
    for j in range(pb.nvar):
        lo_, up_ = pb.lvar[j], pb.uvar[j]
        if lo_ == 0.0 and up_ == INF:
            continue           # MPS default
        if lo_ == up_:
            bound_lines.append(f" FX BND  {cname(j)}  {lo_!r}")
            continue
        if lo_ == -INF and up_ == INF:
            bound_lines.append(f" FR BND  {cname(j)}")
            continue
        if lo_ == -INF:
            bound_lines.append(f" MI BND  {cname(j)}")
        elif lo_ != 0.0:
            bound_lines.append(f" LO BND  {cname(j)}  {lo_!r}")
        if up_ < INF:
            bound_lines.append(f" UP BND  {cname(j)}  {up_!r}")
    if bound_lines:
        lines.append("BOUNDS")
        lines += bound_lines

    lines.append("ENDATA")
    text = "\n".join(lines) + "\n"
    if fname.endswith(".gz"):
        import gzip
        with gzip.open(fname, "wt") as f:
            f.write(text)
    elif fname.endswith(".bz2"):
        import bz2
        with bz2.open(fname, "wt") as f:
            f.write(text)
    else:
        with open(fname, "w") as f:
            f.write(text)

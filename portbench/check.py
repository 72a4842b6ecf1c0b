"""The comparison that decides ``correct``: every answer that the window
produced, against the plain reference's optimum of its LP.

For each LP that a request solved, the answer the user reads (status,
objective, primal x, after postsolve where the entry has one) gives:

- ``not_optimal``: answers whose status is not OPTIMAL (every generated LP
  is feasible and bounded, so each is wrong);
- ``obj_err``: the larger of |cᵀx - f*| and, where the answer gives a
  finite objective, |objective - f*|, over max(1, |f*|), f* the
  reference's optimum;
- ``primal_res``: the larger of ‖Ax - b‖∞ / (1 + ‖b‖∞) and the largest
  bound violation over (1 + ‖u‖∞), in float64 from the generated inputs;
- ``ref_unsolved``: LPs the reference itself did not solve (then nothing
  can be judged).

The worst answer sets each number.

The reference is the configuration's own: its ``reference`` key names
``references/<name>.py`` (``"box"`` where it names none), loaded by
``harness.reference_of``. Such a module gives

- ``build(item, device)``: the LP of one pool item on ``device``, with
  ``b`` (B, m), ``c`` and ``u`` (B, n) as float64 tensors and
  ``matvec(x)``, the product A·x of a (B, n) batch, made however the
  reference keeps A (it need never be dense);
- ``solve(lp, *, precision="float64", tol=1e-9)``: that LP solved, as a
  ``reference.Solved`` (``converged``, ``obj``, ``x``, ``iters``).

``build`` runs once for each pool item that the window answered.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import scipy.sparse as sp
import torch


def box_batch(item: dict, device) -> tuple:
    """(A (B, m, n), b, c, u) of a pool item as float64 tensors on
    ``device``; a sparse A (one LP) is made dense there."""
    A = item["A"]
    if sp.issparse(A):
        coo = A.tocoo()
        dense = torch.zeros(coo.shape, dtype=torch.float64, device=device)
        dense.index_put_((torch.as_tensor(coo.row, device=device),
                          torch.as_tensor(coo.col, device=device)),
                         torch.as_tensor(coo.data, device=device),
                         accumulate=True)
        A = dense[None]
        rest = [torch.as_tensor(item[k], device=device)[None] for k in "bcu"]
    else:
        A = torch.as_tensor(A).to(device)
        rest = [torch.as_tensor(item[k]).to(device) for k in "bcu"]
    return tuple(t.to(torch.float64) for t in (A, *rest))


def _inf(v: torch.Tensor) -> torch.Tensor:
    return v.abs().amax(-1)


def compare(pool: list, records: list, device, reference) -> dict:
    """The numbers above over every answer of ``records`` (each with its
    pool ``item`` and ``answers``: ``optimal``, ``obj``, ``x``), against
    the module ``reference``."""
    by_item = {}
    for r in records:
        by_item.setdefault(r.item, []).append(r.answers)
    out = dict(not_optimal=0, obj_err=0.0, primal_res=0.0, ref_unsolved=0)
    t0 = time.perf_counter()
    for k in sorted(by_item):
        lp = reference.build(pool[k], device)
        b, c, u = lp.b, lp.c, lp.u
        ref = reference.solve(lp)
        out["ref_unsolved"] += int((~ref.converged).sum())
        scale = ref.obj.abs().clamp(min=1.0)
        for ans in by_item[k]:
            opt = torch.as_tensor(np.asarray(ans["optimal"]), device=device)
            out["not_optimal"] += int((~opt).sum())
            x = torch.as_tensor(np.asarray(ans["x"]), device=device,
                                dtype=torch.float64).reshape(u.shape)
            obj = torch.as_tensor(np.asarray(ans["obj"], dtype=np.float64),
                                  device=device).reshape(scale.shape)
            err = ((c * x).sum(-1) - ref.obj).abs()
            err = torch.maximum(err, torch.where(
                obj.isfinite(), (obj - ref.obj).abs(), err)) / scale
            res = _inf(lp.matvec(x) - b) / (1 + _inf(b))
            viol = torch.maximum((-x).clamp(min=0), (x - u).clamp(min=0))
            res = torch.maximum(res, _inf(viol) / (1 + _inf(u)))
            inf = float("inf")
            out["obj_err"] = max(out["obj_err"], float(
                torch.nan_to_num(err, nan=inf).max()))
            out["primal_res"] = max(out["primal_res"], float(
                torch.nan_to_num(res, nan=inf).max()))
    print(f"reference: {len(by_item)} pool items in "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr, flush=True)
    return out

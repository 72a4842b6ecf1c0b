"""Requests of ``tulip_tpu_torch.Model.optimize()``: each a new Model,
bulk-loaded with the next LP of the pool (its COO triplets, row bounds
b ≤ Ax ≤ b, column bounds 0 ≤ x ≤ u), at the configuration's
parameters."""

from __future__ import annotations

import numpy as np
import torch

SPANS = (("tulip_tpu_torch.model", "PresolveData", "presolve_setup"),
         ("tulip_tpu_torch.presolve.native", "presolve_native", "presolve"),
         ("tulip_tpu_torch.model", "sparse_lp_data_from_problem",
          "sparse_first"),
         ("tulip_tpu_torch.model", "standard_form_arrays", "standard_form"),
         ("tulip_tpu_torch.model", "Model._route", "route"),
         ("tulip_tpu_torch.model", "make_lp_data", "to_device"),
         ("tulip_tpu_torch.model", "hsd_solve", "ipm"),
         ("tulip_tpu_torch.model", "_extract_solution", "extract"),
         ("tulip_tpu_torch.model", "postsolve", "postsolve"),
         ("tulip_tpu_torch.model", "_validate_certificates", "certificates"))


def prepare(cfg, traffic, pool, device, control=None):
    """COO triplets of each pool LP, and the arithmetic (with
    ``control``, its ``ArithmeticDtype``)."""
    lps = []
    for it in pool:
        coo = it["A"].tocoo()
        lps.append(((coo.row, coo.col, coo.data), it["b"], it["c"], it["u"],
                    np.zeros(coo.shape[1])))
    return dict(lps=lps, device=device, route=None,
                dtype=(control or {}).get("ArithmeticDtype", cfg["dtype"]))


def request(prog, i):
    from tulip_tpu_torch import Model, TerminationStatus, get_attribute

    coo, b, c, u, lo = prog["lps"][i % len(prog["lps"])]
    with torch.profiler.record_function("load"):
        mod = Model(device=prog["device"])
        mod.pbdata.load(True, c, 0.0, coo, b, b, lo, u, name="staircase")
    mod.params.ArithmeticDtype = prog["dtype"]
    st = mod.optimize()
    answers = dict(optimal=np.array([st == TerminationStatus.OPTIMAL]),
                   obj=np.array([get_attribute(mod, "ObjectiveValue")]),
                   x=np.asarray(mod.solution.x, dtype=np.float64)[None])
    # Only the route's names outlive the request: holding the Model would
    # keep its rows and columns alive (and traversed by the collector)
    # through the next request.
    prog["route"] = (
        mod.kkt_backend.name if mod.kkt_backend is not None else None,
        type(mod.solver_state.kkt).__name__ if mod.solver_state else None)
    return 1, answers, dict(iters=mod.barrier_iterations,
                            timings=dict(mod.timings))


def describe(prog) -> str:
    route, kkt = prog["route"]
    return f"Model.optimize, route {route!r} (KKT state {kkt})"


def release(prog) -> None:
    from tulip_tpu_torch.ipm.graph import clear_device_programs

    prog.clear()
    clear_device_programs()

"""Requests of ``tulip_tpu_torch.batch_linprog``: each one list of the
pool's LPs as scipy ``linprog`` keyword dicts (``c``, ``A_eq``, ``b_eq``,
``bounds``), at the configuration's dtype and tolerances, with the
backend ``batch_linprog`` picks itself."""

from __future__ import annotations

import numpy as np

SPANS = (("tulip_tpu_torch.linprog", "_fill_pbdata", "load"),
         ("tulip_tpu_torch.presolve.presolve", "PresolveData.presolve",
          "presolve"),
         ("tulip_tpu_torch.ipm.data", "standard_form_arrays",
          "standard_form"),
         ("tulip_tpu_torch.ipm.batch", "stack_lps_host", "stack"),
         ("tulip_tpu_torch.ipm.batch", "batched_hsd_solve", "ipm"),
         ("tulip_tpu_torch.model", "_extract_solution", "extract"),
         ("tulip_tpu_torch.presolve", "postsolve", "postsolve"))


def prepare(cfg, traffic, pool, device, control=None):
    """The pool as lists of dicts, and the parameters (with ``control``,
    the backend ``SmallK1Backend`` at its ``matmul_precision``)."""
    from tulip_tpu_torch import Parameters
    from tulip_tpu_torch.kkt import SmallK1Backend

    params = Parameters()
    for k in ("PFeas", "DFeas", "RGap", "IFeas"):
        setattr(params.IPM, f"Tolerance{k}", cfg["tolerance"])
    params.IPM.PRegMin = params.IPM.DRegMin = cfg["reg_min"]
    lists = []
    for it in pool:
        A, b, c, u = (it[k].numpy() for k in "Abcu")
        lists.append([dict(c=c[j], A_eq=A[j], b_eq=b[j],
                           bounds=[(0.0, float(v)) for v in u[j]])
                      for j in range(len(c))])
    backend = (SmallK1Backend(refinement_steps=cfg["refinement_steps"],
                              matmul_precision=control["matmul_precision"])
               if control else None)
    return dict(lists=lists, params=params, device=device,
                dtype=cfg["dtype"], backend=backend)


def request(prog, i):
    from tulip_tpu_torch import batch_linprog

    probs = prog["lists"][i % len(prog["lists"])]
    res = batch_linprog(probs, device=prog["device"], dtype=prog["dtype"],
                        params=prog["params"], backend=prog["backend"])
    answers = dict(optimal=np.array([r.status == 0 for r in res]),
                   obj=np.array([r.fun for r in res]),
                   x=np.stack([r.x for r in res]))
    return len(res), answers, dict(iters=max(r.nit for r in res))


def describe(prog) -> str:
    return (f"batch_linprog, {len(prog['lists'])} lists of "
            f"{len(prog['lists'][0])} LPs")


def release(prog) -> None:
    from tulip_tpu_torch.ipm.graph import clear_device_programs

    prog.clear()
    clear_device_programs()

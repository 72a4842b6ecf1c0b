"""The control of a configuration whose program has no lower-precision
path of its own that changes its answers: the configuration's plain
reference (``harness.reference_of``), put in the program's place and
computed in the precision the configuration's ``control`` names. It
stands in for an entry (see ``entries/``)."""

from __future__ import annotations

from .harness import reference_of

SPANS = ()


def prepare(cfg, traffic, pool, device, control=None):
    return dict(pool=pool, device=device, reference=reference_of(cfg),
                precision=control["precision"], tol=control["tolerance"])


def request(prog, i):
    item = prog["pool"][i % len(prog["pool"])]
    ref = prog["reference"]
    r = ref.solve(ref.build(item, prog["device"]),
                  precision=prog["precision"], tol=prog["tol"])
    answers = dict(optimal=r.converged.cpu().numpy(),
                   obj=r.obj.double().cpu().numpy(),
                   x=r.x.double().cpu().numpy())
    return len(answers["obj"]), answers, dict(iters=r.iters)


def describe(prog) -> str:
    return f"control: the reference in {prog['precision']}"


def release(prog) -> None:
    prog.clear()

"""One run of one cell: set-up, the measured window, the traced slice, the
check against the plain reference, and the result line.

Everything that belongs to one configuration, traffic mix, entry point or
metric is a file of its own, found by the name that ``BENCHMARK.json``
gives it:

- ``configs/<config>.json``: the configuration (the ``file`` of its entry);
  its ``generator`` names ``generators/<generator>.py``, and its
  ``reference`` (``"box"`` where it has none) ``references/<reference>.py``,
  the plain reference that the check and the control call (``check.py``
  gives its interface);
- ``traffic/<traffic>.json``: the traffic mix; its ``entry`` names
  ``entries/<entry>.py``, the adapter that hands the program its inputs;
- ``limits/<workload>.json``: the limit of each number the check compares;
- ``metrics/<metric>.py``: a reader with ``read(run) -> float | None``;
  ``run`` holds the configuration and traffic mix as run, each request's
  record, the window's times and peak, and the profiled slice.

A run is closed-loop: one caller sends requests back to back until
``seconds`` have passed; the last request that started inside the window
runs to its end and counts.
"""

from __future__ import annotations

import contextlib
import gc
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch

from . import check

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# Top-level module names that no run may hold once its window has closed.
FORBIDDEN = ("jax", "jaxlib", "flax", "tulip_tpu")


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def load_module(path: str):
    """The Python file ``path`` (relative to this folder) as a module."""
    full = os.path.join(HERE, path)
    name = "portbench._" + path.replace("/", "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, full)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reference_of(cfg: dict):
    """The configuration's plain reference module."""
    return load_module(f"references/{cfg.get('reference', 'box')}.py")


def load_json(path: str) -> dict:
    with open(os.path.join(HERE, path)) as f:
        return json.load(f)


def load_cell(workload: str, bench: Optional[dict] = None):
    """(BENCHMARK.json, its workload entry, configuration, traffic mix,
    limits) of ``workload``."""
    if bench is None:
        with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
            bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: "
                         f"{', '.join(cells)}")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        cfg = json.load(f)
    traffic = load_json(f"traffic/{cell['traffic']}.json")
    limits = load_json(f"limits/{workload}.json")
    return bench, cell, cfg, traffic, limits


def metrics_of(bench: dict, workload: str, trace: int) -> list:
    """The metric entries that ``workload`` reports in a run with
    ``trace``: its end-to-end metrics untraced, its per-layer ones
    traced."""
    key = "per_layer" if trace else "end_to_end"
    return [m for m in bench[key]
            if "workloads" not in m or workload in m["workloads"]]


# ---------------------------------------------------------------------------
# Spans: wrappers the traced runs put around calls into the program's layers
# ---------------------------------------------------------------------------

class Spans:
    """Seconds of each span of the request that runs, and each IPM call's
    iterations and host reads, kept in memory."""

    def __init__(self):
        self.current: list = []

    @contextlib.contextmanager
    def installed(self, spans, sync: bool):
        """Wrap each ``(module, attribute, span)`` of ``spans`` for the
        block; a span named ``ipm`` also ends in a synchronize and records
        the call's iterations and the device program's host reads."""
        saved = []
        try:
            for modname, attr, name in spans:
                owner = importlib.import_module(modname)
                *path, attr = attr.split(".")
                for part in path:
                    owner = getattr(owner, part)
                fn = getattr(owner, attr)
                saved.append((owner, attr, fn))
                setattr(owner, attr, self._wrap(fn, name, sync))
            yield self
        finally:
            for owner, attr, fn in reversed(saved):
                setattr(owner, attr, fn)

    def _wrap(self, fn, name, sync):
        spans = self

        def wrapped(*args, **kwargs):
            if name == "ipm":
                from tulip_tpu_torch.ipm import graph
                graph.LAST.clear()
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*args, **kwargs)
                if name == "ipm":
                    if sync:
                        torch.cuda.synchronize()
                    rec = dict(name=name, s=time.perf_counter() - t0,
                               iters=int(out.niter.max()),
                               host_reads=graph.LAST.get("host_reads"))
                else:
                    rec = dict(name=name, s=time.perf_counter() - t0)
            spans.current.append(rec)
            return out

        return wrapped


# ---------------------------------------------------------------------------
# The profiled slice
# ---------------------------------------------------------------------------

def profile_slice(entry, prog, start: int, min_s: float, span_names,
                  cuda: bool):
    """Requests from ``start`` under torch.profiler until ``min_s``
    seconds have passed (one at least); returns what the trace shows."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    n = 0
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while True:
            with torch.profiler.record_function("request"):
                entry.request(prog, start + n)
            n += 1
            if time.perf_counter() - t0 >= min_s:
                break
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev, host = [], []
    names = set(span_names) | {"request"}
    for e in prof.profiler.kineto_results.events():
        iv = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
        if e.name() in names:
            # A span is recorded on the host, and again on the device's
            # timeline around the kernels it launched: only the first is
            # the host's, and neither is device work.
            if e.device_type() != torch.autograd.DeviceType.CUDA:
                host.append(iv)
        elif e.device_type() == torch.autograd.DeviceType.CUDA:
            dev.append(iv)
    return summarize(dev, host, wall, n)


def _pieces(host):
    """The intervals between consecutive span boundaries."""
    edges = sorted({t for s, e, _ in host for t in (s, e)})
    return list(zip(edges, edges[1:]))


def _innermost(host):
    """For each of :func:`_pieces`, the name of the shortest span that
    covers it ("outside a span" where none does)."""
    out = []
    for a, b in _pieces(host):
        cover = [h for h in host if h[0] <= a and b <= h[1]]
        out.append(min(cover, key=lambda h: h[1] - h[0])[2] if cover
                   else "outside a span")
    return out


def summarize(dev, host, wall, n):
    """Busy seconds (the union of the device's intervals), seconds by
    kernel name, and the device's idle seconds by the innermost span the
    host was in meanwhile."""
    by_name = {}
    for s, e, name in dev:
        c, t = by_name.get(name, (0, 0))
        by_name[name] = (c + 1, t + (e - s))
    merged = []
    for s, e, _ in sorted(dev):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    busy = sum(e - s for s, e in merged)
    reqs = [h for h in host if h[2] == "request"]
    gaps = {}
    if merged and reqs:
        idle = [(reqs[0][0], merged[0][0])]
        idle += [(merged[i][1], merged[i + 1][0])
                 for i in range(len(merged) - 1)]
        idle.append((merged[-1][1], max(r[1] for r in reqs)))
        pieces = list(zip(_pieces(host), _innermost(host)))
        j = 0
        for g0, g1 in idle:                 # both in time order
            while j < len(pieces) and pieces[j][0][1] <= g0:
                j += 1
            k = j
            while k < len(pieces) and pieces[k][0][0] < g1:
                (a, b), what = pieces[k]
                over = min(b, g1) - max(a, g0)
                if over > 0:
                    gaps[what] = gaps.get(what, 0) + over
                k += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return SimpleNamespace(
        busy_s=busy / 1e9, window_s=wall, requests=n,
        kernels={k: (c, t / 1e9) for k, (c, t) in by_name.items()},
        device_ops=[[k[:120], t / 1e9] for k, (c, t) in top],
        idle_gaps=[[k, v / 1e9] for k, v in
                   sorted(gaps.items(), key=lambda kv: -kv[1])[:10]],
        has_device=bool(dev))


# ---------------------------------------------------------------------------
# One run
# ---------------------------------------------------------------------------

def run_cell(workload: str, seed: int, seconds: float, trace: int, *,
             device: str = "cuda", t_start: Optional[float] = None,
             control: bool = False, overrides: Optional[dict] = None,
             bench: Optional[dict] = None):
    """Run ``workload`` once; returns (result line as a dict, the lines
    that give each compared number beside its limit). ``control`` runs
    the configuration's control (its ``control`` entry) in the program's
    place; ``overrides`` (``{"config": {...}, "traffic": {...}}``) changes
    sizes for the CPU tests."""
    if t_start is None:
        t_start = time.perf_counter()
    bench, cell, cfg, traffic, limits = load_cell(workload, bench)
    overrides = overrides or {}
    cfg = {**cfg, **overrides.get("config", {})}
    traffic = {**traffic, **overrides.get("traffic", {})}
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    gen = load_module(f"generators/{cfg['generator']}.py")
    entry = load_module(f"entries/{traffic['entry']}.py")
    reference = reference_of(cfg)
    control = cfg["control"] if control else None
    if control is not None and control["kind"] == "reference":
        from . import control as entry

    def sync():
        if cuda:
            torch.cuda.synchronize()

    pool = gen.pool(cfg, traffic, seed, dev)
    prog = entry.prepare(cfg, traffic, pool, dev, control=control)
    try:
        spans = Spans()
        with spans.installed(entry.SPANS if trace else (), cuda):
            entry.request(prog, 0)                  # the warm request
            sync()
            from tulip_tpu_torch.ipm import graph
            setup_s = time.perf_counter() - t_start
            setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            if cuda:
                torch.cuda.reset_peak_memory_stats(dev)
            built0 = graph.CAPTURES
            records = []
            t0 = time.perf_counter()
            i = 0
            while time.perf_counter() - t0 < seconds:
                spans.current = []
                r0 = time.perf_counter()
                n, answers, stats = entry.request(prog, i)
                records.append(SimpleNamespace(
                    s=time.perf_counter() - r0, n=n, item=i % len(pool),
                    answers=answers, stats=stats, spans=spans.current))
                i += 1
            window_s = time.perf_counter() - t0
            window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
            built = graph.CAPTURES - built0
            profile = None
            if trace:
                spans.current = []
                profile = profile_slice(
                    entry, prog, i, float(traffic.get("trace_seconds", 1.0)),
                    [s[2] for s in entry.SPANS], cuda)
        described = entry.describe(prog)
    finally:
        # Also where a request raised: an entry that started processes
        # in ``prepare`` stops them in ``release``.
        entry.release(prog)
    if profile is not None:
        log(f"{workload}: traced slice of {profile.requests} requests in "
            f"{profile.window_s:.3f} s, device busy {profile.busy_s:.3f} s")
    log(f"{workload}: seed {seed}, {len(records)} requests in "
        f"{window_s:.3f} s, set-up {setup_s:.3f} s; {described}; "
        f"device programs built in the window: {built}")
    if built:
        log(f"{workload}: WARNING: {built} device programs were built "
            "inside the window")

    # The check, once the program's state is freed.
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    numbers = check.compare(pool, records, dev, reference)
    del pool
    checks = {k: {"value": v, "limit": limits[k]}
              for k, v in numbers.items()}
    correct = all(math.isfinite(v) and v <= limits[k]
                  for k, v in numbers.items())
    lines = [f"check {k}: {c['value']!r} (limit {c['limit']!r})"
             for k, c in checks.items()]

    run = SimpleNamespace(cfg=cfg, traffic=traffic, records=records,
                          window_s=window_s, setup_s=setup_s,
                          window_peak_bytes=window_peak, profile=profile)
    metrics = {}
    for m in metrics_of(bench, workload, trace):
        v = load_module(f"metrics/{m['name']}.py").read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    attempted = sum(r.n for r in records)
    failed = sum(int((~np.asarray(r.answers["optimal"])).sum())
                 for r in records)
    info = {"platform": "gpu" if cuda else dev.type,
            "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
            "count": cell["chips"],
            "memory_peak_bytes": max(setup_peak, window_peak)}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": info}
    if profile is not None:
        info["busy_s"] = profile.busy_s
        info["window_s"] = profile.window_s
        result["breakdown"] = {"device_ops": profile.device_ops,
                               "idle_gaps": profile.idle_gaps}
    result["checks"] = checks
    return result, lines


def forbidden_modules(names=None) -> list:
    """The top-level names of ``FORBIDDEN`` among ``names`` (default: the
    modules loaded), each compared whole (``tulip_tpu_torch`` is not
    ``tulip_tpu``)."""
    names = list(sys.modules) if names is None else names
    return sorted({name.split(".")[0] for name in names} & set(FORBIDDEN))


def main(argv, t_start: float) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    _, cell, *_ = load_cell(a.workload)
    if not torch.cuda.is_available():
        log("no CUDA device: the benchmark measures the card, not the CPU")
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        log(f"{a.workload} needs {cell['chips']} devices; "
            f"{torch.cuda.device_count()} found")
        return 2
    result, lines = run_cell(a.workload, a.seed, a.seconds, a.trace,
                             t_start=t_start)
    bad = forbidden_modules()
    if bad:
        log(f"modules that no run may load were loaded: {', '.join(bad)}")
        return 3
    for line in lines:
        log(line)
    print(json.dumps(result), flush=True)
    return 0

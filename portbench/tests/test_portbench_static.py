"""The benchmark's own pieces on the CPU: what it imports, the copied
generators and roofline arithmetic, the plain reference, BENCHMARK.json's
shape, and the command's refusal without a card.

    python -m pytest portbench/tests -q
"""

import ast
import hashlib
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import roofline
from portbench.generators.randlp import make_raw_instances
from portbench.generators.staircase import staircase_lp
from portbench.harness import FORBIDDEN, HERE, ROOT, load_cell
from portbench.reference import solve_box_lp


def _sources():
    for d, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        if hasattr(a, "tocsr"):
            a = a.tocsr()
            a.sort_indices()
            for p in (a.indptr, a.indices, a.data):
                h.update(np.ascontiguousarray(p).tobytes())
        else:
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def test_no_module_imports_jax_or_the_jax_package():
    """Every import under portbench/, by its top-level name compared
    whole: tulip_tpu_torch passes, tulip_tpu does not."""
    found = []
    for path in _sources():
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            found += [(path, n) for n in names
                      if n.split(".")[0] in FORBIDDEN]
    assert found == []


@pytest.mark.parametrize("names,hits", [
    (["tulip_tpu_torch", "tulip_tpu_torch.ipm.graph", "jaxtyping"], []),
    (["tulip_tpu.ipm", "numpy"], ["tulip_tpu"]),
    (["jax._src.core", "jaxlib", "flax.linen"], ["flax", "jax", "jaxlib"])])
def test_forbidden_names_compare_whole_top_level_names(names, hits):
    from portbench.harness import forbidden_modules
    assert forbidden_modules(names) == hits


# Hashes taken once from bench.py:make_raw_instances and
# tests/golden_large.py:staircase_lp (neither is imported here: the one is
# the JAX package's benchmark, the other imports the JAX package).
@pytest.mark.parametrize("args,digest", [
    ((4, 48, 96, 0), "b932871d169d0e5d"),
    ((3, 48, 96, 12345678901), "211efeeba7c6cf0e")])
def test_make_raw_instances_is_bench_py_s(args, digest):
    nb, m, n, seed = args
    raws = make_raw_instances(nb, m, n, seed=seed)
    assert _digest([a for r in raws for a in r]) == digest


@pytest.mark.parametrize("kw,digest", [
    (dict(m=512), "50e1621a6d2db9ed"),
    (dict(m=2048, dense_cols=24, dense_scale=1.0, seed=7),
     "6f85d8e2eedc19d9"),
    (dict(m=256, cyclic=True, seed=3), "0c60ace878a79a96")])
def test_staircase_lp_is_golden_large_s(kw, digest):
    assert _digest(staircase_lp(**kw)) == digest


def test_chol_inv_bound_at_the_batched_shape():
    """PERF.md's bound for chol-inv at (2048, 48): 0.0113 ms, by bytes."""
    least, by = roofline.chol_inv_bound_s(2048, 48)
    assert by == "bytes"
    assert round(least * 1e3, 4) == 0.0113


@pytest.mark.parametrize("B,m,n,seed", [(6, 12, 30, 1), (3, 48, 96, 2)])
def test_reference_matches_highs(B, m, n, seed):
    from scipy.optimize import linprog

    raws = make_raw_instances(B, m, n, seed=seed)
    A, b, c, u = (torch.as_tensor(np.stack([r[i] for r in raws]))
                  for i in range(4))
    ref = solve_box_lp(A, b, c, u)
    assert bool(ref.converged.all())
    for k, (Ak, bk, ck, uk) in enumerate(raws):
        h = linprog(ck, A_eq=Ak, b_eq=bk, bounds=list(zip(0 * uk, uk)),
                    method="highs")
        assert abs(float(ref.obj[k]) - h.fun) <= 1e-8 * max(1, abs(h.fun))


def _highs(A, b, c, u):
    from scipy.optimize import linprog

    return linprog(c, A_eq=A, b_eq=b, bounds=list(zip(0 * u, u)),
                   method="highs").fun


def _device(request, name):
    return request.getfixturevalue("cuda") if name == "cuda" else name


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_reference_finishes_unconverged_lanes_at_their_vertex(device,
                                                             request):
    """Stopped after 9 iterations, most lanes are finished at the vertex
    their iterate points to, each at HiGHS's optimum."""
    dev = _device(request, device)
    raws = make_raw_instances(32, 48, 96, seed=5)
    A, b, c, u = (torch.as_tensor(np.stack([r[i] for r in raws])).to(dev)
                  for i in range(4))
    ref = solve_box_lp(A, b, c, u, max_iter=9)
    assert int(ref.converged.sum()) >= 24
    for k in ref.converged.nonzero().flatten().tolist():
        f = _highs(*raws[k])
        assert abs(float(ref.obj[k]) - f) <= 1e-8 * max(1, abs(f))


def _float32_lane(seed, lane):
    """Lane ``lane`` of a batch of 2048 LPs of 48 x 96 drawn in float32
    from a CPU ``torch.Generator`` at ``seed``, b rounded to float32."""
    g = torch.Generator().manual_seed(seed)
    B, m, n, dt = 2048, 48, 96, torch.float32
    A = torch.randn((B, m, n), generator=g, dtype=dt)
    u = 1.0 + 3.0 * torch.rand((B, n), generator=g, dtype=dt)
    x0 = u * (0.2 + 0.6 * torch.rand((B, n), generator=g, dtype=dt))
    c = torch.randn((B, n), generator=g, dtype=dt)
    A, x0, c, u = (t[lane:lane + 1].double() for t in (A, x0, c, u))
    b = (A @ x0.unsqueeze(-1)).squeeze(-1).float().double()
    return A, b, c, u


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_reference_solves_a_near_degenerate_lp(device, request):
    """A lane whose optimal basis holds a column 1e-6 from its bound: the
    iterates stall above 1e-9 as the normal equations lose digits (it ran
    out of 100 iterations in its batch of 2048), and the vertex is found
    with the m-th basic column in doubt."""
    A, b, c, u = _float32_lane(35, 1141)
    f = _highs(*(t[0].numpy() for t in (A, b, c, u)))
    dev = _device(request, device)
    ref = solve_box_lp(*(t.to(dev) for t in (A, b, c, u)), max_iter=12)
    assert bool(ref.converged[0])
    assert abs(float(ref.obj[0]) - f) <= 1e-8 * max(1, abs(f))


def test_vertex_tries_every_column_for_the_last_basic_place():
    """An iterate that shows a basic column (1e-7 from its bound at the
    optimum) at its bound, ranked below every other column: the vertex
    is still found."""
    from scipy.optimize import linprog

    from portbench.reference import _vertex

    A, b, c, u = _float32_lane(150, 628)
    h = linprog(c[0].numpy(), A_eq=A[0].numpy(), b_eq=b[0].numpy(),
                bounds=list(zip(0 * u[0].numpy(), u[0].numpy())),
                method="highs-ds")
    x = torch.as_tensor(h.x)[None]
    w = u - x
    gap = torch.minimum(x, w)
    basic = gap > 1e-12
    near = int(torch.where(basic, gap, torch.inf).argmin())
    assert float(gap[0, near]) < 1e-6
    tiny = torch.full_like(x, 1e-20)
    x = torch.where(basic | (x > w), x, tiny)
    w = torch.where(basic | (w >= x), w, tiny)
    z = torch.where(basic | (x > w), tiny, torch.ones_like(x))
    s = torch.where(basic | (w >= x), tiny, torch.ones_like(x))
    w[0, near], s[0, near] = 1e-30, 1.0
    ok, xv = _vertex(A, b, c, u, x, w, z, s, 1e-9)
    assert bool(ok[0])
    assert abs(float((c * xv).sum()) - h.fun) <= 1e-9 * max(1, abs(h.fun))


def test_reference_solves_a_staircase_lp():
    from scipy.optimize import linprog

    from portbench.check import box_batch

    A, b, c, u = staircase_lp(256, dense_cols=3, dense_scale=1.0, seed=4)
    ref = solve_box_lp(*box_batch(dict(A=A, b=b, c=c, u=u), "cpu"))
    h = linprog(c, A_eq=A, b_eq=b, bounds=list(zip(0 * u, u)),
                method="highs")
    assert bool(ref.converged.all())
    assert abs(float(ref.obj[0]) - h.fun) <= 1e-8 * max(1, abs(h.fun))


def test_benchmark_json_names_a_file_for_every_piece():
    """Each cell finds its configuration, traffic mix, entry, generator,
    plain reference (``box`` where the configuration names none) and
    limits, and each metric its reader, by name."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for w in bench["workloads"]:
        _, cell, cfg, traffic, limits = load_cell(w["name"], bench)
        assert os.path.exists(os.path.join(HERE, "generators",
                                           cfg["generator"] + ".py"))
        assert os.path.exists(os.path.join(HERE, "entries",
                                           traffic["entry"] + ".py"))
        assert os.path.exists(os.path.join(
            HERE, "references", cfg.get("reference", "box") + ".py"))
        assert set(limits) == {"not_optimal", "obj_err", "primal_res",
                               "ref_unsolved"}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert os.path.exists(os.path.join(HERE, "metrics",
                                           m["name"] + ".py"))


def test_command_refuses_without_a_card(tmp_path):
    """Without CUDA the command exits non-zero and prints no result; so
    does a directory that holds only BENCHMARK.json and portbench/."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    import shutil
    bare = tmp_path / "bare"
    shutil.copytree(HERE, bare / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), bare)
    for root in (ROOT, str(bare)):
        p = subprocess.run(
            [sys.executable, "portbench/run.py", "--workload",
             "randlp48.linprog", "--seed", "1", "--seconds", "1",
             "--trace", "0"], cwd=root, capture_output=True, text=True,
            timeout=120)
        assert p.returncode != 0
        assert p.stdout == ""

"""Packaging of the PyTorch port: it runs without JAX, and its host layers
stay verbatim copies of the JAX package's."""

import inspect
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

VERBATIM = ["status.py", "problem.py", "solution.py", "params.py",
            "presolve/__init__.py", "presolve/presolve.py",
            "presolve/ops.py", "presolve/native.py", "io/__init__.py",
            "io/mps.py", "io/native.py", "io/semantics.py", "api.py",
            "kkt/native.py"]


def test_import_does_not_pull_in_jax():
    code = ("import sys, tulip_tpu_torch, tulip_tpu_torch.ipm, "
            "tulip_tpu_torch.kkt, tulip_tpu_torch.ops, "
            "tulip_tpu_torch.convert, tulip_tpu_torch.model, "
            "tulip_tpu_torch.cli, tulip_tpu_torch.api, tulip_tpu_torch.io, "
            "tulip_tpu_torch.kkt.gram, tulip_tpu_torch.ops.gram, "
            "tulip_tpu_torch.ops.solve, tulip_tpu_torch.ipm.mpc, "
            "tulip_tpu_torch.ipm.warmstart, tulip_tpu_torch.kkt.banded, "
            "tulip_tpu_torch.kkt.sparse, tulip_tpu_torch.kkt.levels, "
            "tulip_tpu_torch.kkt.native, tulip_tpu_torch.kkt.sparse_ldl; "
            "bad = sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith(('jax.', 'jaxlib', 'tulip_tpu.'))"
            " or m == 'tulip_tpu'); "
            "print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("rel", VERBATIM)
def test_host_module_is_verbatim_copy(rel):
    assert (ROOT / "tulip_tpu_torch" / rel).read_bytes() == \
        (ROOT / "tulip_tpu" / rel).read_bytes()


@pytest.mark.parametrize("module,name", [
    ("ipm.data", "standard_form_arrays"),
    ("model", "_extract_solution"),
    ("model", "_trivial_solve"),
    ("model", "_certificate_tol"),
    ("model", "_validate_certificates"),
    ("model", "_probe_structure"),
    ("kkt.sparse_ldl", "dense_threshold"),
    ("kkt.levels", "_components"),
    ("kkt.levels", "_bfs_levels"),
    ("kkt.levels", "nd_block_order"),
    ("kkt.levels", "tile_fill"),
    ("kkt.levels", "column_levels"),
    ("kkt.sparse", "tile_plan"),
    ("kkt.sparse", "symbolic_schedule"),
    ("kkt.sparse", "k1_level_plan"),
    ("kkt.sparse", "k1_level_plan_pattern"),
    ("kkt.banded", "rcm_bandwidth"),
    ("linprog", "_fill_pbdata"),
    ("utils", "open_maybe_compressed"),
    ("utils", "pos_part"),
    ("utils", "neg_part"),
])
def test_host_function_is_verbatim_copy(module, name):
    import importlib

    import tulip_tpu  # noqa: F401

    ref = importlib.import_module(f"tulip_tpu.{module}")
    port = importlib.import_module(f"tulip_tpu_torch.{module}")
    assert inspect.getsource(getattr(port, name)) == \
        inspect.getsource(getattr(ref, name))

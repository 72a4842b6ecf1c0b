"""Packaging of the PyTorch port: it runs without JAX, and its host layers
stay verbatim copies of the JAX package's where the port does not edit
them."""

import functools
import inspect
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

VERBATIM = ["status.py", "solution.py", "params.py",
            "presolve/__init__.py", "presolve/ops.py", "io/__init__.py",
            "io/mps.py", "io/native.py", "io/semantics.py", "api.py",
            "kkt/native.py"]

# The host modules that the port edits in place (a bulk-loaded matrix kept
# in CSR/CSC arrays): each function, method and class of theirs that it
# leaves as the reference's. What it edits is held to the reference's
# outputs by tests/test_torch_problem_arrays.py.
UNEDITED = {
    "problem": [
        "SparseAxis", "ProblemData.__init__", "ProblemData.nnz",
        "ProblemData.get_coefficient", "ProblemData.add_constraint",
        "ProblemData.add_variable", "ProblemData.delete_constraint",
        "ProblemData.delete_constraints", "ProblemData.delete_variable",
        "ProblemData.delete_variables", "ProblemData.set_coefficient",
        "ProblemData.to_coo", "ProblemData.to_dense"],
    "presolve.presolve": [
        f"PresolveData.{m}" for m in (
            "_active_row", "_active_col", "compute_index_mapping",
            "_blank_reduced_solution", "_primal_infeasible_cert",
            "_dual_infeasible_cert", "remove_empty_row",
            "remove_empty_column", "remove_fixed_variable",
            "remove_row_singleton", "remove_forcing_row",
            "remove_free_column_singleton", "remove_dominated_column",
            "_fix_column_at", "remove_empty_rows", "remove_empty_columns",
            "remove_fixed_variables", "remove_row_singletons",
            "remove_forcing_rows", "remove_free_column_singletons",
            "remove_dominated_columns", "bounds_consistency_checks",
            "upgrade_if_both_infeasible", "presolve",
            "extract_reduced_problem")
    ] + ["postsolve", "ReducedArrays"],
    "presolve.native": ["_build", "_load", "native_available", "_p"],
}


def test_import_does_not_pull_in_jax():
    code = ("import sys, tulip_tpu_torch, tulip_tpu_torch.ipm, "
            "tulip_tpu_torch.kkt, tulip_tpu_torch.ops, "
            "tulip_tpu_torch.convert, tulip_tpu_torch.model, "
            "tulip_tpu_torch.cli, tulip_tpu_torch.api, tulip_tpu_torch.io, "
            "tulip_tpu_torch.kkt.gram, tulip_tpu_torch.ops.gram, "
            "tulip_tpu_torch.ops.solve, tulip_tpu_torch.ipm.mpc, "
            "tulip_tpu_torch.ipm.warmstart, tulip_tpu_torch.kkt.banded, "
            "tulip_tpu_torch.kkt.sparse, tulip_tpu_torch.kkt.levels, "
            "tulip_tpu_torch.kkt.native, tulip_tpu_torch.kkt.sparse_ldl, "
            "tulip_tpu_torch.ipm.sparse_data, tulip_tpu_torch.kkt.splitting, "
            "tulip_tpu_torch.kkt.dense_ldl, tulip_tpu_torch.kkt.extended, "
            "tulip_tpu_torch.kkt.mixed, tulip_tpu_torch.kkt.testkit, "
            "tulip_tpu_torch.ops.doubledouble, tulip_tpu_torch.kkt.schur, "
            "tulip_tpu_torch.parallel, tulip_tpu_torch.parallel.dryrun; "
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
    ("kkt.sparse_ldl", "_k2_pattern_perm"),
    ("kkt.sparse_ldl", "k2_tile_plan"),
    ("kkt.sparse_ldl", "k2_level_plan"),
    ("ipm.sparse_data", "standard_form_coo"),
    ("ipm.sparse_data", "sparse_pattern_signals"),
    ("kkt.levels", "_components"),
    ("kkt.levels", "_bfs_levels"),
    ("kkt.levels", "column_levels"),
    ("kkt.sparse", "tile_plan"),
    ("kkt.sparse", "symbolic_schedule"),
    ("kkt.sparse", "k1_level_plan"),
    ("kkt.banded", "rcm_bandwidth"),
    ("linprog", "_fill_pbdata"),
    ("utils", "open_maybe_compressed"),
    ("utils", "pos_part"),
    ("utils", "neg_part"),
] + [(module, name) for module, names in UNEDITED.items() for name in names])
def test_host_function_is_verbatim_copy(module, name):
    """``name`` (dotted for a method; a property is its getter) has the
    reference's source."""
    import importlib

    import tulip_tpu  # noqa: F401

    def source(package):
        obj = functools.reduce(
            getattr, name.split("."),
            importlib.import_module(f"{package}.{module}"))
        return inspect.getsource(getattr(obj, "fget", obj))

    assert source("tulip_tpu_torch") == source("tulip_tpu")


# Top-level names of the JAX package that the port does not have yet, each
# with the ROADMAP item that brings it: none.
NOT_YET = {}


def test_version_is_the_references():
    import tulip_tpu
    import tulip_tpu_torch

    assert tulip_tpu_torch.version() == tulip_tpu.version() == "0.1.0"


def test_every_public_top_level_name_is_ported():
    """Each public name of ``tulip_tpu`` (its ``__all__``, the functions
    and classes it defines, its subpackages and modules) exists in
    ``tulip_tpu_torch``, except those of ``NOT_YET``."""
    import importlib.util
    import pkgutil
    import types

    import tulip_tpu
    import tulip_tpu_torch

    names = set(tulip_tpu.__all__) | {
        n for n, v in vars(tulip_tpu).items()
        if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    missing = sorted(n for n in names if not hasattr(tulip_tpu_torch, n))
    missing += sorted(
        m.name for m in pkgutil.iter_modules(tulip_tpu.__path__)
        if importlib.util.find_spec(f"tulip_tpu_torch.{m.name}") is None)
    assert missing == sorted(NOT_YET)

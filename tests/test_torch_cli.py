"""Port parity: ``tulip_tpu_torch.cli.main`` against ``tulip_tpu.cli.main``
on the MPS files of tests/data, f64 at the CLI's defaults, on the CPU."""

import re
from pathlib import Path

import pytest
import torch

import tulip_tpu.cli as jcli
from tulip_tpu_torch import cli

torch.set_num_threads(1)

DATA = Path(__file__).resolve().parent / "data"
ROW = re.compile(r"^\s*\d+\s+[+-]\d\.\d{7}e[+-]\d\d\s")
RESULT = re.compile(r"^result: (\w+)(?: objective (\S+))?")


def parse(out):
    rows = [line for line in out.splitlines() if ROW.match(line)]
    result = [RESULT.match(line) for line in out.splitlines()
              if line.startswith("result:")]
    assert len(result) == 1, out
    z = result[0].group(2)
    return rows, result[0].group(1), None if z is None else float(z)


@pytest.fixture
def run_both(monkeypatch, capsys):
    # The reference CLI turns on a persistent XLA compile cache in $HOME;
    # it has no bearing on the comparison.
    monkeypatch.setattr(jcli, "_enable_compile_cache", lambda: None)

    def run(argv):
        rc_j = jcli.main(argv)
        out_j = capsys.readouterr().out
        rc_t = cli.main(argv, device="cpu")
        out_t = capsys.readouterr().out
        return (rc_j, *parse(out_j)), (rc_t, *parse(out_t))
    return run


@pytest.mark.parametrize("name,rc,z", [
    ("lp_opt", 0, 1.5), ("lp_inf", 1, None), ("lp_ubd", 1, None),
    ("lp_freevars", 0, 0.0)])
def test_cli_matches_jax(run_both, name, rc, z):
    (rc_j, rows_j, st_j, z_j), (rc_t, rows_t, st_t, z_t) = run_both(
        ["--OutputLevel", "1", str(DATA / f"{name}.mps")])
    assert rc_t == rc_j == rc
    assert st_t == st_j
    # One log row per IPM pass in both (row k = point k).
    assert len(rows_t) == len(rows_j)
    assert [r.split()[0] for r in rows_t] == [r.split()[0] for r in rows_j]
    if z is not None:
        # f64 on both sides; the iterates differ by summation order only.
        assert abs(z_t - z_j) <= 1e-9 * max(1.0, abs(z_j))
        assert abs(z_t - z) <= 1e-6


def test_cli_presolve_off_and_iteration_limit(run_both):
    (rc_j, rows_j, st_j, _), (rc_t, rows_t, st_t, _) = run_both(
        ["--Presolve", "0", "--IterationsLimit", "2",
         str(DATA / "lp_opt.mps")])
    assert (rc_t, st_t) == (rc_j, st_j) == (1, "ITERATION_LIMIT")
    assert len(rows_t) == len(rows_j) == 3


def test_cli_missing_file(capsys):
    assert cli.main([str(DATA / "no_such.mps")], device="cpu") == 2
    assert "no such file" in capsys.readouterr().err


@pytest.mark.parametrize("name", ["lp_opt", "lp_inf", "lp_ubd",
                                  "lp_freevars"])
@pytest.mark.parametrize("presolve", ["1", "0"])
def test_cli_mpc_matches_jax(run_both, name, presolve):
    """``--Method MPC`` through Model, the iteration log included. On an
    infeasible or unbounded file MPC's iterate runs off along the
    certificate ray (the dual objective grows tenfold a pass), where
    rounding-level differences move the detection by a pass: the logs'
    lengths are held equal only for an optimal run."""
    (rc_j, rows_j, st_j, z_j), (rc_t, rows_t, st_t, z_t) = run_both(
        ["--Method", "MPC", "--Presolve", presolve, "--OutputLevel", "1",
         str(DATA / f"{name}.mps")])
    assert (rc_t, st_t) == (rc_j, st_j)
    if st_j == "OPTIMAL":
        assert [r.split()[0] for r in rows_t] == \
            [r.split()[0] for r in rows_j]
        assert abs(z_t - z_j) <= 1e-9 * max(1.0, abs(z_j))
    else:
        assert abs(len(rows_t) - len(rows_j)) <= 1

"""An entry whose requests span two processes (``gloo_peer_entry.py``: a
Gloo peer started in ``prepare``, one collective pair a request, the peer
stopped in ``release``) runs through ``run_cell`` as any other, and
leaves no process behind, also where a request raises. Each run is a
process of its own session, under a time limit: whatever it leaves is
killed at the end."""

import json
import os
import signal
import subprocess
import sys
import time

import pytest

from portbench.harness import ROOT

SEED = 2 ** 31 + 131
LIMIT_S = 240

CODE = """
import json, sys
from portbench import harness
real = harness.load_module
harness.load_module = lambda path: real(
    "tests/gloo_peer_entry.py" if path == "entries/gloo_peer.py" else path)
traffic = dict(entry="gloo_peer", batch=4, pool=2, trace_seconds=0.2)
traffic.update(json.loads(sys.argv[2]))
res, lines = harness.run_cell("randlp48.linprog", int(sys.argv[1]), 0.5,
                              int(sys.argv[3]), device="cpu",
                              overrides=dict(traffic=traffic))
print(json.dumps(res))
"""


def _left(pgid) -> bool:
    """Whether a process of the group ``pgid`` is still there."""
    try:
        os.killpg(pgid, 0)
    except ProcessLookupError:
        return False
    return True


def _run(traffic: dict, trace: int):
    """(exit code, standard output, standard error, whether a process of
    the run's group outlived it by 5 s)."""
    proc = subprocess.Popen(
        [sys.executable, "-c", CODE, str(SEED), json.dumps(traffic),
         str(trace)], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, start_new_session=True,
        env={**os.environ, "OMP_NUM_THREADS": "1"})
    try:
        out, err = proc.communicate(timeout=LIMIT_S)
        deadline = time.monotonic() + 5
        while _left(proc.pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        left = _left(proc.pid)
    finally:
        if _left(proc.pid):
            os.killpg(proc.pid, signal.SIGKILL)
        proc.kill()
        proc.wait()
    return proc.returncode, out, err, left


@pytest.mark.parametrize("trace", [0, 1])
def test_entry_with_a_gloo_peer_runs_and_stops_it(trace):
    rc, out, err, left = _run({}, trace)
    assert rc == 0, err[-4000:]
    res = json.loads(out.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0
    assert "a Gloo group with one peer process" in err
    assert "ended with exit code 0" in err
    assert not left


def test_entry_with_a_gloo_peer_stops_it_when_a_request_raises():
    rc, out, err, left = _run({"fail_at": 2}, 0)
    assert rc != 0
    assert "request 2 fails" in err
    assert "ended with exit code 0" in err
    assert out == ""
    assert not left

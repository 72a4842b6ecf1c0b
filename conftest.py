"""Repository-wide pytest setup: build the C++ engines of ``native/`` once.

The native MPS reader, presolve engine and symbolic analysis are shared
libraries under ``native/build/`` (git-ignored). Their Python loaders run
``make -C native`` at first use when a library is missing. Under
pytest-xdist, every worker would do that at once on a fresh checkout, and
concurrent ``make`` runs write the same ``.so`` files: a worker can then
load a half-written library or time a build inside a timed call. So the
controlling process builds them here, once, before any worker starts
(workers carry ``config.workerinput``; a run without xdist builds here
too). A failed or slow build only warns: the loaders then behave as they
would without this hook, and the tests that need the libraries skip.

Each test module also starts from a fully collected heap (see
``_collect_garbage_before_module``).
"""

from __future__ import annotations

import gc
import os
import subprocess
import warnings

import pytest

_NATIVE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native")
BUILD_TIMEOUT_S = 300


def pytest_configure(config):
    if hasattr(config, "workerinput"):
        return
    try:
        proc = subprocess.run(["make", "-C", _NATIVE], capture_output=True,
                              text=True, timeout=BUILD_TIMEOUT_S)
    except (OSError, subprocess.TimeoutExpired) as exc:
        warnings.warn(f"make -C native did not run to an end: {exc}")
        return
    if proc.returncode != 0:
        warnings.warn(f"make -C native failed ({proc.returncode}):\n"
                      f"{proc.stdout}{proc.stderr}")


@pytest.fixture(autouse=True, scope="module")
def _collect_garbage_before_module():
    """Run a full garbage collection before each test module.

    A worker that has imported JAX and PyTorch holds a heap that a full
    (generation-2) collection takes a few tenths of a second to walk.
    CPython starts one once the objects promoted since the last full
    collection exceed a quarter of those that survived it, inside whatever
    call is running then. Left to chance, it lands in timed calls, such as
    the native-against-Python parse comparison of
    ``tests/test_native_mps.py``. Collecting here resets that count, so a
    module's timings pay only for the objects the module itself makes.
    """
    gc.collect()
    yield

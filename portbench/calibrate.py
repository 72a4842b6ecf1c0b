"""Readings for the limits of a cell's check: the numbers that the check
compares, from runs of the program (or, with ``--control``, of its
lower-precision path) on many seeds in one process, one JSON line a seed.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        --seconds <s> [--control]

The benchmark's own runs never call this.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
# One host thread for the math libraries: the host's cores are shared, and
# idle worker threads that spin make host-bound requests vary.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"
sys.path[0] = ROOT

import json  # noqa: E402
import argparse  # noqa: E402

from portbench import harness  # noqa: E402


def main(argv) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    for seed in (int(s) for s in a.seeds.split(",")):
        t0 = time.perf_counter()
        result, lines = harness.run_cell(a.workload, seed, a.seconds, 0,
                                         control=a.control)
        print(json.dumps({
            "workload": a.workload, "seed": seed, "control": a.control,
            "correct": result["correct"], "attempted": result["attempted"],
            "checks": {k: c["value"] for k, c in result["checks"].items()},
            "metrics": {k: m["value"] for k, m in result["metrics"].items()},
            "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Run one benchmark cell once and print its result as the last line of stdout.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Without a CUDA card (or with fewer than the
cell asks for) it prints no result and exits with 2; if a module of JAX or
of the JAX package is loaded once the window has closed, with 3.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# only the checkout's root: this directory's modules are the package ``benchmark``
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "benchmark" / "nv_cache"))
# one process with few threads: the host work of a window is one Python thread launching kernels
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(var, "1")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from benchmark.harness import run_cell

    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    if result is None:
        return 2
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

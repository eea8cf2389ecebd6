"""The readings the limits of ``correct`` are set from, on the chip, many seeds in one process.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11,12,13 --seconds 4 [--control fp8]

For each seed: the program built from that seed's weights, two warm
rounds, rounds for ``--seconds`` at the cell's own load, the program's
state freed, and the sample judged as a run judges it: the program's
``logit_err`` and, with ``--control``, the control's (the reference
computed in the lower precision, ``fp8`` or ``int4``, in the program's
place, read at each position of the same prompts and served tokens
against the float32 reference). One JSON line per seed, with the
``correct`` that a run decides from the program's readings and, under
each control, the one it decides with the control's readings in their
place (``harness.decide``, the cell's own limits).
The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:] = [str(ROOT)] + [p for p in sys.path if Path(p or ".").resolve() != ROOT / "benchmark"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated whole numbers")
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", action="append", default=[], choices=("fp8", "int4"))
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import Cell, Session, decide, has_card

    cell = Cell(args.workload)
    if not has_card(cell):
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        sess = Session(cell, seed, torch.device("cuda"))
        for _ in range(2):
            sess.one_round(count=False)
        sess.window(args.seconds, spans=False)
        sess.free_program()
        verdict = sess.judge(controls=tuple(args.control))
        n, failed = len(sess.run.records), sess.driver.failed()
        verdict["correct"] = decide(verdict, cell.limits, n, failed)[0]
        for low in verdict.get("control", {}).values():
            low["correct"] = decide(low, cell.limits, n, failed)[0]
        print(json.dumps({"workload": args.workload, "seed": seed, "windows": n, **verdict}), flush=True)
        del sess
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

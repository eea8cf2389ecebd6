"""Diff two debug traces (Tools/compareTraces analogue).

Counterpart of ``tools/compare_traces.py``, on ``whisper_tpu_torch.obs.trace``.
The trace format is the JAX package's, so either side may come from either
package:

    python -m whisper_tpu_torch.tools.compare_traces /tmp/run_card /tmp/run_ref [--top 20]
"""

from __future__ import annotations

import argparse
from collections.abc import Sequence

from whisper_tpu_torch.obs.trace import compare_traces, print_compare


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("trace_a")
    ap.add_argument("trace_b")
    ap.add_argument("--top", type=int, default=0, help="show only worst N")
    args = ap.parse_args(argv)

    diffs = compare_traces(args.trace_a, args.trace_b)
    if args.top:
        diffs = sorted(diffs, key=lambda d: -d.max_abs_diff)[: args.top]
    print(print_compare(diffs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

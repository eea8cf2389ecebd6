"""Named-intermediate tracing + offline compare.

Counterpart of ``whisper_tpu.obs.trace``, with the same trace format, so a
trace of either package compares against a trace of the other. The reference streams every named tensor (``Tracing::tensor("enc-Qcur", ...)``)
to a binary trace under SAVE_DEBUG_TRACE and diffs two traces with
Tools/compareTraces (SURVEY.md §4.4). Equivalent here:

  tracer = TraceWriter("/tmp/run_a")       # or None to disable
  tracer.tensor("enc.block3.attn", x)      # works on torch or numpy arrays
  ...
  report = compare_traces("/tmp/run_a", "/tmp/run_b")

Traces are directories of .npy files plus a manifest preserving order.
PyTorch runs eagerly, so ``traced()`` writes its tensor at once (through
``.detach().cpu()``; bf16, which numpy lacks, is written as f32).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple

import numpy as np
import torch


class TraceWriter:
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._order: list[str] = []
        self._counts: dict[str, int] = {}

    def _slot(self, name: str) -> str:
        n = self._counts.get(name, 0)
        self._counts[name] = n + 1
        return f"{name}#{n}" if n else name

    def tensor(self, name: str, value) -> None:
        slot = self._slot(name)
        arr = _to_numpy(value)
        fname = slot.replace("/", "_").replace("#", "__") + ".npy"
        np.save(os.path.join(self.path, fname), arr)
        self._order.append(slot)
        with open(os.path.join(self.path, "manifest.json"), "w") as f:
            json.dump(self._order, f)

    def callback(self, name: str):
        """A function that records its argument under ``name``."""

        def cb(value):
            self.tensor(name, value)

        return cb


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        if value.dtype == torch.bfloat16:
            value = value.float()
        return value.numpy()
    return np.asarray(value)


def traced(tracer: "TraceWriter | None", name: str, x):
    """Identity that records x when tracing is on — sprinkle through model
    code like the reference's Tracing::tensor calls."""
    if tracer is not None:
        tracer.tensor(name, x)
    return x


class TraceDiff(NamedTuple):
    name: str
    max_abs_diff: float
    avg_diff_squared: float
    shape_a: tuple
    shape_b: tuple


def compare_traces(path_a: str, path_b: str) -> list[TraceDiff]:
    """Per-tensor maxAbsDiff / avgDiffSquared like compareTraces
    (Tools/compareTraces/compare.cpp:60-120) and sTensorDiff
    (Whisper/ML/testUtils.h:26-45)."""
    with open(os.path.join(path_a, "manifest.json")) as f:
        order_a = json.load(f)
    with open(os.path.join(path_b, "manifest.json")) as f:
        order_b = json.load(f)

    out: list[TraceDiff] = []
    for slot in order_a:
        if slot not in order_b:
            continue
        fname = slot.replace("/", "_").replace("#", "__") + ".npy"
        a = np.load(os.path.join(path_a, fname)).astype(np.float64)
        b = np.load(os.path.join(path_b, fname)).astype(np.float64)
        if a.shape != b.shape:
            out.append(TraceDiff(slot, float("inf"), float("inf"), a.shape, b.shape))
            continue
        d = a - b
        out.append(
            TraceDiff(
                slot,
                float(np.max(np.abs(d))) if d.size else 0.0,
                float(np.mean(d * d)) if d.size else 0.0,
                a.shape,
                b.shape,
            )
        )
    return out


def print_compare(diffs: list[TraceDiff]) -> str:
    lines = [f"{'tensor':<40} {'maxAbsDiff':>12} {'avgDiffSq':>12}"]
    for d in diffs:
        lines.append(f"{d.name:<40} {d.max_abs_diff:>12.3e} {d.avg_diff_squared:>12.3e}")
    return "\n".join(lines)

"""Phase profiler + timings report.

Counterpart of ``whisper_tpu.obs.profiler`` (the reference's
ProfileCollection / CpuProfiler and ``timingsPrint``). Blocks carry the
reference's phase taxonomy (Spectrogram, Encode, Decode, Callbacks, ...)
and are timed by the host clock around work that ends in a device sync.
Device memory comes from ``torch.cuda.memory_stats``, kernel timelines
from ``torch.profiler`` (``device_trace``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import OrderedDict


@dataclasses.dataclass
class _Entry:
    calls: int = 0
    total_s: float = 0.0


class Profiler:
    def __init__(self):
        self._cpu: "OrderedDict[str, _Entry]" = OrderedDict()
        self._mem_notes: dict[str, float] = {}

    def reset(self) -> None:
        self._cpu.clear()
        self._mem_notes.clear()

    @contextlib.contextmanager
    def cpu(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            e = self._cpu.setdefault(name, _Entry())
            e.calls += 1
            e.total_s += time.perf_counter() - t0

    def note_memory(self, name: str, mb: float) -> None:
        self._mem_notes[name] = mb

    def add(self, name: str, seconds: float, calls: int = 1) -> None:
        e = self._cpu.setdefault(name, _Entry())
        e.calls += calls
        e.total_s += seconds

    def get(self, name: str) -> float:
        e = self._cpu.get(name)
        return e.total_s if e else 0.0

    def report(self) -> str:
        lines = ["host phases:"]
        for name, e in self._cpu.items():
            avg = e.total_s / max(1, e.calls)
            lines.append(
                f"  {name:<14} {e.calls:>6} calls, {e.total_s*1e3:10.2f} ms total, "
                f"{avg*1e3:10.3f} ms avg"
            )
        if self._mem_notes:
            lines.append("memory:")
            for name, mb in self._mem_notes.items():
                lines.append(f"  {name:<14} {mb:10.1f} MB")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace scope (the JAX package's jax.profiler scope):
    host ops, and the card's kernels where there is a card, written to
    ``log_dir/trace.json`` in Chrome's trace format (chrome://tracing,
    Perfetto). Yields the profiler, whose ``key_averages()`` sums the
    kernels by name."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> dict:
    """Device memory per CUDA device (getMemoryUse analogue); empty without
    a card."""
    import torch

    out = {}
    if not torch.cuda.is_available():
        return out
    for i in range(torch.cuda.device_count()):
        stats = torch.cuda.memory_stats(i)
        out[f"cuda:{i}"] = {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
        }
    return out

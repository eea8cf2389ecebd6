"""Phase profiler + timings report.

Counterpart of ``whisper_tpu.obs.profiler`` (the reference's
ProfileCollection / CpuProfiler and ``timingsPrint``). Blocks carry the
reference's phase taxonomy (Spectrogram, Encode, Decode, Callbacks, ...)
and are timed by the host clock around work that ends in a device sync.
Device memory comes from ``torch.cuda.memory_stats``.
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

    def reset(self) -> None:
        self._cpu.clear()

    @contextlib.contextmanager
    def cpu(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            e = self._cpu.setdefault(name, _Entry())
            e.calls += 1
            e.total_s += time.perf_counter() - t0

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
        return "\n".join(lines)


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

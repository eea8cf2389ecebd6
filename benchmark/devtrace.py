"""Spans around the calls into the program, and the device trace of a few rounds.

``Spans`` times each call into a layer of the program (mel, encode,
decode) on the host clock between two ``torch.cuda.synchronize()``, and
marks it in the profiler's timeline (``record_function``), so that an idle
stretch of the card can be named by the call the host was in.

``read_trace`` reduces a ``torch.profiler`` trace (CUPTI) to: the union of
the intervals in which any operation ran on the card (``busy_s``) within
the traced span (``window_s``), the device seconds and count of the
kernels whose names hold a pattern, the operations that took most device
time, and the longest idle gaps with the span that was open on the host.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch

SPAN = "bench:"


class Spans:
    """Synchronised host-clock spans, kept in memory: ``ms[name]`` lists one
    duration per call."""

    def __init__(self, on: bool, sync):
        self.on = on
        self.sync = sync
        self.ms: dict[str, list[float]] = defaultdict(list)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.on:
            yield
            return
        self.sync()
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN + name):
            yield
            self.sync()
        self.ms[name].append((time.perf_counter() - t0) * 1e3)


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def read_trace(prof, patterns: dict[str, str], top: int = 10) -> dict:
    """The trace's summary. ``patterns`` maps a label to a substring of
    kernel names; each label gets (device seconds, kernels)."""
    device, spans, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        start = ev.start_ns()
        end = start + ev.duration_ns()
        if ev.name().startswith(SPAN):
            if ev.device_type() != torch.autograd.DeviceType.CUDA:   # not their GPU-side copies
                if ev.name() == SPAN + "traced":
                    window = (start, end)
                else:
                    spans.append((ev.name()[len(SPAN):], start, end))
        elif ev.device_type() == torch.autograd.DeviceType.CUDA:
            device.append((ev.name(), start, end))
    if window is None or not device:
        return {}
    lo, hi = window
    busy = _merge([(max(s, lo), min(e, hi)) for _, s, e in device if e > lo and s < hi])
    by_name: dict[str, float] = defaultdict(float)
    for name, s, e in device:
        by_name[name[:120]] += (e - s) / 1e9
    found = {label: [sum((e - s) / 1e9 for n, s, e in device if pat in n),
                     sum(1 for n, _, _ in device if pat in n)] for label, pat in patterns.items()}
    gaps = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            mid = (s + e) // 2
            open_ = [(ss, n) for n, ss, ee in spans if ss <= mid < ee]
            gaps.append((max(open_)[1] if open_ else "host, outside the spans", (e - s) / 1e9))
    gaps.sort(key=lambda g: -g[1])
    return {
        "window_s": (hi - lo) / 1e9,
        "busy_s": sum(e - s for s, e in busy) / 1e9,
        "kernels": len(device),
        "found": found,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:top],
        "idle_gaps": gaps[:top],
    }

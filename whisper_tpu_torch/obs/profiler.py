"""Phase profiler, device-clocked spans and counters, and the timings report.

Counterpart of ``whisper_tpu.obs.profiler`` (the reference's
ProfileCollection / CpuProfiler and ``timingsPrint``). A ``Profiler`` keeps:

- host phases (``cpu``): the reference's phase taxonomy (Spectrogram,
  Encode, Decode, Callbacks, ...) on the host clock, always on; the
  Context's ``--timings`` report;
- spans (``span``): where the runtime's own time goes, on the host clock
  and on the card's (a pair of CUDA events on the current stream; on the
  CPU the device time is the host time), aggregated by (parent, name);
- counters (``count``): integer and float totals of rare events, always on.

``TRACER`` is the process-wide instance that the runtime reports into. It
outlives every runtime, so its totals can be read after a model is freed.
Its spans are off by default, and then a span costs one check and nothing
else: no CUDA event, no ``record_function``, no allocation. They are on
while an operator has called ``enable()`` (the CLI's ``--timings``) or a
``torch.profiler`` session is recording. Event pairs are resolved without
a synchronise: each new span takes the results of the pairs that have
completed, and the rest are waited for only when the totals are read.

The runtime's spans and counters (name: where it is recorded):

  encode          runtime/context.py WhisperRuntime.encode_window
    cross_kv      the cross K/V precompute in it (int8 quantize included)
  decode          runtime/context.py WhisperRuntime.run_window,
                  runtime/beam.py decode_window_beam
    ingest        runtime/decode.py decode_window, runtime/beam.py
                  _beam_window: the prompt ingest and the state reset
    steps         runtime/decode.py run_steps: units = token steps launched
  graph_captures  runtime/graph.py Slot.step: captured steps made
  capture_ms      the same: host ms of the build check, warm-up and capture

  omni_encode     runtime/omni.py OmniContext.encode_window: encoder, connector
  omni_prefill    runtime/omni.py OmniContext.run_window: the state reset and
                  the eager prefill of the prompt and audio positions
  omni_steps      the same: the replayed token steps; units = steps launched
  moe.tokens, moe.routed_slots, moe.null_slots, moe.experts_touched,
  moe.experts_read, moe.step_layers
                  the same, when a window's result is copied back: token-layer
                  pairs through an expert layer, their kept routed and null
                  choices, the routed experts some lane chose at each step's
                  layers, the routed experts those layers read (counted on the
                  device by kernels/moe.py), and the steps' layers
  longcat_encode, longcat_prefill, longcat_steps
                  runtime/longcat.py LongcatContext: the same spans of the
                  longcat family; its counters are the moe.* above (the
                  experts read and touched being this card's held ones),
                  with moe.zero_slots and moe.held_slots for moe.null_slots

Inside ``device_trace`` (an ``annotated()`` scope) each span is also a
``record_function`` range named ``wtt:<name>``, so the program's spans sit
on the trace's timeline beside the kernels they launched. No other profiler
session gets these ranges.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import OrderedDict, deque

import torch
import torch.autograd.profiler as _autograd_profiler   # its flag is read at every span

ANNOTATION = "wtt:"


@dataclasses.dataclass
class _Entry:
    calls: int = 0
    total_s: float = 0.0


@dataclasses.dataclass
class SpanStats:
    """Totals of one span name: calls, units (token steps for ``steps``),
    host ms and device ms."""

    calls: int = 0
    units: int = 0
    host_ms: float = 0.0
    device_ms: float = 0.0


class _Off:
    """The span of a tracer that is off: one shared object that does nothing."""

    __slots__ = ("units",)

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("prof", "name", "units", "device", "parent", "t0", "events", "annotation")

    def __init__(self, prof: "Profiler", name: str, units: int, device):
        self.prof, self.name, self.units, self.device = prof, name, units, device
        self.events = self.annotation = None

    def __enter__(self):
        prof = self.prof
        stack = prof._stack()
        self.parent = stack[-1] if stack else None
        stack.append(self.name)
        if prof._annotate:
            self.annotation = torch.profiler.record_function(ANNOTATION + self.name)
            self.annotation.__enter__()
        if self.device is not None:
            self.events = prof._event_pair(self.device)
            self.events[0].record(torch.cuda.current_stream(self.device))
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(self.device))
        t1 = time.perf_counter_ns()
        if self.annotation is not None:
            self.annotation.__exit__(None, None, None)
        self.prof._stack().pop()
        self.prof._close(self, (t1 - self.t0) / 1e6)
        return False


class Profiler:
    def __init__(self):
        self._cpu: "OrderedDict[str, _Entry]" = OrderedDict()
        self._spans: "OrderedDict[tuple[str | None, str], SpanStats]" = OrderedDict()
        self._pending: deque = deque()         # (stats, (start, end), device) not yet resolved
        self._free: dict[torch.device, list] = {}
        self.counters: dict[str, float] = {}
        self._on = False
        self._annotate = 0                     # open annotated() scopes
        self._lock = threading.Lock()
        self._local = threading.local()

    def reset(self) -> None:
        with self._lock:
            self._cpu.clear()
            self._spans.clear()
            self._pending.clear()
            self.counters.clear()

    # ---- host phases ------------------------------------------------------

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

    # ---- spans ------------------------------------------------------------

    def enable(self) -> None:
        self._on = True

    @contextlib.contextmanager
    def annotated(self):
        """Within the block, each span is also a ``record_function`` range
        named ``wtt:<name>`` (for a profiler session that reads them)."""
        self._annotate += 1
        try:
            yield
        finally:
            self._annotate -= 1

    def disable(self) -> None:
        self._on = False

    def span(self, name: str, units: int = 1, device: torch.device | None = None):
        """A span of the work inside the ``with`` block. ``device``: where
        that work runs; on a CUDA device the span is also timed by a pair of
        events on its current stream. ``units`` may be set on the object the
        ``with`` gives, before the block ends. Nothing is recorded while the
        tracer is off, nor while the current stream is capturing a graph."""
        if not (self._on or _autograd_profiler._is_profiler_enabled):
            return _OFF
        if torch.cuda.is_initialized() and torch.cuda.is_current_stream_capturing():
            return _OFF
        self._resolve(wait=False)
        if device is None or device.type != "cuda":
            return _Span(self, name, units, None)
        if device.index is None:                # an event pair stays on the card it was made for
            device = torch.device("cuda", torch.cuda.current_device())
        return _Span(self, name, units, device)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event_pair(self, device: torch.device):
        with self._lock:
            free = self._free.get(device)
            if free:
                return free.pop()
        return (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))

    def _close(self, sp: _Span, host_ms: float) -> None:
        with self._lock:
            st = self._spans.get((sp.parent, sp.name))
            if st is None:
                st = self._spans[(sp.parent, sp.name)] = SpanStats()
            st.calls += 1
            st.units += sp.units
            st.host_ms += host_ms
            if sp.events is None:
                st.device_ms += host_ms
            else:
                self._pending.append((st, sp.events, sp.device))

    def _resolve(self, wait: bool) -> None:
        """Adds the device ms of the event pairs that have completed, in
        the order they were recorded; with ``wait``, of every pair."""
        with self._lock:
            while self._pending:
                st, (start, end), device = self._pending[0]
                if wait:
                    end.synchronize()
                elif not end.query():
                    break
                st.device_ms += start.elapsed_time(end)
                self._pending.popleft()
                self._free.setdefault(device, []).append((start, end))

    def spans(self) -> "OrderedDict[tuple[str | None, str], SpanStats]":
        """Every span's totals by (parent, name), its device ms resolved."""
        self._resolve(wait=True)
        with self._lock:
            return OrderedDict((k, dataclasses.replace(v)) for k, v in self._spans.items())

    def stats(self, name: str) -> SpanStats | None:
        """The totals of the spans named ``name``, under any parent; None if
        there was none."""
        found = [v for (_, n), v in self.spans().items() if n == name]
        if not found:
            return None
        return SpanStats(*(sum(getattr(v, f.name) for v in found)
                           for f in dataclasses.fields(SpanStats)))

    def self_ms(self, name: str) -> float:
        """Device ms of the spans named ``name`` less that of the spans
        opened directly inside them."""
        all_ = self.spans()
        return (sum(v.device_ms for (_, n), v in all_.items() if n == name)
                - sum(v.device_ms for (p, _), v in all_.items() if p == name))

    # ---- counters ---------------------------------------------------------

    def count(self, name: str, value: float = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + value

    # ---- report -----------------------------------------------------------

    def report(self) -> str:
        lines = []
        if self._cpu:
            lines.append("host phases:")
        for name, e in self._cpu.items():
            avg = e.total_s / max(1, e.calls)
            lines.append(
                f"  {name:<14} {e.calls:>6} calls, {e.total_s*1e3:10.2f} ms total, "
                f"{avg*1e3:10.3f} ms avg"
            )
        spans = self.spans()
        if spans:
            lines.append("spans (device ms; on the CPU, host ms):")
        for (parent, name), s in spans.items():
            label = f"{parent}/{name}" if parent else name
            per = f", {s.device_ms / s.units:8.3f} ms per step" if name == "steps" and s.units else ""
            lines.append(f"  {label:<16} {s.calls:>6} calls, {s.device_ms:10.2f} ms total, "
                         f"{s.device_ms / s.calls:10.3f} ms avg{per}")
        if self.counters:
            lines.append("counters: " + ", ".join(
                f"{k} {v:.1f}" if isinstance(v, float) else f"{k} {v}" for k, v in self.counters.items()))
        return "\n".join(lines)


TRACER = Profiler()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace scope (the JAX package's jax.profiler scope):
    host ops, and the card's kernels where there is a card, written to
    ``log_dir/trace.json`` in Chrome's trace format (chrome://tracing,
    Perfetto), with ``TRACER``'s spans as ``wtt:<name>`` ranges. Yields the
    profiler, whose ``key_averages()`` sums the kernels by name."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof, TRACER.annotated():
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_memory_stats() -> dict:
    """Device memory per CUDA device (getMemoryUse analogue); empty without
    a card."""
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

"""Token steps captured as CUDA graphs and replayed.

The port's counterpart of ``lax.while_loop``'s compiled body. A token step
of the greedy loop (``runtime/decode.py:greedy_step``) or the beam loop
(``runtime/beam.py:beam_step``) launches 1,600-2,600 kernels at large-v2
and reads and writes tensors on the card alone. Launched eagerly, each
launch costs the host more than the card spends on it, so the card idles
for most of a step. Captured once as a ``torch.cuda.CUDAGraph``, the step
is replayed with one host call.

A graph bakes in the addresses it was captured with. So the runtime keeps,
per shape of loop (a ``Slot``: loop kind, lanes, prompt capacity, the cross
K/V's shapes), the tensors a step reads and writes: the loop state, the
self cache (zeroed every window) and a copy of the window's cross K/V
(one device copy a window, far cheaper than a capture), and, per set of
the loop's constants, one captured step. Before a slot's first capture the
kernels are built and the step runs twice on the slot's zero state on a
side stream (lazy initialisation of cuBLAS and the kernel libraries, as
the PyTorch graph recipe asks); each window resets the state after that.
A slot's graphs share one memory pool: they never run at once.

The kernel wrappers count launches in Python, in the kernel layer's
ledger ``kernels._build.LAUNCHES``, which a replay does not run. A capture
records the counts its step's wrappers added (and takes them back: a
capture launches nothing), and every replay adds them. The warm-up steps'
launches are set-up, not token steps, and are taken back too, so the
ledger counts the launches of the token steps a window ran. This module
names no kernel: a new wrapper's counts are replayed with the rest.

A capture or replay that fails raises; nothing falls back to the eager
step.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable

import torch

from whisper_tpu_torch.kernels._build import LAUNCHES, build_all
from whisper_tpu_torch.obs.profiler import TRACER

WARMUP_STEPS = 2


def _restore(saved: collections.Counter) -> None:
    LAUNCHES.clear()
    LAUNCHES.update(saved)


class CapturedStep:
    """``step`` captured as a CUDA graph on ``stream`` in the memory pool
    ``pool``. Calling it replays the graph and adds to ``LAUNCHES`` the
    launches the capture recorded (``launches``, a ``Counter`` by wrapper
    name). ``capture_ms``: host time of the capture and the graph's
    instantiation; ``replays``: how often it was replayed."""

    def __init__(self, step: Callable[[], None], pool, stream: torch.cuda.Stream):
        before = LAUNCHES.copy()
        self.graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(self.graph, pool=pool, stream=stream,
                                  capture_error_mode="thread_local"):
                step()
            torch.cuda.synchronize()
            self.launches = LAUNCHES - before
        finally:
            _restore(before)
        self.capture_ms = (time.perf_counter() - t0) * 1e3
        self.replays = 0
        self._adds = list(self.launches.items())

    def __call__(self) -> None:
        self.graph.replay()
        self.replays += 1
        for name, n in self._adds:
            LAUNCHES[name] += n


def _tensors(*trees):
    for tree in trees:
        for a in tree:
            if isinstance(a, torch.Tensor):
                yield a


class Slot:
    """The static tensors of one loop shape (``state``, ``kv``: the self
    cache, a NamedTuple of tensors (K and V, or one latent tensor),
    ``cross``: the window's cross K/V), all zeros at first, and the steps
    captured over them, by the loop's constants."""

    def __init__(self, state, kv, cross):
        self.state, self.kv, self.cross = state, kv, cross
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device=next(_tensors(kv)).device)
        self.steps: dict[tuple, CapturedStep] = {}

    @property
    def nbytes(self) -> int:
        """Bytes of the static tensors (the graphs' pool comes on top:
        ``pool_bytes``)."""
        return sum(a.nbytes for a in _tensors(self.state, self.kv, self.cross))

    def pool_bytes(self) -> int:
        """Bytes the caching allocator holds in this slot's graph pool."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)

    def load(self, cross_kv) -> None:
        """A window's inputs: its cross K/V copied in, the self cache zeroed."""
        for dst, src in zip(self.cross, cross_kv):
            if dst is not None:
                dst.copy_(src)
        for a in self.kv:
            if a is not None:
                a.zero_()

    def step(self, key: tuple, body: Callable[[], None]) -> CapturedStep:
        """The step captured for ``key``, capturing ``body`` at first use.
        Call it before a window resets the state: the warm-up before a
        slot's first capture runs ``body`` on the state. Each capture adds
        to ``TRACER``'s counters ``graph_captures`` and ``capture_ms`` (the
        host ms of the build check, the warm-up and the capture)."""
        if key not in self.steps:
            t0 = time.perf_counter()
            if not self.steps:
                build_all()
                before = LAUNCHES.copy()
                self.stream.wait_stream(torch.cuda.current_stream())
                with torch.cuda.stream(self.stream):
                    for _ in range(WARMUP_STEPS):
                        body()
                torch.cuda.current_stream().wait_stream(self.stream)
                _restore(before)
            self.steps[key] = CapturedStep(body, self.pool, self.stream)
            TRACER.count("graph_captures")
            TRACER.count("capture_ms", (time.perf_counter() - t0) * 1e3)
        return self.steps[key]


class StepGraphs:
    """A runtime's slots by shape. ``lock`` serialises the windows that use
    them (run_capture decodes on worker threads)."""

    def __init__(self):
        self.slots: dict[tuple, Slot] = {}
        self.lock = threading.Lock()

    def slot(self, key: tuple, make: Callable[[], Slot]) -> Slot:
        if key not in self.slots:
            self.slots[key] = make()
        return self.slots[key]

    def replays(self) -> int:
        """Replays of every captured step so far: the token steps the card
        ran, a read behind's last step included."""
        return sum(st.replays for slot in self.slots.values() for st in slot.steps.values())

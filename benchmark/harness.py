"""One run of one cell: set-up, the measured window, the trace, the check, the result line.

Everything particular to a cell is data or a file of its own, found by
name: the cell in ``BENCHMARK.json`` names its configuration (a file under
``benchmark/configs/``) and its traffic mix (``benchmark/traffic/<name>.json``,
read by ``benchmark/traffic.py``); each metric is a reader
``benchmark/metrics/<name>.py`` with ``read(run) -> float | None``; the
limit of each number compared is in ``benchmark/limits/<cell>.json``; and
the configuration's ``model_type`` names its family,
``benchmark/families/<model_type>.py``, loaded by path from the cell's
checkout (a configuration whose family has no file stops here, before
anything is drawn).

A family module supplies ``Driver(cfg, mix, seed, device, run, spans)``,
one seed's model of that kind, with:

  ``KERNELS``        label -> a fragment of kernel names, for ``devtrace.read_trace``
  ``draw()``         the raw weights from the seed, on the device
  ``build(raw)``     the program built from them (it keeps no reference to ``raw``)
  ``serve()``        the traffic from the mix, and the inputs it plays
  ``round(count)``   one round of every lane's next window, the windows returned;
                     its calls into the program under ``spans(name)``; with
                     ``count``, its records, latency, audio seconds and model
                     operations added to ``run`` (``records``, ``latency_ms``,
                     ``audio_s``, ``flops``)
  ``traced(wins)``   a traced round's counted work, added to ``run.traced``
  ``free()``         the program's state released
  ``failed()``       the count of the window's results out of range
  ``judge(controls)`` after ``free``: each number the cell's limits file names,
                     from a sample of ``run.records`` against the family's plain
                     reference, and under ``control`` each control's (``calibrate.py``)

Its plain reference goes under ``benchmark/reference/``, the arithmetic of
its kernels' bounds beside ``benchmark/counts.py``'s (which any family
imports), and readers of what it puts in ``run.traced`` under
``benchmark/metrics/``.

A run: the family's driver, the raw weights drawn on the card from the
seed, the program built from them, the traffic and its inputs made, two
warm rounds (the first builds the kernels from the checkout's cache and
captures the cell's step as a CUDA graph), then rounds for ``--seconds``
of wall time. With ``--trace 1`` the program's calls are spans
(synchronised) and a few more rounds run under the profiler. After the
window: no JAX module may be loaded, the program's state is freed, and a
sample of the finished windows is judged against the reference.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from benchmark import devtrace

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")   # whole top-level module names
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")   # a name, as BENCHMARK.json's
TRACE_SECONDS = 1.0          # rounds traced after the window: at least one, then until this long


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def process_age_s() -> float:
    """Seconds since this process started (Linux /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def card_line() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not read"


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_reader(metrics_dir: Path, name: str):
    """``read`` of the reader ``<metrics_dir>/<name>.py``."""
    return _load(metrics_dir / f"{name}.py", f"benchmark.metrics.{name}").read


def load_family(families_dir: Path, model_type) -> object:
    """The family module ``<families_dir>/<model_type>.py``; stops the run
    where there is none."""
    path = families_dir / f"{model_type}.py"
    if not (isinstance(model_type, str) and NAME.fullmatch(model_type) and path.is_file()):
        raise SystemExit(f"model_type {model_type!r}: no family file {path}. No result.")
    return _load(path, f"benchmark.families.{model_type}")


class Cell:
    """A cell's manifest entry, configuration, traffic mix, metrics and limits."""

    def __init__(self, name: str, root: Path = HERE.parent):
        manifest = json.loads((root / "BENCHMARK.json").read_text())
        cells = {w["name"]: w for w in manifest["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = cells[name]
        conf = {c["name"]: c for c in manifest["configs"]}[self.entry["config"]]
        self.cfg = json.loads((root / conf["file"]).read_text())
        self.dir = root / "benchmark"
        self.family = load_family(self.dir / "families", self.cfg.get("model_type"))
        self.mix = json.loads((self.dir / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((self.dir / "limits" / f"{name}.json").read_text())

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]


class Run:
    """What the metric readers read."""

    def __init__(self, cell: Cell):
        self.cell = cell
        self.lanes = cell.mix["lanes"]
        self.setup_s = 0.0
        self.window_s = 0.0
        self.audio_s = 0.0
        self.records: list[dict] = []
        self.latency_ms: list[float] = []
        self.flops = 0.0
        self.spans = None
        self.mel_audio_s = 0.0
        self.trace: dict = {}
        self.traced = {"rounds": 0}          # the traced rounds, and their work as the family counts it
        self.peak_window_bytes = 0
        self.setup_peak_bytes = 0


class Session:
    """One seed's driver (its program, traffic and inputs on the device) and its rounds."""

    def __init__(self, cell: Cell, seed: int, dev: torch.device):
        self.cell, self.seed, self.dev = cell, seed, dev
        self.cuda = dev.type == "cuda"
        self.run = Run(cell)
        self.spans = devtrace.Spans(False, self.sync)
        self.driver = drv = cell.family.Driver(cell.cfg, cell.mix, seed, dev, self.run, self.spans)
        t0 = time.perf_counter()
        raw = drv.draw()
        self.sync()
        t1 = time.perf_counter()
        drv.build(raw)
        del raw
        self.sync()
        t2 = time.perf_counter()
        drv.serve()
        log(f"set-up parts: raw weights drawn {t1 - t0:.2f} s, the program built (its kernels "
            f"loaded) {t2 - t1:.2f} s, traffic and its inputs {time.perf_counter() - t2:.2f} s")

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def one_round(self, count: bool) -> list:
        """One round of every lane's next window; ``count``: a round of the
        measured window, whose windows and work are recorded."""
        return self.driver.round(count)

    def window(self, seconds: float, spans: bool) -> None:
        """Rounds for ``seconds`` of wall time (the last one ends it)."""
        run = self.run
        self.spans.on = spans
        if self.cuda:
            run.setup_peak_bytes = torch.cuda.max_memory_allocated(self.dev)
            torch.cuda.reset_peak_memory_stats(self.dev)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            self.one_round(count=True)
        self.sync()
        run.window_s = time.perf_counter() - t0
        run.spans = {k: list(v) for k, v in self.spans.ms.items()}
        if self.cuda:
            run.peak_window_bytes = torch.cuda.max_memory_allocated(self.dev)

    def traced_rounds(self) -> None:
        """Rounds under the profiler: at least one, then until TRACE_SECONDS.
        Without a card the profiler records the host alone, and the trace
        holds no device reading."""
        from torch.profiler import ProfilerActivity, profile

        tr = self.run.traced
        activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        with profile(activities=activities) as prof:
            t1 = time.perf_counter()
            with torch.profiler.record_function(devtrace.SPAN + "traced"):
                while True:
                    wins = self.one_round(count=False)
                    tr["rounds"] += 1
                    self.driver.traced(wins)
                    if time.perf_counter() - t1 >= TRACE_SECONDS:
                        break
                self.sync()
        t2 = time.perf_counter()
        self.run.trace = devtrace.read_trace(prof, self.driver.KERNELS)
        found = {k: n for k, (_, n) in self.run.trace.get("found", {}).items()}
        log(f"trace: {tr['rounds']} rounds, {self.run.trace.get('kernels', 0)} device ops; kernels by "
            f"name {found}; counted {tr}; read in {time.perf_counter() - t2:.1f} s")

    def free_program(self) -> None:
        self.driver.free()
        if self.cuda:
            torch.cuda.empty_cache()

    def judge(self, controls: tuple = ()) -> dict:
        """The check of a sample of the window's windows (after ``free_program``)."""
        return self.driver.judge(controls)


def decide(readings: dict, limits: dict, windows: int, failed: int) -> tuple[bool, dict]:
    """``correct``, and each number compared beside its limit: some windows
    finished, none failed, and every reading at most its limit."""
    compared = {name: {"value": readings[name], "limit": lim["limit"]} for name, lim in limits.items()}
    return (windows > 0 and failed == 0 and all(c["value"] <= c["limit"] for c in compared.values()),
            compared)


def has_card(cell: Cell) -> bool:
    if torch.cuda.is_available() and torch.cuda.device_count() >= cell.entry["chips"]:
        return True
    log(f"{cell.name}: needs {cell.entry['chips']} CUDA card(s); torch sees "
        f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}. No result.")
    return False


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             look_for_chip: bool = True, root: Path | None = None) -> dict | None:
    """One run; its result line's object, or None (no card)."""
    cell = Cell(workload, root or HERE.parent)
    if look_for_chip and not has_card(cell):
        return None
    dev = torch.device(device)
    sess = Session(cell, seed, dev)
    run = sess.run
    t0 = time.perf_counter()
    for _ in range(2):
        sess.one_round(count=False)
    sess.sync()
    run.setup_s = process_age_s()
    log(f"set-up parts: two warm rounds (the graph's capture in the first) {time.perf_counter() - t0:.2f} s")
    log(f"{workload} seed {seed}: set-up {run.setup_s:.2f} s")

    sess.window(seconds, spans=trace)
    log(f"window: {len(run.records)} windows in {run.window_s:.3f} s, {run.audio_s:.1f} audio s")
    if trace:
        sess.traced_rounds()

    if sess.cuda:   # read after the window, so that no subprocess runs in the set-up
        log(f"card: {card_line()}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    bad = forbidden_modules()
    if bad:
        log(f"modules of JAX or of the JAX package are loaded: {', '.join(bad)}. No result.")
        raise SystemExit(3)
    peak = max(run.setup_peak_bytes, torch.cuda.max_memory_allocated(dev) if sess.cuda else 0)
    sess.free_program()
    verdict = sess.judge()

    failed = sess.driver.failed()
    correct, compared = decide(verdict, cell.limits, len(run.records), failed)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = load_reader(cell.dir / "metrics", m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(run.records), "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if sess.cuda else "cpu",
                         "kind": torch.cuda.get_device_name(dev) if sess.cuda else "cpu",
                         "count": cell.entry["chips"], "memory_peak_bytes": peak}}
    if trace and run.trace:
        result["device"].update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
        result["breakdown"] = {"device_ops": [list(x) for x in run.trace["device_ops"]],
                               "idle_gaps": [list(x) for x in run.trace["idle_gaps"]]}
    result["check"] = compared
    for name, c in compared.items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    return result

"""One run of one cell: set-up, the measured window, the trace, the check, the result line.

Everything particular to a cell is data, found by name: the cell in
``BENCHMARK.json`` names its configuration (a file under
``benchmark/configs/``) and its traffic mix (``benchmark/traffic/<name>.json``,
read by ``benchmark/traffic.py``); each metric is a reader
``benchmark/metrics/<name>.py`` with ``read(run) -> float | None``; the
limit of each number compared is in ``benchmark/limits/<cell>.json``.

A run: the raw weights drawn on the card from the seed, the program built
from them, the audio pool made, two warm rounds (the first builds the
kernels from the checkout's cache and captures the cell's token step as
a CUDA graph), then rounds for ``--seconds`` of wall time. Each round: a
new item's mel (its first window), the lanes' 30 s windows encoded
together, one window decode of ``steps`` forced token steps, the result on
the host, the prompts carried. With ``--trace 1`` the calls are spans
(synchronised) and a few more rounds run under the profiler. After the
window: no JAX module may be loaded, the program's state is freed, and a
sample of the finished windows is judged against the reference.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from benchmark import check, counts, devtrace
from benchmark.inputs import Dims, draw_pcm, draw_raw
from benchmark.reference import whisper_ref as ref
from benchmark.traffic import Traffic

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "whisper_tpu")   # whole top-level module names
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


def load_reader(metrics_dir: Path, name: str):
    """``read`` of the reader ``<metrics_dir>/<name>.py``."""
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name}",
                                                  metrics_dir / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


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
        self.mix = json.loads((self.dir / "traffic" / f"{self.entry['traffic']}.json").read_text())
        self.limits = json.loads((self.dir / "limits" / f"{name}.json").read_text())

        def mine(m):
            return name in m.get("workloads", [name])

        self.end_to_end = [m for m in manifest["end_to_end"] if mine(m)]
        self.per_layer = [m for m in manifest["per_layer"] if mine(m)]


class Run:
    """What the metric readers read."""

    def __init__(self, cell: Cell, dims: Dims, work: counts.Work):
        self.cell, self.dims, self.work = cell, dims, work
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
        # the traced rounds' work: K1's and K2's bounds and the kernels they launch
        self.traced = {"rounds": 0, "k1_bound_s": 0.0, "k1_kernels": 0, "k2_bound_s": 0.0,
                       "k2_calls": 0}
        self.peak_window_bytes = 0
        self.setup_peak_bytes = 0


class Session:
    """One seed's program, traffic and audio on the device, and its rounds."""

    def __init__(self, cell: Cell, seed: int, dev: torch.device):
        from benchmark.program import Program          # the program, after the card check
        self.cell, self.seed, self.dev = cell, seed, dev
        self.cuda = dev.type == "cuda"
        self.dims = dims = Dims(cell.cfg)
        self.sp = ref.specials(dims.n_vocab)
        self.run = Run(cell, dims, counts.Work(dims, cell.cfg["kv_int8"]))
        self.filters = ref.mel_filters(dims.n_mels)
        t0 = time.perf_counter()
        raw = draw_raw(dims, seed, dev)
        self.sync()
        t1 = time.perf_counter()
        self.prog = Program(raw, dims, self.sp, cell.cfg, self.filters, dev)
        del raw
        self.sync()
        t2 = time.perf_counter()
        self.traffic = Traffic(cell.mix, seed, self.sp, dims.window_frames, dims.n_text_ctx)
        self.pool = {k: draw_pcm(seed, k, secs, dev) for k, secs in self.traffic.recordings()}
        log(f"set-up parts: raw weights drawn {t1 - t0:.2f} s, the program built (its kernels "
            f"loaded) {t2 - t1:.2f} s, audio {time.perf_counter() - t2:.2f} s")
        self.spans = devtrace.Spans(False, self.sync)
        self.item_mel: dict[int, torch.Tensor] = {}

    def sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize(self.dev)

    def one_round(self, count: bool) -> list:
        """One round of every lane's next window; ``count``: a round of the
        measured window, whose windows and work are recorded."""
        run, traffic, prog, spans = self.run, self.traffic, self.prog, self.spans
        frames = self.dims.window_frames
        t_in = time.perf_counter()
        wins = traffic.round()
        for w in wins:
            if w.item not in self.item_mel:
                for old in [k for k in self.item_mel if k not in {x.item for x in wins}]:
                    del self.item_mel[old]
                rec, secs = traffic.recording(w.item)
                with spans("mel"):
                    m = prog.mel(self.pool[rec])
                if count:
                    run.mel_audio_s += secs
                self.item_mel[w.item] = torch.nn.functional.pad(m, (0, frames))
        mel = torch.stack([self.item_mel[w.item][:, w.seek: w.seek + frames] for w in wins])
        with spans("encode"):
            cross = prog.encode(mel)
        prompt = np.zeros((len(wins), prog.prompt_capacity), np.int32)
        for i, w in enumerate(wins):
            prompt[i, : len(w.prompt)] = w.prompt
        plen = np.array([len(w.prompt) for w in wins], np.int32)
        with spans("decode"):
            res = prog.decode(prompt, plen, cross, np.array([w.seek for w in wins], np.int32),
                              np.array([w.seek_end for w in wins], np.int32), traffic.steps)
        lat = (time.perf_counter() - t_in) * 1e3
        del cross
        with torch.profiler.record_function(devtrace.SPAN + "host"):
            for i, w in enumerate(wins):
                rl = int(res["result_len"][i])
                traffic.done(w, res["tokens"][i], rl)
                if count:
                    run.records.append(dict(lane=w.lane, item=w.item, seek=w.seek, audio_s=w.audio_s,
                                            prompt=w.prompt, tokens=res["tokens"][i].copy(), p=res["p"][i].copy(),
                                            result_len=rl, seek_delta=int(res["seek_delta"][i]),
                                            failed=bool(res["failed"][i])))
                    run.latency_ms.append(lat)
                    run.audio_s += w.audio_s
                    run.flops += run.work.window_flops(len(w.prompt), traffic.steps)
        if count:
            run.flops += run.work.encode_flops(len(wins))
        return wins

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
        """Rounds under the profiler: at least one, then until TRACE_SECONDS."""
        from torch.profiler import ProfilerActivity, profile

        run, dims, steps = self.run, self.dims, self.traffic.steps
        tr = run.traced
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            with torch.profiler.record_function(devtrace.SPAN + "traced"):
                while True:
                    wins = self.one_round(count=False)
                    tr["rounds"] += 1
                    tr["k1_bound_s"] += run.work.k1_bound_s(len(wins))
                    tr["k1_kernels"] += dims.enc_layers
                    tr["k2_bound_s"] += run.work.k2_bound_s([len(w.prompt) for w in wins], steps)
                    tr["k2_calls"] += steps * dims.dec_layers * 2     # self and cross
                    if time.perf_counter() - t1 >= TRACE_SECONDS:
                        break
                self.sync()
        t2 = time.perf_counter()
        run.trace = devtrace.read_trace(prof, {"k1": "flash_attention_kernel", "k2": "decode_attention",
                                               "k2_split": "decode_attention_kernel",
                                               "k2_combine": "decode_attention_combine"})
        found = run.trace.get("found", {})
        n = {k: found.get(k, [0, 0])[1] for k in ("k1", "k2", "k2_split", "k2_combine")}
        log(f"trace: {tr['rounds']} rounds, {run.trace.get('kernels', 0)} device ops (K1 {n['k1']} "
            f"of {tr['k1_kernels']}; K2 {n['k2']}: {n['k2_split']} split and {n['k2_combine']} "
            f"combine of {tr['k2_calls']} calls each), read in {time.perf_counter() - t2:.1f} s")

    def free_program(self) -> None:
        del self.prog
        self.item_mel.clear()
        if self.cuda:
            torch.cuda.empty_cache()

    def judge(self, controls: tuple = ()) -> dict:
        """The check of a sample of the window's windows (after ``free_program``)."""
        run, cfg = self.run, self.cell.cfg
        picked = check.sample(run.records, run.lanes, self.seed)
        prec = ref.Precision(weights_int8=cfg["dtype_policy"] == "serving", kv_int8=cfg["kv_int8"])
        t3 = time.perf_counter()
        raw = draw_raw(self.dims, self.seed, self.dev)
        verdict = check.judge(run.records, picked, raw, self.dims, self.sp, prec,
                              lambda item: self.pool[self.traffic.recording(item)[0]],
                              torch.from_numpy(self.filters), self.traffic.steps, self.dev,
                              controls=tuple(dataclasses.replace(prec, lower=c) for c in controls))
        log(f"check: {verdict['windows']} windows, {verdict['tokens']} served tokens against the "
            f"reference in {time.perf_counter() - t3:.1f} s; widest gap {verdict['gap']!r}, widest "
            f"log-probability error {verdict['logp_err']!r}, mean {verdict['logp_mean_err']!r}; rules mismatches {verdict['rules_mismatch']}, "
            f"banned tokens {verdict['banned']}, windows compared only in part {verdict['truncated']}")
        return verdict


def windows_failed(records: list, dims: Dims) -> int:
    """Windows whose result is out of range (the window rule's own ``failed``
    flag is a transcription outcome, not a failure)."""
    n_max = dims.n_text_ctx // 2 - 4
    return sum(1 for r in records if not (0 <= r["result_len"] <= n_max and r["seek_delta"] >= 0))


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
    if trace and sess.cuda:
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

    failed = windows_failed(run.records, sess.dims)
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

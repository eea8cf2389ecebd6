"""The port's observability and device modules, on the CPU: tracing and
its compare, the NaN sanitizer, the profiler's report and device trace,
the logger and the device list. Mirrors tests/test_obs_tools.py; the
trace format is held against the JAX package's."""

import logging
import time

import numpy as np
import pytest
import torch


def test_trace_write_and_compare(tmp_path):
    from whisper_tpu_torch.obs.trace import TraceWriter, compare_traces, print_compare

    a = TraceWriter(str(tmp_path / "a"))
    b = TraceWriter(str(tmp_path / "b"))
    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    a.tensor("enc.q", x)
    a.tensor("enc.q", x + 1)  # repeated name -> slot #1
    a.tensor("dec.logits", torch.from_numpy(x * 2))
    b.tensor("enc.q", x)
    b.tensor("enc.q", x + 1.5)
    b.tensor("dec.logits", x * 2)

    diffs = compare_traces(str(tmp_path / "a"), str(tmp_path / "b"))
    by_name = {d.name: d for d in diffs}
    assert by_name["enc.q"].max_abs_diff == 0.0
    assert abs(by_name["enc.q#1"].max_abs_diff - 0.5) < 1e-6
    assert by_name["dec.logits"].max_abs_diff == 0.0
    assert "maxAbsDiff" in print_compare(diffs)


def test_trace_files_are_the_jax_packages(tmp_path):
    """Same names, same manifest, same .npy bytes as the JAX TraceWriter."""
    from whisper_tpu.obs.trace import TraceWriter as JWriter
    from whisper_tpu_torch.obs.trace import TraceWriter

    x = np.random.default_rng(0).standard_normal((2, 5)).astype(np.float32)
    for cls, name in ((JWriter, "jax"), (TraceWriter, "torch")):
        w = cls(str(tmp_path / name))
        for slot in ("a/b", "a/b", "c"):
            w.tensor(slot, x)
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == sorted(p.name for p in (tmp_path / "torch").iterdir())
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == (tmp_path / "torch" / f).read_bytes()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_traced_records_a_tensor_and_passes_it_through(tmp_path, dtype):
    from whisper_tpu_torch.obs.trace import TraceWriter, traced

    tracer = TraceWriter(str(tmp_path / "t"))
    x = torch.ones(4, dtype=dtype, requires_grad=dtype == torch.float32) * 2
    assert traced(tracer, "mid", x) is x
    assert traced(None, "off", x) is x
    got = np.load(tmp_path / "t" / "mid.npy")
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, 2 * np.ones((4,)))
    assert not (tmp_path / "t" / "off.npy").exists()


def test_check_pytree_finite():
    from whisper_tpu_torch.obs.nandebug import check_pytree_finite

    ok = {"a": np.ones(3), "b": {"c": np.zeros(2)}, "t": torch.ones(2), "i": torch.arange(3)}
    check_pytree_finite(ok)
    bad = {"a": np.array([1.0, np.nan])}
    with pytest.raises(FloatingPointError, match=r"\['a'\]"):
        check_pytree_finite(bad)
    with pytest.raises(FloatingPointError, match=r"\['x'\]\[1\]"):
        check_pytree_finite({"x": [torch.ones(1), torch.tensor([float("inf")])]})


def test_check_pytree_finite_over_the_ports_params():
    from tests.helpers import TINY_TEST_DIMS
    from whisper_tpu_torch.obs.nandebug import check_pytree_finite
    from whisper_tpu_torch.tools.synthetic import make_synthetic_params

    params = make_synthetic_params(TINY_TEST_DIMS, torch.float32, weights_int8=True, device="cpu")
    check_pytree_finite(params, "params")
    params.dec.blocks[1].xq_b[3] = float("nan")
    with pytest.raises(FloatingPointError, match=r"params: .*\.dec\.blocks\.1\.xq_b"):
        check_pytree_finite(params, "params")


def test_nan_debug_names_the_op_that_made_a_nan():
    from whisper_tpu_torch.obs.nandebug import nan_debug

    x = torch.tensor([1.0, -1.0])
    with nan_debug():
        y = torch.exp(x) + 1          # finite: no error
        with pytest.raises(FloatingPointError, match="log"):
            torch.log(x)
        with torch.inference_mode():
            with pytest.raises(FloatingPointError, match="div"):
                torch.zeros(2) / torch.zeros(2)
        torch.tensor([float("inf")]) * 2   # Inf is not NaN, as with jax_debug_nans
    assert torch.isnan(torch.log(x)).any()   # off again after the scope
    assert bool(torch.isfinite(y).all())


def test_nan_debug_over_the_encoder_is_silent_on_finite_inputs():
    from tests.helpers import TINY_TEST_DIMS
    from whisper_tpu_torch.model.encoder import encode
    from whisper_tpu_torch.obs.nandebug import nan_debug
    from whisper_tpu_torch.tools.synthetic import make_synthetic_params

    params = make_synthetic_params(TINY_TEST_DIMS, torch.float32, device="cpu")
    mel = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1, 80, 2 * TINY_TEST_DIMS.n_audio_ctx)).astype(np.float32))
    with nan_debug():
        out = encode(params, TINY_TEST_DIMS, mel, compute_dtype=torch.float32)
    assert bool(torch.isfinite(out).all())


def test_profiler_report():
    from whisper_tpu_torch.obs.profiler import Profiler

    p = Profiler()
    with p.cpu("encode"):
        time.sleep(0.01)
    with p.cpu("encode"):
        pass
    with p.cpu("decode"):
        pass
    p.count("graph_captures")
    p.count("capture_ms", 12.5)
    r = p.report()
    assert "host phases" in r and "encode" in r and "2 calls" in r and "decode" in r
    assert "graph_captures 1" in r and "capture_ms 12.5" in r
    assert p.get("encode") >= 0.01 and p.get("decode") < p.get("encode") and p.get("run") == 0.0
    p.reset()
    assert p.report() == "" and p.get("encode") == 0.0 and p.counters == {}


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import json

    from whisper_tpu_torch.obs.profiler import device_trace

    with device_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())


# ---- the tracer: spans and counters ------------------------------------------


@pytest.fixture
def tracer():
    """The process-wide tracer, emptied and on for the test, then emptied
    and put back as it was."""
    from whisper_tpu_torch.obs.profiler import TRACER

    was = TRACER._on
    TRACER.reset()
    TRACER.enable()
    try:
        yield TRACER
    finally:
        TRACER._on = was
        TRACER.reset()


def _spy(monkeypatch):
    """Counts record_function ranges by name and CUDA events made."""
    made = {"ranges": [], "events": 0}
    real_rf = torch.profiler.record_function

    def record_function(name, *a, **kw):
        made["ranges"].append(name)
        return real_rf(name, *a, **kw)

    def event(*a, **kw):
        made["events"] += 1
        raise AssertionError("a span made a CUDA event")

    monkeypatch.setattr(torch.profiler, "record_function", record_function)
    monkeypatch.setattr(torch.cuda, "Event", event)
    return made


def _tiny_runtime():
    from tests.helpers import TINY_TEST_DIMS
    from whisper_tpu_torch.runtime.context import WhisperRuntime
    from whisper_tpu_torch.runtime.sampler import SpecialIds
    from whisper_tpu_torch.tools.synthetic import make_synthetic_params

    dims = TINY_TEST_DIMS
    ids = SpecialIds(eot=50_256, sot=50_257, prev=50_360, solm=50_361, not_=50_362, beg=50_363)
    params = make_synthetic_params(dims, torch.float32, device="cpu")
    rt = WhisperRuntime(params, dims, ids, compute_dtype=torch.float32, device="cpu")
    mel = np.random.default_rng(0).standard_normal((1, 80, 2 * dims.n_audio_ctx)).astype(np.float32)
    prompt = np.zeros((1, rt.prompt_capacity), np.int32)
    prompt[:, 0] = ids.sot
    return rt, mel, prompt


def _window(rt, mel, prompt, force_steps=3):
    _, cross = rt.encode_window(mel)
    return cross, rt.run_window(prompt, np.ones(1, np.int32), cross, np.zeros(1, np.int32),
                                np.full(1, 10**7, np.int32), force_steps=force_steps)


def test_spans_are_off_by_default_and_cost_nothing(monkeypatch):
    """A new tracer is off: a span hands back one shared object, makes no
    record_function range and no CUDA event, and records nothing; so does
    the process-wide tracer's, and a whole window records nothing."""
    from whisper_tpu_torch.obs.profiler import TRACER, Profiler

    made = _spy(monkeypatch)
    p = Profiler()
    with p.span("a", device=torch.device("cpu")) as a:
        a.units = 7
        with p.span("b", units=3) as b:
            pass
    assert a is b and made == {"ranges": [], "events": 0}
    assert not p.spans() and p.stats("a") is None and p.report() == ""

    assert not TRACER._on
    TRACER.reset()
    rt, mel, prompt = _tiny_runtime()
    _window(rt, mel, prompt)
    assert not TRACER.spans() and made == {"ranges": [], "events": 0}


def test_spans_are_on_under_torch_profiler_and_off_after(monkeypatch):
    """A torch.profiler session turns spans on without enable(), and gives
    them no wtt: range (only device_trace does); they stop with it."""
    from torch.profiler import ProfilerActivity, profile

    from whisper_tpu_torch.obs.profiler import Profiler

    p = Profiler()
    made = _spy(monkeypatch)
    with profile(activities=[ProfilerActivity.CPU]):
        with p.span("traced", units=2):
            torch.ones(8).sum()
    with p.span("traced"):
        pass
    st = p.stats("traced")
    assert st.calls == 1 and st.units == 2 and st.host_ms > 0 and st.device_ms == st.host_ms
    assert not [n for n in made["ranges"] if n.startswith("wtt:")]


def test_nested_spans_record_parent_and_self_time():
    from whisper_tpu_torch.obs.profiler import Profiler

    p = Profiler()
    p.enable()
    for _ in range(2):
        with p.span("outer"):
            time.sleep(0.02)
            with p.span("inner", units=3):
                time.sleep(0.01)
    spans = p.spans()
    assert list(spans) == [("outer", "inner"), (None, "outer")]
    outer, inner = spans[(None, "outer")], spans[("outer", "inner")]
    assert outer.calls == 2 and inner.calls == 2 and inner.units == 6 and outer.units == 2
    assert inner.device_ms >= 20 and outer.device_ms >= inner.device_ms + 40
    assert p.self_ms("outer") == pytest.approx(outer.device_ms - inner.device_ms)
    assert p.self_ms("inner") == pytest.approx(inner.device_ms)
    r = p.report()
    assert "outer/inner" in r and "2 calls" in r
    p.disable()
    with p.span("outer"):
        pass
    assert p.stats("outer").calls == 2


def test_window_records_decode_ingest_steps_and_encode_cross_kv(tracer):
    """A TINY_TEST_DIMS window of 3 forced steps under enable(): encode
    holds cross_kv, decode holds ingest and steps, whose units are the 3
    steps."""
    rt, mel, prompt = _tiny_runtime()
    _, res = _window(rt, mel, prompt)
    assert int(res.steps) == 3
    spans = tracer.spans()
    assert set(spans) == {(None, "encode"), ("encode", "cross_kv"), (None, "decode"),
                          ("decode", "ingest"), ("decode", "steps")}
    assert all(s.calls == 1 for s in spans.values())
    assert spans[("decode", "steps")].units == 3 and spans[("decode", "ingest")].units == 1
    assert tracer.self_ms("decode") >= 0 and tracer.self_ms("encode") >= 0
    assert spans[("encode", "cross_kv")].device_ms <= spans[(None, "encode")].device_ms


def test_steps_units_count_the_steps_launched(tracer):
    """run_steps reading the flag after every step: stopped by the second
    step, two launched; under force_steps, the limit."""
    from whisper_tpu_torch.runtime.decode import run_steps

    stop = torch.zeros((), dtype=torch.bool)

    def step(i):
        stop.fill_(i == 1)

    assert run_steps(step, stop, 10, 0) == 2
    assert run_steps(step, stop, 5, 5) == 5
    st = tracer.stats("steps")
    assert st.calls == 2 and st.units == 7


def test_beam_window_records_ingest_and_steps(tracer):
    from whisper_tpu_torch.api.params import FullParams, SamplingStrategy
    from whisper_tpu_torch.runtime.beam import decode_window_beam

    rt, mel, prompt = _tiny_runtime()
    _, cross = rt.encode_window(mel)
    tracer.reset()
    res = decode_window_beam(rt, FullParams(strategy=SamplingStrategy.BEAM_SEARCH, beam_width=2),
                             prompt, np.ones(1, np.int32), cross, np.zeros(1, np.int32),
                             np.full(1, 10**7, np.int32), force_steps=3)
    assert int(res.steps) == 3
    spans = tracer.spans()
    assert set(spans) == {(None, "decode"), ("decode", "ingest"), ("decode", "steps")}
    assert spans[("decode", "steps")].units == 3 and spans[("decode", "ingest")].calls == 1


def test_device_trace_holds_the_programs_spans(tmp_path):
    """Inside device_trace the spans are on (the profiler records) and each
    is a wtt: range on the trace's timeline."""
    import json

    from whisper_tpu_torch.obs.profiler import TRACER, device_trace

    rt, mel, prompt = _tiny_runtime()
    TRACER.reset()
    try:
        with device_trace(str(tmp_path / "prof")):
            _window(rt, mel, prompt)
        assert TRACER.stats("ingest").calls == 1
    finally:
        TRACER.reset()
    names = {ev.get("name", "") for ev in json.loads((tmp_path / "prof" / "trace.json").read_text())["traceEvents"]}
    assert {"wtt:encode", "wtt:cross_kv", "wtt:decode", "wtt:ingest", "wtt:steps"} <= names


def test_cli_timings_prints_the_spans(tmp_path, capsys, tracer):
    """--timings turns the tracer on and the report gives encode, cross_kv,
    ingest and steps with ms per step."""
    import wave

    from tests.helpers import make_scripted_checkpoint
    from whisper_tpu_torch.cli.main import main

    tracer.disable()
    ckpt, wav = str(tmp_path / "s.bin"), str(tmp_path / "t.wav")
    make_scripted_checkpoint(ckpt, [50_363, 32, 104, 105, 50_363 + 96, 50_256])
    pcm = (0.2 * np.sin(np.arange(40_000) / 16_000 * 2 * np.pi * 220) * 32767).astype(np.int16)
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16_000)
        w.writeframes(pcm.tobytes())
    assert main(["-m", ckpt, "-f", wav, "--device", "cpu", "--timings"]) == 0
    out = capsys.readouterr().out
    assert tracer._on
    for name in ("encode/cross_kv", "decode/ingest", "decode/steps", "ms per step", "host phases"):
        assert name in out, out


def test_spans_from_many_threads_lose_no_update():
    """Threads (more than cores) opening nested spans on one tracer at a
    short switch interval: every call counted, every parent its thread's."""
    import os
    import sys
    import threading

    from whisper_tpu_torch.obs.profiler import Profiler

    p = Profiler()
    p.enable()
    n_threads, n = 2 * (os.cpu_count() or 2) + 2, 200

    def work(k):
        for _ in range(n):
            with p.span(f"t{k}"):
                with p.span("leaf", units=2):
                    p.count("c")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    spans = p.spans()
    assert p.stats("leaf").calls == n_threads * n and p.stats("leaf").units == 2 * n_threads * n
    assert all(spans[(f"t{k}", "leaf")].calls == n and spans[(None, f"t{k}")].calls == n
               for k in range(n_threads))
    assert p.counters["c"] == n_threads * n


# ---- on the card -------------------------------------------------------------


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: CUDA graphs and events have no CPU mode")


@pytest.mark.cuda
def test_span_opened_while_capturing_records_nothing():
    """No span inside a capture; outside it, the span's device time comes
    from its event pair."""
    _need_card()
    from whisper_tpu_torch.obs.profiler import Profiler

    p = Profiler()
    p.enable()
    x = torch.zeros(1 << 20, device="cuda")
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        with p.span("captured", device=x.device):
            x.add_(1)
    assert not p.spans()
    with p.span("replay", units=4, device=x.device):
        for _ in range(4):
            g.replay()
    st = p.stats("replay")
    assert float(x[0]) == 4.0 and st.calls == 1 and st.units == 4 and st.device_ms > 0
    assert p.stats("captured") is None


@pytest.mark.cuda
def test_capture_adds_to_graph_captures_and_capture_ms():
    _need_card()
    from typing import NamedTuple

    from whisper_tpu_torch.obs.profiler import TRACER
    from whisper_tpu_torch.runtime.graph import Slot

    class KV(NamedTuple):
        k: torch.Tensor

    x = torch.zeros(16, device="cuda")
    slot = Slot((x,), KV(torch.zeros(4, device="cuda")), ())
    before = dict(TRACER.counters)
    a = slot.step(("a",), lambda: x.add_(1))
    assert slot.step(("a",), lambda: x.add_(1)) is a
    slot.step(("b",), lambda: x.add_(2))
    assert TRACER.counters["graph_captures"] == before.get("graph_captures", 0) + 2
    added = TRACER.counters["capture_ms"] - before.get("capture_ms", 0.0)
    assert added >= a.capture_ms > 0


def test_setup_logger_sink_and_levels():
    from whisper_tpu_torch.obs.logging import LogFlags, LogLevel, logger, setup_logger

    got = []
    setup_logger(LogLevel.WARNING, sink=lambda lvl, msg: got.append((lvl, msg)), flags=LogFlags.NONE)
    try:
        logger.info("hidden")
        logger.warning("shown")
        logger.error("bad")
        assert got == [(int(LogLevel.WARNING), "shown"), (int(LogLevel.ERROR), "bad")]
        assert logger.name == "whisper_tpu_torch" and logger.level == logging.WARNING
    finally:
        setup_logger(LogLevel.INFO, sink=None, flags=LogFlags.NONE)


def test_list_devices_lists_the_cpu_last():
    from whisper_tpu_torch.api.devices import DeviceInfo, list_devices

    devs = list_devices()
    assert all(isinstance(d, DeviceInfo) for d in devs)
    assert devs[-1].platform == "cpu" and devs[-1].memory_gb > 0
    gpus = [d for d in devs if d.platform == "gpu"]
    assert len(gpus) == (torch.cuda.device_count() if torch.cuda.is_available() else 0)
    assert [d.id for d in gpus] == list(range(len(gpus)))

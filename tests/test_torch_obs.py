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
    p.note_memory("weights", 123.4)
    p.add("decode", 0.5, calls=4)
    r = p.report()
    assert "encode" in r and "2 calls" in r and "123.4" in r and "4 calls" in r
    assert p.get("encode") >= 0.01 and p.get("decode") == 0.5
    p.reset()
    assert "memory" not in p.report() and p.get("encode") == 0.0


def test_device_trace_writes_a_chrome_trace(tmp_path):
    import json

    from whisper_tpu_torch.obs.profiler import device_trace

    with device_trace(str(tmp_path / "prof")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert any("mm" in ev.get("name", "") for ev in trace["traceEvents"])
    assert any("mm" in e.key for e in prof.key_averages())


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

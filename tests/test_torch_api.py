"""The port's Model / Context / CLI against the JAX package's, end to end
on the CPU: mel -> encode -> window decode -> segment assembly -> writers.

Segments (text, t0, t1, token ids) must be identical in f32, on a random
checkpoint and on the scripted one whose greedy decode always emits a known
script. In bf16 only the scripted checkpoint is held to identical tokens:
on random weights bf16 rounds differently in XLA and PyTorch and an argmax
may flip.
"""

import wave

import numpy as np
import pytest
import torch

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint

BEG, EOT = 50_363, 50_256  # english-vocab specials
SCRIPT = [BEG, 32, 104, 105, BEG + 96, EOT]  # <|0.00|> " hi" <|1.92|> <|eot|>


def _segments(result):
    return [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in result.segments]


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("api")
    scripted = str(root / "scripted.bin")
    make_scripted_checkpoint(scripted, SCRIPT)
    rand = str(root / "random.bin")
    make_random_checkpoint(rand, TINY_TEST_DIMS, seed=5)
    wav = str(root / "tone.wav")
    sr = 16_000
    t = np.arange(int(2.5 * sr)) / sr
    pcm = (0.2 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16)
    with wave.open(wav, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
    return scripted, rand, wav, root


def _run_both(path, audio, params_kw, jax_policy, torch_policy):
    from whisper_tpu.api.model import Model as JModel
    from whisper_tpu.api.params import FullParams as JParams
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import FullParams

    want = JModel(path, policy=jax_policy).create_context().run_full(JParams(**params_kw), audio)
    got = Model(path, policy=torch_policy, device="cpu").create_context().run_full(
        FullParams(**params_kw), audio)
    return _segments(got), _segments(want)


@pytest.mark.parametrize("which", ["random", "scripted"])
def test_run_full_segments_match_jax_f32(files, which):
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu_torch.model.params import DtypePolicy

    scripted, rand, _, _ = files
    rng = np.random.default_rng(0)
    if which == "random":
        audio = (0.1 * rng.standard_normal(16_000 * 4)).astype(np.float32)
        path = rand
    else:
        audio = np.zeros(16_000 * 2, np.float32)
        path = scripted
    got, want = _run_both(path, audio, dict(language="en"), JPolicy.f32(), DtypePolicy.f32())
    assert got == want
    if which == "scripted":
        assert got == [(" hi", 0, 192, SCRIPT[:5])]


def test_scripted_tokens_identical_in_bf16(files):
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu_torch.model.params import DtypePolicy

    scripted, _, _, _ = files
    audio = np.zeros(16_000 * 2, np.float32)
    got, want = _run_both(scripted, audio, dict(language="en"), JPolicy(), DtypePolicy())
    assert got == want == [(" hi", 0, 192, SCRIPT[:5])]


def test_cli_golden_transcript(files, capsys):
    from whisper_tpu_torch.cli.main import main

    scripted, _, wav, _ = files
    assert main(["-m", scripted, "-f", wav, "-otxt", "-osrt", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[00:00:00.000 --> 00:00:01.920]  hi" in out
    stem = wav.rsplit(".", 1)[0]
    assert open(stem + ".txt").read().strip() == "hi"
    srt = open(stem + ".srt").read()
    assert "00:00:00,000 --> 00:00:01,920" in srt and "hi" in srt


def test_cli_golden_speedup_doubles_times(files, capsys):
    from whisper_tpu_torch.cli.main import main

    scripted, _, wav, _ = files
    assert main(["-m", scripted, "-f", wav, "-su", "--device", "cpu"]) == 0
    assert "[00:00:00.000 --> 00:00:03.840]  hi" in capsys.readouterr().out


def _capture_audio():
    """1 s of noise floor, 4 s of speech, a 1 s pause, 2 s of speech, in
    100 ms chunks (the VAD's adaptive thresholds need silence first)."""
    from chip_smoke import chunks_of, noise_floor, speechy

    sr = 16_000
    return chunks_of(np.concatenate([noise_floor(sr), speechy(sr * 4, 0), noise_floor(sr),
                                     speechy(sr * 2, 2)]))


@pytest.mark.parametrize("policy", ["f32", "bf16"])
def test_run_capture_matches_jax(files, policy):
    """Context.run_capture over a paced source on the scripted checkpoint,
    max_duration 2 s (each buffer within the 1.92 s window and the 2.5 s the
    script holds for) and no prompt carried from buffer to buffer (a carried
    prompt shifts the script's positions): the buffers handed to run_full
    and the accumulated segments equal the JAX package's, one " hi" for
    each of the two 2 s buffers."""
    from chip_smoke import recorded_capture
    from whisper_tpu.api.model import Model as JModel
    from whisper_tpu.api.params import Flags as JFlags
    from whisper_tpu.api.params import FullParams as JParams
    from whisper_tpu.audio.capture import CaptureParams as JCaptureParams
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import Flags, FullParams
    from whisper_tpu_torch.audio.capture import CaptureParams
    from whisper_tpu_torch.model.params import DtypePolicy

    scripted, _, _, _ = files
    chunks = _capture_audio()
    out = {}
    for name, ctx, params, cap in (
        ("jax", JModel(scripted, policy=getattr(JPolicy, policy, JPolicy)()).create_context(),
         JParams(language="en", flags=JFlags.NO_CONTEXT), JCaptureParams(min_duration=1.0, max_duration=2.0)),
        ("torch", Model(scripted, policy=getattr(DtypePolicy, policy, DtypePolicy)(),
                        device="cpu").create_context(),
         FullParams(language="en", flags=Flags.NO_CONTEXT),
         CaptureParams(min_duration=1.0, max_duration=2.0)),
    ):
        buffers, _, res = recorded_capture(ctx, params, chunks, cap)
        out[name] = (buffers, _segments(res))
    assert out["torch"] == out["jax"]
    buffers, segments = out["torch"]
    assert buffers and max(buffers) <= 2.5 * 16_000
    assert buffers[:2] == [32_000, 32_000]
    assert segments == [(" hi", 0, 192, SCRIPT[:5])] * 2


def test_model_on_cpu_keeps_tensors_on_cpu(files):
    from whisper_tpu_torch.api.model import Model

    scripted, _, _, _ = files
    m = Model(scripted, device="cpu")
    assert m.device == torch.device("cpu") and m.runtime.device == torch.device("cpu")
    assert all(t.device.type == "cpu" for t in m.runtime.params.buffers())

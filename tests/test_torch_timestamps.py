"""Token-level timestamps, segment wrapping and diarization of the port
against the JAX package's, on the CPU: the host functions on identical
seeded inputs, then ``run_full`` and the CLI (``-bs``, ``-ml``, ``-owts``,
``-di``) end to end. Token times, speakers, segments and the ``.wts`` file
must be identical."""

import wave

import numpy as np
import pytest

from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint, make_vocab_words

TEXT = " hi there, tpu"
SCRIPT = [50_363, *TEXT.encode(), 50_363 + 96, 50_256]     # <|0.00|> TEXT <|1.92|> <|eot|>


def _vocabs():
    from whisper_tpu.vocab import Vocabulary as JVocab
    from whisper_tpu_torch.vocab import Vocabulary

    words = make_vocab_words(51_864)
    return JVocab(words, 51_864), Vocabulary(words, 51_864)


def _random_segments(mod, seed, n_seg=4):
    """Seeded segments of the JAX package's or the port's result types:
    a leading timestamp, text tokens, a closing timestamp."""
    if mod == "jax":
        from whisper_tpu.api.result import Segment, Token
    else:
        from whisper_tpu_torch.api.result import Segment, Token
    rng = np.random.default_rng(seed)
    beg = 50_363
    segs, t = [], 0
    for _ in range(n_seg):
        n = int(rng.integers(1, 9))
        ids = [beg + int(rng.integers(0, 20))] + [int(x) for x in rng.integers(0, 50_000, n)]
        ids += [beg + int(rng.integers(20, 200))]
        toks = [Token(id=i, text="", t0=-1, t1=-1, probability=float(rng.random()),
                      pt=float(rng.random()), ptsum=float(rng.random()),
                      tid=beg + int(rng.integers(0, 300)), vlen=0.0) for i in ids]
        t1 = t + int(rng.integers(50, 400))
        segs.append(Segment(text="x", t0=t, t1=t1, tokens=toks))
        t = t1
    return segs


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_token_level_timestamps_match_jax(seed):
    from whisper_tpu.api.timestamps import TimestampState as JState
    from whisper_tpu.api.timestamps import compute_token_level_timestamps as jcompute
    from whisper_tpu_torch.api.timestamps import TimestampState, compute_token_level_timestamps

    jv, tv = _vocabs()
    rng = np.random.default_rng(seed + 10)
    energy = np.abs(rng.standard_normal(16_000 * 30)).astype(np.float32)
    energy[rng.integers(0, len(energy), 2_000)] *= 20.0
    from whisper_tpu_torch.api.timestamps import compute_signal_energy
    from whisper_tpu.api.timestamps import compute_signal_energy as jenergy

    np.testing.assert_array_equal(compute_signal_energy(energy), jenergy(energy))
    jsegs, tsegs = _random_segments("jax", seed), _random_segments("torch", seed)
    jstate, tstate = JState(), TimestampState()
    for i in range(len(tsegs)):
        for thold in (0.01, 0.3):
            jcompute(jsegs, i, jv, thold, thold, energy=energy, state=jstate)
            compute_token_level_timestamps(tsegs, i, tv, thold, thold, energy=energy, state=tstate)
    got = [(t.t0, t.t1, t.vlen) for s in tsegs for t in s.tokens]
    want = [(t.t0, t.t1, t.vlen) for s in jsegs for t in s.tokens]
    assert got == want
    assert (tstate.t_beg, tstate.t_last, tstate.tid_last) == (jstate.t_beg, jstate.t_last, jstate.tid_last)
    assert any(t0 >= 0 for t0, _, _ in got)


@pytest.mark.parametrize("max_len", [1, 5, 12])
def test_wrap_segment_matches_jax(max_len):
    from whisper_tpu.api.timestamps import wrap_segment as jwrap
    from whisper_tpu_torch.api.timestamps import wrap_segment

    jv, tv = _vocabs()
    for seed in range(5):
        jsegs, tsegs = _random_segments("jax", seed), _random_segments("torch", seed)
        for k, (js, ts) in enumerate(zip(jsegs, tsegs)):   # token times the wrap cuts at
            for j, (a, b) in enumerate(zip(js.tokens, ts.tokens)):
                a.t0 = b.t0 = js.t0 + 7 * j + k
        n_j, n_t = jwrap(jsegs, max_len, jv), wrap_segment(tsegs, max_len, tv)
        assert n_t == n_j
        assert ([(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in tsegs]
                == [(s.text, s.t0, s.t1, [t.id for t in s.tokens]) for s in jsegs])


def test_detect_speaker_matches_jax():
    from whisper_tpu.api.diarize import detect_speaker as jdetect
    from whisper_tpu_torch.api.diarize import detect_speaker

    rng = np.random.default_rng(4)
    stereo = (rng.standard_normal((2, 16_000 * 5)) * np.array([[0.3], [0.1]])).astype(np.float32)
    stereo[:, 16_000 * 2 : 16_000 * 3] *= np.array([[0.1], [3.0]], np.float32)
    cases = [(0, 100), (200, 300), (150, 250), (300, 300), (400, 900), (-50, 20)]
    for t0, t1 in cases:
        assert int(detect_speaker(stereo, t0, t1)) == int(jdetect(stereo, t0, t1)), (t0, t1)
    assert int(detect_speaker(stereo[0], 0, 100)) == int(jdetect(stereo[0], 0, 100))
    assert {detect_speaker(stereo, *c).name for c in cases} >= {"LEFT", "RIGHT", "UNSURE"}


# ---------------------------------------------------------------------------
# run_full and the CLI
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("ts")
    scripted = str(root / "scripted.bin")
    make_scripted_checkpoint(scripted, SCRIPT)
    rand = str(root / "random.bin")
    make_random_checkpoint(rand, TINY_TEST_DIMS, seed=40)
    rng = np.random.default_rng(3)
    n = int(2.4 * 16_000)
    t = np.arange(n) / 16_000
    tone = (0.3 * np.sin(2 * np.pi * 220 * t) * (t > 0.5) * (t < 1.6)).astype(np.float32)
    stereo = np.stack([tone + 0.01 * rng.standard_normal(n), 0.1 * tone]).astype(np.float32)
    wavs = {}
    for name, pcm in (("mono", tone), ("stereo", stereo)):
        path = str(root / f"{name}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1 if pcm.ndim == 1 else 2)
            w.setsampwidth(2)
            w.setframerate(16_000)
            w.writeframes((np.clip(pcm.T, -1, 1) * 32767).astype(np.int16).tobytes())
        wavs[name] = path
    return scripted, rand, wavs, tone, stereo


def _run_full_both(path, audio, **kw):
    from whisper_tpu.api.model import Model as JModel
    from whisper_tpu.api.params import Flags as JFlags
    from whisper_tpu.api.params import FullParams as JParams
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.api.params import Flags, FullParams
    from whisper_tpu_torch.model.params import DtypePolicy

    flags = kw.pop("flags", "")
    jf, tf = JFlags.NONE, Flags.NONE
    for name in filter(None, flags.split("|")):
        jf, tf = jf | JFlags[name], tf | Flags[name]
    want = JModel(path, policy=JPolicy.f32()).create_context().run_full(JParams(flags=jf, **kw), audio)
    got = Model(path, policy=DtypePolicy.f32(), device="cpu").create_context().run_full(
        FullParams(flags=tf, **kw), audio)

    def segs(r):
        return [(s.text, s.t0, s.t1, int(s.speaker), [(t.id, t.t0, t.t1) for t in s.tokens])
                for s in r.segments]

    return segs(got), segs(want)


@pytest.mark.parametrize("which", ["random", "scripted"])
def test_run_full_stereo_diarization_matches_jax(files, which):
    """tests/test_run_full.py:60 for the port: a [2, N] clip louder on the
    left is downmixed for the model and diarized per segment."""
    from whisper_tpu_torch.api.result import Speaker

    scripted, rand, _, _, stereo = files
    if which == "random":
        rng = np.random.default_rng(1)
        stereo = np.stack([(0.2 * rng.standard_normal(16_000 * 6)),
                           (0.01 * rng.standard_normal(16_000 * 6))]).astype(np.float32)
    got, want = _run_full_both(scripted if which == "scripted" else rand, stereo)
    assert got == want
    for seg in got:
        assert seg[3] in (Speaker.LEFT, Speaker.RIGHT, Speaker.UNSURE)
    if which == "scripted":
        assert [s[3] for s in got] == [Speaker.LEFT]


@pytest.mark.parametrize("max_len,speedup", [(0, False), (2, False), (4, True)])
def test_token_timestamps_run_full_match_jax(files, max_len, speedup):
    """TOKEN_TIMESTAMPS (with max_len wrapping, and under SpeedupAudio,
    whose times are scaled for every wrapped piece): token times identical
    to JAX's on the scripted checkpoint."""
    scripted, _, _, tone, _ = files
    audio = np.concatenate([tone, tone]) if speedup else tone
    flags = "TOKEN_TIMESTAMPS" + ("|SPEEDUP_AUDIO" if speedup else "")
    got, want = _run_full_both(scripted, audio, flags=flags, max_len=max_len)
    assert got == want
    assert "".join(s[0] for s in got) == TEXT
    assert all(t0 >= 0 and t1 >= t0 for s in got for _, t0, t1 in s[4])
    if max_len:
        assert len(got) > 1 and all(len(s[0]) <= max_len for s in got)


def _cli(main, args, capsys):
    assert main(args) == 0
    return capsys.readouterr().out


@pytest.mark.parametrize(
    "flags",
    [["-bs", "5"], ["-ml", "8"], ["-owts"], ["-di"]],
    ids=["bs5", "ml8", "owts", "di"],
)
def test_cli_flags_match_jax_cli(files, capsys, flags):
    """The port's CLI against the JAX CLI on the same files: the same
    printed segments, and the same ``.wts`` script where asked for."""
    from whisper_tpu.cli.main import main as jmain
    from whisper_tpu_torch.cli.main import main

    scripted, _, wavs, _, _ = files
    wav = wavs["stereo" if "-di" in flags else "mono"]
    args = ["-m", scripted, "-f", wav, *flags]
    want = _cli(jmain, args, capsys)
    want_wts = open(wav + ".wts").read() if "-owts" in flags else None
    got = _cli(main, args + ["--device", "cpu"], capsys)
    assert got == want
    lines = [ln for ln in got.splitlines() if ln.startswith("[")]
    assert lines
    if "-di" in flags:
        assert all("(speaker LEFT)" in ln for ln in lines)
    if "-ml" in flags:
        assert len(lines) > 1
    if want_wts is not None:
        assert open(wav + ".wts").read() == want_wts
        assert "drawtext" in want_wts and "enable='between(t," in want_wts

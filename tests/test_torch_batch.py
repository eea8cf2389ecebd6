"""The port's batched scheduler against the JAX package's and against the
port's own sequential ``run_full``, on the CPU. Segments (text, t0, t1,
token ids, speaker, and token times under TOKEN_TIMESTAMPS) must be
identical.

Two f32 checkpoints: tests/test_batch.py's random one and clips, on which
every window fails and no segment comes out (the JAX tests' case), and the
scripted one (a position -> token lookup that emits " hi" from any audio,
tests/helpers.py) on clips of at most 2.5 s, one window each, on which
every clip gives segments."""

import numpy as np
import pytest


SCRIPT = [50_363, 32, 104, 105, 50_363 + 96, 50_256]   # <|0.00|> " hi" <|1.92|> <|eot|>


@pytest.fixture(scope="module", params=["random", "scripted"])
def models(request, tmp_path_factory):
    from tests.helpers import TINY_TEST_DIMS, make_random_checkpoint, make_scripted_checkpoint
    from whisper_tpu.api.model import Model as JModel
    from whisper_tpu.model.params import DtypePolicy as JPolicy
    from whisper_tpu_torch.api.model import Model
    from whisper_tpu_torch.model.params import DtypePolicy

    path = str(tmp_path_factory.mktemp("bt") / f"{request.param}.bin")
    if request.param == "random":
        make_random_checkpoint(path, TINY_TEST_DIMS, seed=40)
    else:
        make_scripted_checkpoint(path, SCRIPT)
    return (JModel(path, policy=JPolicy.f32()), Model(path, policy=DtypePolicy.f32(), device="cpu"),
            request.param)


def _scripted(models) -> bool:
    return models[2] == "scripted"


def _clips(n, seconds=6, seed=99, scripted=False, speedup=False):
    """n seeded noise clips: ``seconds`` long, or 1.2-2.5 s of decoded audio
    on the scripted checkpoint (one window each; twice as long under
    SpeedupAudio)."""
    rng = np.random.default_rng(seed)
    lengths = (rng.integers(19_200, 40_001, n) * (1 + speedup) if scripted
               else [16_000 * seconds] * n)
    return [(0.1 * rng.standard_normal(int(k))).astype(np.float32) for k in lengths]


def _segments(result, token_times=False):
    return [(s.text, s.t0, s.t1, [(t.id, t.t0, t.t1) if token_times else t.id for t in s.tokens],
             s.speaker) for s in result.segments]


def _params(mod, flags_name, beam=0):
    """FullParams of the JAX package or of the port, with the named flags."""
    if mod == "jax":
        from whisper_tpu.api import params as P
    else:
        from whisper_tpu_torch.api import params as P
    p = P.full_default_params()
    p.flags = P.Flags.NONE
    for name in flags_name.split("|") if flags_name else []:
        p.flags |= P.Flags[name]
    if beam:
        p.strategy, p.beam_width = P.SamplingStrategy.BEAM_SEARCH, beam
    return p


def _run(models, clips, batch, flags="", beam=0, token_times=False):
    """(port batched, JAX batched, port sequential) segments."""
    from whisper_tpu.runtime.batch import BatchTranscriber as JBatch
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    jmodel, tmodel, _ = models
    got = BatchTranscriber(tmodel, batch=batch).transcribe(clips, _params("torch", flags, beam))
    want = JBatch(jmodel, batch=batch).transcribe(clips, _params("jax", flags, beam))
    seq = [tmodel.create_context().run_full(_params("torch", flags, beam), c) for c in clips]
    if _scripted(models):
        assert all(r.segments for r in seq)
    return ([_segments(r, token_times) for r in got], [_segments(r, token_times) for r in want],
            [_segments(r, token_times) for r in seq])


@pytest.mark.parametrize(
    "case,batch,flags,beam",
    [
        ("equal_lengths", 3, "", 0),                    # tests/test_batch.py:26
        ("single_segment", 2, "SINGLE_SEGMENT", 0),     # :81
        ("beam", 2, "", 3),                             # :101
        ("speedup", 2, "SPEEDUP_AUDIO", 0),
    ],
)
def test_batch_matches_jax_and_sequential(models, case, batch, flags, beam):
    # random weights fail every window, and a failed beam window runs to the
    # step cap: 2 s clips keep the beam case to one window a clip
    seconds = {"equal_lengths": 6, "beam": 2}.get(case, 4)
    clips = _clips(3 if case in ("equal_lengths", "beam") else 2, seconds, scripted=_scripted(models),
                   speedup=case == "speedup")
    got, want, seq = _run(models, clips, batch, flags, beam)
    assert got == want
    assert got == seq
    if case == "single_segment":
        assert all(len(r) <= 1 for r in got)


def test_batch_mixed_lengths_and_refill(models):
    """Five clips of 2-9 s through two lanes: refill rounds (tests/test_batch.py:48)."""
    rng = np.random.default_rng(7)
    seconds = (1.3, 2.4, 1.8, 2.1, 1.5) if _scripted(models) else (4, 9, 2, 6, 5)
    clips = [(0.1 * rng.standard_normal(int(16_000 * s))).astype(np.float32) for s in seconds]
    got, want, seq = _run(models, clips, 2)
    assert got == want == seq


def test_batch_token_timestamps_match(models):
    """Per-lane signal energy: token times equal JAX's and run_full's
    (tests/test_batch.py:122)."""
    clips = _clips(2, seconds=4, scripted=_scripted(models))
    got, want, seq = _run(models, clips, 2, "TOKEN_TIMESTAMPS", token_times=True)
    assert got == want == seq
    if _scripted(models):
        assert all(t0 >= 0 for r in got for seg in r for _, t0, _ in seg[3])


def test_batch_stereo_lanes_diarize(models):
    """Stereo clips are downmixed per lane and keep their speaker, as run_full."""
    from whisper_tpu_torch.api.result import Speaker

    rng = np.random.default_rng(1)
    n = 16_000 * (2 if _scripted(models) else 4)
    clips = []
    for loud in (0, 1):
        ch = [(0.01 * rng.standard_normal(n)).astype(np.float32) for _ in range(2)]
        ch[loud] = (0.2 * rng.standard_normal(n)).astype(np.float32)
        clips.append(np.stack(ch))
    got, want, seq = _run(models, clips, 2)
    assert got == want == seq
    if _scripted(models):
        assert [r[0][4] for r in got] == [Speaker.LEFT, Speaker.RIGHT]


def test_batch_short_clip_empty(models):
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    clips = _clips(1, scripted=_scripted(models)) + [np.zeros(4_000, np.float32)]
    got = BatchTranscriber(models[1], batch=2).transcribe(clips)
    assert len(got) == 2 and len(got[1].segments) == 0


def test_batch_progress_callback_fires(models):
    from whisper_tpu_torch.runtime.batch import BatchTranscriber

    seen = []
    params = _params("torch", "")
    params.progress_callback = seen.append
    BatchTranscriber(models[1], batch=2).transcribe(_clips(2, 4, scripted=_scripted(models)), params)
    assert seen and seen[-1] == 1.0 and all(0.0 <= f <= 1.0 for f in seen)

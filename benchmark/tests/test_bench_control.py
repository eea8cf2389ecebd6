"""The control fails where the program passes, and faults in the timed path make ``correct`` false.

At test sizes, on the CPU: the control (the reference in the program's
place at the next precision down: int4 for the serving tier's int8 parts,
float8 e4m3 for its bf16 parts and for the bf16 tier) reads a
``logit_err`` above the limit on three seeds while the program reads one
below it. Then whole runs of a cell, with the look for a card skipped and
the timed path broken underneath: a token step that leaves its state
unchanged, half of the batch left out (its lanes get the mean of the
others' input), a token altered where the sampler makes it. Each must
come out not correct. (No cell spans chips, so no exchange
between chips can be left out.)
"""

from __future__ import annotations

import pytest
import torch

import tiny
import whisper_tpu_torch.runtime.decode as decode
from benchmark.harness import Cell, Session, run_cell
from whisper_tpu_torch.runtime.context import WhisperRuntime


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell, control", [("tiny.long", "int4"), ("tiny.long", "fp8"),
                                           ("tiny.clips", "fp8")])
@pytest.mark.parametrize("seed", [2**31 + 11, 3_000_000_019, 4_000_000_007])
def test_control_fails_where_the_program_passes(root, cell, control, seed):
    sess = Session(Cell(cell, root), seed, torch.device("cpu"))
    for _ in range(2):
        sess.one_round(count=False)
    sess.window(0.3, spans=False)
    sess.free_program()
    verdict = sess.judge(controls=(control,))
    assert verdict["rules_mismatch"] == 0 and verdict["tokens"] > 0
    assert verdict["logit_err"] <= tiny.LIMIT < verdict["control"][control]["logit_err"]


def _unchanged_state(monkeypatch):
    monkeypatch.setattr(decode, "greedy_step", lambda *a, **k: None)


def _half_batch(monkeypatch):
    encode = WhisperRuntime.encode_window

    def half(self, mel):
        mel = torch.as_tensor(mel).clone()
        h = mel.shape[0] // 2
        mel[h:] = mel[:h].mean(dim=0)
        return encode(self, mel)

    monkeypatch.setattr(WhisperRuntime, "encode_window", half)


def _altered_token(monkeypatch):
    sample = decode.sample_best

    def altered(probs, *a, **k):
        out = sample(probs, *a, **k)
        tok = out.id.clone()
        tok[-1] += 1 if int(tok[-1]) + 1 < probs.shape[-1] else -1    # the last lane's, in range
        return out._replace(id=tok)

    monkeypatch.setattr(decode, "sample_best", altered)


@pytest.mark.parametrize("fault", [None, _unchanged_state, _half_batch, _altered_token],
                         ids=["sound", "state_unchanged", "half_batch", "token_altered"])
@pytest.mark.parametrize("cell", ["tiny.long", "tiny.clips"])
def test_faults_make_correct_false(root, monkeypatch, cell, fault):
    if fault is not None:
        fault(monkeypatch)
    res = run_cell(cell, 2**31 + 101, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["correct"] is (fault is None), res["check"]

"""A configuration's ``model_type`` finds its family by name, and the Whisper family reads as before.

A family of another kind, added as new files (its module, configuration,
mix, limits, reader and cell), runs to a result line on the CPU and is
judged correct; the same family with a token altered where its program
makes it is judged not correct. A configuration whose family has no file
stops before any weight is drawn, naming the file. And the Whisper family,
driven through the harness, gives what the harness gave on commit
7d7c2cbaf5ae095345293f195ff4558c8fa0f939 (before it reached Whisper
through ``benchmark/families/whisper.py``), recorded there at the tiny
cells on the CPU with one thread and seed 2**31 + 29: the raw weights, the
prompts of the first three rounds, those rounds' K1 and K2 bounds and model
operations as ``counts.Work`` gives them, and the check's numbers over
their windows, the controls' with them.
"""

from __future__ import annotations

import hashlib
import json

import pytest
import torch

import tiny
from benchmark.harness import Cell, Session, run_cell

SEED = 2**31 + 29
CPU = torch.device("cpu")
H_LONG, H_CLIPS = [50258, 50259, 50359], [50258, 50259, 50360]     # [sot, en, transcribe]
TEXT = [50418] + [51218] * 11                                        # a lane's first window of text
PARENT = {
    "tiny.long": {
        "weights": "e419e4d9f32b1a83b4f456a10cc37d47",
        "rounds": [  # prompts; then per round K1's and K2's bounds, encode_flops and each window's window_flops
            ([H_LONG] * 3, 8.80334328358209e-08, 6.497623880597016e-07, 114425856, [94782080] * 3),
            ([[50361, *TEXT, *H_LONG]] * 2 + [H_LONG], 8.80334328358209e-08, 7.004274626865673e-07, 114425856,
             [102316672, 102316672, 94782080]),
            ([H_LONG, [50361, *TEXT, 50381, *TEXT[1:], *H_LONG], [50361, *TEXT, *H_LONG]], 8.80334328358209e-08,
             7.238113432835822e-07, 114425856, [94782080, 109425280, 102316672]),
        ],
        "served": "f7d102e498a05956", "audio_s": 17.28, "controls": ("int4", "fp8"),
        "check": {"logit_err": 0.0030088424682617188, "logp_mean_err": 0.0009914239247639973, "gap": 0.0,
                  "logp_err": 0.0030088424682617188, "windows": 9, "tokens": 108, "rules_mismatch": 0,
                  "banned": 0, "truncated": 0, "control": {
                      "int4": {"logit_err": 0.11295318603515625, "gap": 0.008781284093856812,
                               "logp_err": 0.11295318603515625, "logp_mean_err": 0.06983999852780942},
                      "fp8": {"logit_err": 0.02626514434814453, "gap": 0.0, "logp_err": 0.02626514434814453,
                              "logp_mean_err": 0.0070211975662796584}}},
    },
    "tiny.clips": {
        "weights": "4018b567cd0480f066129f082ebbb73c",
        "rounds": [([H_CLIPS] * 3, 8.80334328358209e-08, 5.969767164179105e-07, 115605504, [90544384] * 3)] * 3,
        "served": "7c4c60153ba97c78", "audio_s": 9.0, "controls": ("fp8",),
        "check": {"logit_err": 0.0032711029052734375, "logp_mean_err": 0.0006709098815917969,
                  "gap": 0.0022279024124145508, "logp_err": 0.0032711029052734375, "windows": 9, "tokens": 108,
                  "rules_mismatch": 0, "banned": 0, "truncated": 0, "control": {
                      "fp8": {"logit_err": 0.041953086853027344, "gap": 0.03031092882156372,
                              "logp_err": 0.041953086853027344, "logp_mean_err": 0.011938307020399306}}},
    },
}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("bench"))


def _digest(raw: dict) -> str:
    """Of every tensor: its name, dtype, shape and bytes."""
    def each(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from each(v, f"{prefix}{k}.")
            else:
                b = v.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes()
                yield prefix + k, f"{v.dtype} {tuple(v.shape)} " + hashlib.sha256(b).hexdigest()[:16]
    return hashlib.sha256(json.dumps(dict(each(raw)), sort_keys=True).encode()).hexdigest()[:32]


@pytest.mark.parametrize("cell", list(PARENT))
def test_whisper_family_matches_the_parent(root, cell):
    want = PARENT[cell]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        sess = Session(Cell(cell, root), SEED, CPU)
        drv, run = sess.driver, sess.run
        assert _digest(drv.draw()) == want["weights"]
        flops, k1, k2 = 0.0, 0.0, 0.0
        for prompts, k1_s, k2_s, encode, windows in want["rounds"]:
            wins = sess.one_round(count=True)
            drv.traced(wins)
            assert [list(w.prompt) for w in wins] == prompts
            for f in windows:
                flops += f
            flops += encode
            k1 += k1_s
            k2 += k2_s
            assert run.flops == flops
            assert (run.traced["k1_bound_s"], run.traced["k2_bound_s"]) == (k1, k2)
        assert drv.failed() == 0 and run.audio_s == want["audio_s"]
        served = b"".join(r["tokens"].tobytes() + r["p"].tobytes() for r in run.records)
        assert hashlib.sha256(served).hexdigest()[:16] == want["served"]
        sess.free_program()
        assert sess.judge(controls=want["controls"]) == want["check"]
    finally:
        torch.set_num_threads(threads)


def _copied_files_unchanged(root) -> None:
    for f in (tiny.REPO / "benchmark").rglob("*"):
        rel = f.relative_to(tiny.REPO)
        if f.is_file() and "tests" not in rel.parts and "__pycache__" not in rel.parts:
            assert (root / rel).read_bytes() == f.read_bytes(), rel


def test_a_family_added_as_new_files_runs(tmp_path):
    root = tiny.checkout(tmp_path, toy=tiny.TOY_SOURCE)
    _copied_files_unchanged(root)
    res = run_cell(tiny.TOY_CELL, 2**33 + 5, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0, res["check"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"} and res["metrics"]["audio_s_per_s"]["value"] > 0
    assert res["check"]["logit_err"]["limit"] == tiny.TOY_LIMIT
    # its reader, of the counter its driver keeps in run.traced, in the traced line
    res = run_cell(tiny.TOY_CELL, 2**33 + 5, 0.5, True, device="cpu", look_for_chip=False, root=root)
    assert res["correct"], res["check"]
    assert res["metrics"] == {"toy_tokens_per_round": {"value": 2 * 5, "unit": "tokens"}}


def test_a_fault_in_a_new_familys_program_makes_correct_false(tmp_path):
    sound = "tok = int(logits.argmax())"
    assert sound in tiny.TOY_SOURCE
    faulty = tiny.TOY_SOURCE.replace(sound, "tok = (int(logits.argmax()) + 1) % logits.numel()")
    root = tiny.checkout(tmp_path, toy=faulty)
    res = run_cell(tiny.TOY_CELL, 2**33 + 5, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["attempted"] > 0 and res["correct"] is False
    assert res["check"]["logit_err"]["value"] > tiny.TOY_LIMIT


def test_a_configuration_without_a_family_file_stops_before_any_draw(tmp_path, monkeypatch):
    root = tiny.checkout(tmp_path)
    (root / "benchmark" / "configs" / "nosuch.json").write_text(
        json.dumps(dict(tiny.CONFIGS["tiny.serving"], model_type="nosuch")))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "nosuch", "source": "test", "reduced": [], "why": "test",
                                "file": "benchmark/configs/nosuch.json"})
    manifest["workloads"].append({"name": "nosuch.long", "config": "nosuch", "traffic": "tiny-long",
                                  "chips": 1, "why": "test"})
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))

    def no_draw(*a, **k):
        raise AssertionError("a generator was made: something was drawn")

    monkeypatch.setattr(torch, "Generator", no_draw)
    with pytest.raises(SystemExit) as stop:
        run_cell("nosuch.long", 7, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert "benchmark/families/nosuch.py" in str(stop.value)

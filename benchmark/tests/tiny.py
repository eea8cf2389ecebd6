"""A checkout of the benchmark at test sizes: the harness, with tiny model
configurations and short mixes added as new files, beside a manifest of its own;
and, where asked, a family of another kind (``toy_family.py``) with its own
configuration, mix, limits, reader and cell, each a new file."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

TINY = {
    "model_type": "whisper", "d_model": 64, "encoder_layers": 2, "decoder_layers": 4, "encoder_attention_heads": 4,
    "decoder_attention_heads": 4, "encoder_ffn_dim": 256, "decoder_ffn_dim": 256,
    "num_mel_bins": 80, "vocab_size": 51865, "max_source_positions": 96, "max_target_positions": 48,
}
CONFIGS = {
    "tiny.serving": dict(TINY, dtype_policy="serving", kv_int8=True),
    "tiny-v3.bf16": dict(TINY, decoder_layers=2, num_mel_bins=128, vocab_size=51866,
                         dtype_policy="bf16", kv_int8=False),
}
MIXES = {
    "tiny-long": {"lanes": 3, "item_seconds": [5.76], "pool": 1, "steps": 12, "carry_prompt": True,
                  "stagger": True},
    "tiny-clips": {"lanes": 3, "item_seconds": [0.5, 1.0, 1.5], "pool": 2, "steps": 12,
                   "carry_prompt": False},
}
CELLS = {"tiny.long": ("tiny.serving", "tiny-long"), "tiny.clips": ("tiny-v3.bf16", "tiny-clips")}
# the sound program's logit_err at these sizes reads 0.0018 to 0.0036 over six seeds (the CPU
# path computes in f32 on the bf16 weights), the controls' 0.026 to 0.098
LIMIT = 0.01

TOY_SOURCE = (Path(__file__).resolve().parent / "toy_family.py").read_text()
TOY_CELL = "toy.clips"
TOY = {"model_type": "toydec", "d_model": 32, "layers": 2, "heads": 2, "vocab_size": 96,
       "num_mel_bins": 80, "audio_tokens": 10, "window_frames": 300, "carry_tokens": 8}
TOY_MIX = {"lanes": 2, "item_seconds": [2.0, 4.5], "pool": 1, "steps": 5, "carry_prompt": True,
           "stagger": False}
# the toy program computes in float32 against a float64 reference: its logit_err reads ~1e-6
TOY_LIMIT = 1e-3
TOY_READER = '''"""Tokens a traced round served: the toy family's counter in run.traced."""


def read(run):
    return run.traced["toy_tokens"] / run.traced["rounds"] if run.traced["rounds"] else None
'''


def checkout(tmp: Path, toy: str | None = None) -> Path:
    """A copy of the benchmark under ``tmp`` with the tiny cells added as
    files of their own; returns its root (BENCHMARK.json's directory).
    ``toy``: the source of a family ``toydec`` (``TOY_SOURCE``, or a faulty
    twin), added with its configuration, mix, limits, reader and cell."""
    shutil.copytree(REPO / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    manifest = json.loads((REPO / "BENCHMARK.json").read_text())
    for name, cfg in CONFIGS.items():
        (tmp / "benchmark" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        manifest["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                                    "file": f"benchmark/configs/{name}.json"})
    for name, mix in MIXES.items():
        (tmp / "benchmark" / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for name, (config, mix) in CELLS.items():
        manifest["workloads"].append({"name": name, "config": config, "traffic": mix, "chips": 1,
                                      "why": "test"})
        (tmp / "benchmark" / "limits" / f"{name}.json").write_text(
            json.dumps({"logit_err": {"limit": LIMIT}}))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        if "workloads" in m:
            m["workloads"] += list(CELLS)
    if toy is not None:
        b = tmp / "benchmark"
        (b / "families" / "toydec.py").write_text(toy)
        (b / "configs" / "toy.json").write_text(json.dumps(TOY))
        (b / "traffic" / "toy-clips.json").write_text(json.dumps(TOY_MIX))
        (b / "limits" / f"{TOY_CELL}.json").write_text(json.dumps({"logit_err": {"limit": TOY_LIMIT}}))
        (b / "metrics" / "toy_tokens_per_round.py").write_text(TOY_READER)
        manifest["configs"].append({"name": "toy", "source": "test", "reduced": [], "why": "test",
                                    "file": "benchmark/configs/toy.json"})
        manifest["workloads"].append({"name": TOY_CELL, "config": "toy", "traffic": "toy-clips", "chips": 1,
                                      "why": "test"})
        manifest["per_layer"].append({"name": "toy_tokens_per_round", "unit": "tokens", "better": "higher",
                                      "source": "program_counter", "layer": "toy", "moves": "audio_s_per_s",
                                      "workloads": [TOY_CELL]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return tmp

"""The omni family (``benchmark/families/grin_qwen2_vl.py``) at a tiny size on the CPU, and its yardstick.

A tiny ``grin_qwen2_vl`` configuration, added as new files beside the
checkout's own, runs to a correct result line, and a traced one carries
the five readers' values. Two faulty twins of the program are judged not
correct: one that swaps a routed expert where the router's choice is
clear, one whose weights are rounded to fp8. And ``counts_omni.py``'s
figures at the published widths match figures worked by hand.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import tiny
import torch

from benchmark.counts_omni import OmniWork
from benchmark.harness import run_cell

CELL = "omni-tiny.long"
OMNI = {
    "model_type": "grin_qwen2_vl", "hidden_size": 96, "num_hidden_layers": 2, "num_attention_heads": 6,
    "num_key_value_heads": 2, "vocab_size": 97, "mlp_dynamic_expert_num": 4, "mlp_dynamic_null_expert_num": 1,
    "mlp_fixed_expert_num": 2, "dynamic_intermediate_size": 64, "shared_intermediate_size": 24,
    "mlp_dynamic_top_p": 0.7, "mlp_dynamic_top_k": 2, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
    "rope_scaling": {"mrope_section": [2, 3, 3], "rope_type": "default", "type": "default"},
    "use_sliding_window": False, "whisper_hidden_size": 64, "whisper_encoder_layers": 2,
    "whisper_encoder_attention_heads": 4, "whisper_encoder_ffn_dim": 256, "whisper_num_mel_bins": 80,
    "whisper_max_source_positions": 20, "whisper_audio_time": 20, "whisper_query_tokens_size": 200,
    "audio_token_id": 96, "dtype_policy": "bf16",
}
MIX = {"lanes": 2, "item_seconds": [1.2], "pool": 1, "steps": 4, "carry_prompt": True, "stagger": True}
# over six seeds the sound program (bf16 weights and activations on the CPU against the f32
# reference) reads logit_err 0.016-0.027, logp_mean_err 0.0066-0.0104, route_margin_max 0-0.0024;
# its fp8 twin 0.23-0.38, 0.08-0.19 and 0.029-0.082: each limit lies between, ~3x above the sound
LIMITS = {"logit_err": {"limit": 0.08}, "logp_mean_err": {"limit": 0.03}, "route_margin_max": {"limit": 0.015}}
READERS = ["omni_prefill_ms", "omni_step_ms", "omni_step_roofline", "experts_per_token", "omni_mfu"]
SEED = 2**33 + 11


def checkout(tmp):
    root = tiny.checkout(tmp)
    b = root / "benchmark"
    (b / "configs" / "omni-tiny.json").write_text(json.dumps(OMNI))
    (b / "traffic" / "omni-tiny-long.json").write_text(json.dumps(MIX))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "omni-tiny", "source": "test", "reduced": [], "why": "test",
                                "file": "benchmark/configs/omni-tiny.json"})
    manifest["workloads"].append({"name": CELL, "config": "omni-tiny", "traffic": "omni-tiny-long", "chips": 1,
                                  "why": "test"})
    for m in manifest["per_layer"]:
        if m["name"] in READERS:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("omni"))


def test_a_tiny_omni_cell_runs_correct_and_its_readers_read(root):
    res = run_cell(CELL, SEED, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0, res["check"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(res["check"]) == set(LIMITS)
    res = run_cell(CELL, SEED, 0.5, True, device="cpu", look_for_chip=False, root=root)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(got), got
    assert all(got[k] > 0 for k in READERS)
    assert 1.0 <= got["experts_per_token"] <= 2.0


def _faulty_route(real_route):
    """The sound router, with routed experts 0 and 1 swapped wherever their
    probabilities lie 0.2 or more apart and one of them is kept."""
    def route(xf, router_w, dims):
        gates, kept, choice = real_route(xf, router_w, dims)
        probs = torch.softmax(xf @ router_w, dim=-1)
        clear = (probs[:, 0] - probs[:, 1]).abs() >= 0.2
        swap = clear & (kept[:, 0] ^ kept[:, 1])
        perm = torch.tensor([1, 0, 2, 3])
        gates = torch.where(swap[:, None], gates[:, perm], gates)
        kept = torch.where(swap[:, None], kept[:, torch.tensor([1, 0, 2, 3, 4])], kept)
        flipped = torch.where(choice == 0, 1, torch.where(choice == 1, 0, choice))
        choice = torch.where(swap[:, None], flipped, choice)
        return gates, kept, choice
    return route


def test_a_program_that_swaps_a_clear_routing_choice_is_not_correct(root, monkeypatch):
    import whisper_tpu_torch.model.omni as omni

    monkeypatch.setattr(omni, "route", _faulty_route(omni.route))
    res = run_cell(CELL, SEED, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["attempted"] > 0 and res["correct"] is False
    assert res["check"]["route_margin_max"]["value"] >= 0.2


def test_a_program_on_fp8_weights_is_not_correct(root, monkeypatch):
    import whisper_tpu_torch.model.omni_params as omni_params

    real = omni_params.params_from_tensors

    def fp8(dims, tensors, policy=omni_params.DtypePolicy()):
        for name, t in tensors.items():
            if t.dtype == torch.bfloat16 and t.dim() > 1:
                scale = t.float().abs().amax(dim=tuple(range(1, t.dim())), keepdim=True).clamp_min(1e-12) / 448
                tensors[name] = ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).bfloat16()
        return real(dims, tensors, policy)

    monkeypatch.setattr(omni_params, "params_from_tensors", fp8)
    res = run_cell(CELL, SEED, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["attempted"] > 0 and res["correct"] is False
    over = [k for k, c in res["check"].items() if c["value"] > c["limit"]]
    assert over, res["check"]


def test_counts_at_the_published_widths_match_hand_worked_figures():
    cfg = json.loads((tiny.REPO / "benchmark/configs/uni-moe-2.0-omni.bf16.json").read_text())
    w = OmniWork(cfg)
    # 29,364,736 attention (q, o 3584^2; k, v 3584 x 512; biases 4,608), 814,743,552 routed
    # (4 x 3 x 3584 x 18944), 50,921,472 shared (2 x 3 x 3584 x 2368), 17,920 router, 7,168 norms
    assert w.layer_params() == 895_054_848
    assert 2 * w.expert == 407_371_776                       # one routed expert in bf16: 407.4 MB
    # a step of 8 lanes at 448 keys each with every routed expert touched in every layer:
    # 28 x (2 x 80,281,600 + 4 x 29,696) bf16 / f32 weights, 28 x 4 x 407,371,776 routed,
    # 2 x 152064 x 3584 head (+ the f32 final norm), 28 x 2 x 512 x 2 x (8 x 448 + 8) cache,
    # 8 x 3584 x 2 embedding rows, 8 x 152064 x 4 logits
    keys = np.full(8, 448)
    want = (28 * (2 * 80_281_600 + 4 * 29_696) + 28 * 4 * 407_371_776 + 2 * 152_064 * 3584 + 4 * 3584
            + 28 * 2 * 512 * 2 * (8 * 448 + 8) + 8 * 3584 * 2 + 8 * 152_064 * 4)
    assert w.step_bytes(np.full(28, 4), keys) == want
    assert w.step_bound_s(np.full(28, 4), keys) == pytest.approx(want / 3.35e12)
    # one token at 100 keys with 2 routed experts in each layer: 2 x (attention + shared +
    # router) weights a layer, 2 x 3 x 3584 x 18944 a routed expert, 4 x 3584 x 100 attention
    flops = w.token_flops(np.array([100]), np.array([56]))
    assert flops == 28 * 2 * (29_360_128 + 50_921_472 + 17_920) + 56 * 2 * 203_685_888 + 28 * 4 * 3584 * 100

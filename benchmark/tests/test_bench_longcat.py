"""The longcat family (``benchmark/families/longcat_flash.py``) at a tiny size on the CPU, and its yardstick.

A tiny ``longcat_flash`` configuration, added as new files beside the
checkout's own, runs to a correct result line, and a traced one carries
its readers' values. A program on fp8 weights is judged not correct, and
so is one that swaps a clear routing choice. ``counts_longcat.py``'s
figures at the published widths match figures worked by hand.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import tiny
import torch

from benchmark.counts_longcat import LongcatWork
from benchmark.harness import run_cell

CELL = "longcat-tiny.long"
AUDIO = {"whisper_hidden_size": 64, "whisper_encoder_layers": 2, "whisper_encoder_attention_heads": 4,
         "whisper_encoder_ffn_dim": 256, "whisper_num_mel_bins": 80, "whisper_max_source_positions": 20,
         "whisper_audio_time": 20, "whisper_query_tokens_size": 200}
LONGCAT = {
    "model_type": "longcat_flash", "hidden_size": 64, "num_layers": 2, "num_attention_heads": 4, "q_lora_rank": 32,
    "kv_lora_rank": 16, "qk_rope_head_dim": 8, "qk_nope_head_dim": 16, "v_head_dim": 16, "ffn_hidden_size": 96,
    "expert_ffn_hidden_size": 32, "n_routed_experts": 2, "zero_expert_num": 4, "moe_topk": 3,
    "routed_scaling_factor": 6, "rms_norm_eps": 1e-5, "rope_theta": 10000000, "vocab_size": 97,
    "attention_bias": False, "zero_expert_type": "identity",
    "expert_share": {"published": 4, "cards": 2, "rank": 0, "held": [0, 2]},
    "audio_config": AUDIO, "audio_token_id": 96, "text_ids": 90, "dtype_policy": "bf16",
}
MIX = {"lanes": 3, "item_seconds": [1.2], "pool": 1, "steps": 4, "carry_prompt": True, "stagger": True}
# over six seeds the sound program (bf16 weights, latent cache and activations on the CPU against the
# f32 reference) reads logit_err 0.009-0.025, logp_mean_err 0.004-0.009, route_margin_max 0-0.012;
# its fp8 twin 0.069-0.28, 0.030-0.148 and 0.141-0.286: each limit lies between, 2-5x above the sound
LIMITS = {"logit_err": {"limit": 0.05}, "logp_mean_err": {"limit": 0.02}, "route_margin_max": {"limit": 0.06}}
READERS = ["longcat_prefill_ms", "longcat_step_ms", "held_experts_read", "longcat_mfu", "held_choices_per_token"]
SEED = 2**33 + 25


def checkout(tmp):
    root = tiny.checkout(tmp)
    b = root / "benchmark"
    (b / "configs" / "longcat-tiny.json").write_text(json.dumps(LONGCAT))
    (b / "traffic" / "longcat-tiny-long.json").write_text(json.dumps(MIX))
    (b / "limits" / f"{CELL}.json").write_text(json.dumps(LIMITS))
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "longcat-tiny", "source": "test", "reduced": [], "why": "test",
                                "file": "benchmark/configs/longcat-tiny.json"})
    manifest["workloads"].append({"name": CELL, "config": "longcat-tiny", "traffic": "longcat-tiny-long",
                                  "chips": 1, "why": "test"})
    for m in manifest["per_layer"]:
        if m["name"] in READERS + ["mla_roofline"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(manifest))
    return root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return checkout(tmp_path_factory.mktemp("longcat"))


def test_a_tiny_longcat_cell_runs_correct_and_its_readers_read(root):
    res = run_cell(CELL, SEED, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["correct"] and res["attempted"] > 0 and res["failed"] == 0, res["check"]
    assert set(res["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(res["check"]) == set(LIMITS)
    res = run_cell(CELL, SEED, 0.5, True, device="cpu", look_for_chip=False, root=root)
    assert res["correct"], res["check"]
    got = {k: v["value"] for k, v in res["metrics"].items()}
    assert set(READERS) <= set(got), got
    assert all(got[k] > 0 for k in READERS)
    assert got["held_experts_read"] <= 2
    assert got["held_choices_per_token"] <= 2        # at most each held expert once a token
    assert "mla_roofline" not in got        # the CPU's trace holds no kernel of the card


def test_a_program_on_fp8_weights_is_not_correct(root, monkeypatch):
    import whisper_tpu_torch.model.longcat_params as longcat_params

    real = longcat_params.params_from_tensors

    def fp8(dims, tensors, policy=longcat_params.DtypePolicy()):
        for name, t in tensors.items():
            if t.dtype == torch.bfloat16 and t.dim() > 1:
                scale = t.float().abs().amax(dim=tuple(range(1, t.dim())), keepdim=True).clamp_min(1e-12) / 448
                tensors[name] = ((t.float() / scale).to(torch.float8_e4m3fn).float() * scale).bfloat16()
        return real(dims, tensors, policy)

    monkeypatch.setattr(longcat_params, "params_from_tensors", fp8)
    res = run_cell(CELL, SEED, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["attempted"] > 0 and res["correct"] is False
    assert [k for k, c in res["check"].items() if c["value"] > c["limit"]], res["check"]


def test_a_program_that_swaps_a_clear_routing_choice_is_not_correct(root, monkeypatch):
    """The sound router, with a row's lowest choice swapped for the
    expert just past its top 3 wherever the two lie half a mean score
    apart."""
    import whisper_tpu_torch.model.longcat as longcat

    real = longcat.route

    def route(xf, blk, dims):
        gates, zero, choice = real(xf, blk, dims)
        select = torch.softmax(xf @ blk.router_w, -1) + blk.router_bias
        order = select.topk(dims.top_k + 1, dim=-1)
        clear = (order.values[:, -2] - order.values[:, -1]) * dims.n_experts >= 0.5
        swapped = choice.clone()
        swapped[:, -1] = order.indices[:, -1]
        return gates, zero, torch.where(clear[:, None], swapped, choice)

    monkeypatch.setattr(longcat, "route", route)
    res = run_cell(CELL, SEED, 0.5, False, device="cpu", look_for_chip=False, root=root)
    assert res["attempted"] > 0 and res["correct"] is False
    assert res["check"]["route_margin_max"]["value"] >= 0.5


def test_counts_at_the_published_widths_match_hand_worked_figures():
    cfg = json.loads((tiny.REPO / "benchmark/configs/longcat-flash-omni.ep64-bf16.json").read_text())
    w = LongcatWork(cfg)
    # an attention sublayer: q_a 6144 x 1536, q_b 1536 x 64 x 192, kv_a 6144 x 576, kv_b 512 x 64 x 256,
    # o 64 x 128 x 6144; a dense FFN 3 x 6144 x 12288; a routed expert 3 x 6144 x 2048
    assert w.attn == 9_437_184 + 18_874_368 + 3_538_944 + 8_388_608 + 50_331_648 == 90_570_752
    assert w.ffn == 226_492_416 and w.expert == 37_748_736
    # 634.1 M of attention and dense FFNs a double layer, 8 held experts of 37.7 M
    assert 2 * (w.attn + w.ffn) == 634_126_336
    # a step of 64 lanes at 500 keys each, 5 held experts read a layer: 28 x (2 x 634,126,336 bf16 +
    # f32 norms (2 x (1536 + 512 + 2 x 6144)), router and bias (768 x 6145)), 28 x 5 x 37,748,736 x 2,
    # the head 131072 x 6144 x 2 and the final norm, 56 x 1152 x (64 x 500 + 64) cache bytes,
    # 64 x 6144 x 2 embedding rows, 64 x 131072 x 4 logits
    keys = np.full(64, 500)
    want = (28 * (2 * 634_126_336 + 4 * (2 * 14_336 + 768 * 6145)) + 28 * 5 * 37_748_736 * 2
            + 131_072 * 6144 * 2 + 4 * 6144 + 56 * 1152 * (64 * 500 + 64) + 64 * 6144 * 2 + 64 * 131_072 * 4)
    assert w.step_bytes(np.full(28, 5), keys) == want
    # an MLA call at 64 lanes x 560 keys: 35,840 rows of 1152 bytes, q 64 x 64 x 576 x 2, out x 512 x 4;
    # 2 x 64 x (576 + 512) operations a key
    nbytes, flops = w.mla_call(np.full(64, 560))
    assert nbytes == 35_840 * 1152 + 64 * 64 * 576 * 2 + 64 * 64 * 512 * 4
    assert flops == 2 * 64 * 1088 * 35_840
    assert w.mla_bound_s(np.full(64, 560)) == pytest.approx(nbytes / 3.35e12)

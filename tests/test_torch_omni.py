"""Uni-MoE-2.0-Omni's audio-to-text path in the port against its plain float32 reference.

At a tiny size on the CPU (2 layers, 6 query heads over 2 K/V heads of
16, M-RoPE sections [2, 3, 3], 4 routed + 1 null + 2 shared experts, 97
ids, a 2-layer Whisper encoder over 40 mel frames: 4 audio tokens), with
the f32 policy: the window through ``OmniContext`` and the model's prefill
and cached token steps against the benchmark's reference
(``benchmark/reference/omni_ref.py``) full forward pass; the router on
hand-set probabilities; M-RoPE; the grouped-query fold through K2's plain
version; the loader; and the configuration file's published widths.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

import benchmark.reference.omni_ref as ref
from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd_ref
from whisper_tpu_torch.model.decoder import SelfKV
from whisper_tpu_torch.model.omni import gqa_decode, moe_lanes, mrope, prefill, route
from whisper_tpu_torch.model.omni_params import OmniDims, params_from_tensors, tensor_names
from whisper_tpu_torch.model.params import DtypePolicy
from whisper_tpu_torch.runtime.omni import OmniContext, OmniState, omni_step

ROOT = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
F32 = DtypePolicy.f32()
TINY = {
    "hidden_size": 96, "num_hidden_layers": 2, "num_attention_heads": 6, "num_key_value_heads": 2,
    "vocab_size": 97, "mlp_dynamic_expert_num": 4, "mlp_dynamic_null_expert_num": 1,
    "mlp_fixed_expert_num": 2, "dynamic_intermediate_size": 64, "shared_intermediate_size": 24,
    "mlp_dynamic_top_p": 0.7, "mlp_dynamic_top_k": 2, "rms_norm_eps": 1e-6, "rope_theta": 1000000,
    "rope_scaling": {"mrope_section": [2, 3, 3], "rope_type": "default", "type": "default"},
    "use_sliding_window": False, "whisper_hidden_size": 64, "whisper_encoder_layers": 2,
    "whisper_encoder_attention_heads": 4, "whisper_num_mel_bins": 80, "whisper_max_source_positions": 20,
    "whisper_audio_time": 20, "whisper_query_tokens_size": 200, "audio_token_id": 96,
}
DIMS = OmniDims.from_config(TINY)
# f32 against f32: the port sums in other orders (fused q/k/v and gate/up columns, the shared
# experts as one SwiGLU, einsum and cache layouts, K2's plain version), which moves a logit of
# magnitude ~3 by ~1e-6 at two layers; 1e-4 of the largest logit leaves that 30x of room and
# is still far below a bf16 rounding of the activations (~4e-3 relative)
TOL = 1e-4


def draw(dims: OmniDims, seed: int) -> dict:
    """Random f32 tensors by checkpoint name: matmul weights N(0, 1/fan_in),
    embeddings N(0, 1), biases N(0, 0.02^2), norm gains 1 + N(0, 0.05^2)."""
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in tensor_names(dims).items():
        x = torch.randn(shape, generator=g)
        if name.endswith("bias"):
            x = x * 0.02
        elif "norm" in name:
            x = 1 + 0.05 * x
        elif name.endswith("embed_tokens.weight") or name.endswith("embed_positions.weight"):
            pass
        else:
            x = x * (int(np.prod(shape[1:])) ** -0.5)
        out[name] = x
    return out


def _layer(tensors: dict):
    def layer(i):
        p = f"model.layers.{i}."
        return {k[len(p):]: v for k, v in tensors.items() if k.startswith(p)}
    return layer


def _prompts(dims: OmniDims, seed: int, lanes: int, width: int):
    """Right-padded prompts [lanes, width] of different lengths, each with
    the window's audio placeholders in the middle."""
    rng = np.random.default_rng(seed)
    a = dims.audio_tokens
    prompt = np.zeros((lanes, width), np.int32)
    lens = []
    for b in range(lanes):
        head = rng.integers(0, dims.audio_token_id, size=2 + b).tolist()
        tail = rng.integers(0, dims.audio_token_id, size=3).tolist()
        seq = head + [dims.audio_token_id] * a + tail
        prompt[b, : len(seq)] = seq
        lens.append(len(seq))
    return prompt, np.array(lens, np.int32)


@pytest.fixture(scope="module")
def model():
    raw = draw(DIMS, 5)
    params = params_from_tensors(DIMS, dict(raw), F32)
    mel = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 80, 40)).astype(np.float32))
    return raw, params, mel


def _reference(raw, mel, prompt, plen, served):
    """The reference's logits before each served token, its routing and margins."""
    feats = ref.encode(raw.__getitem__, TINY, mel)
    audio = ref.audio_tokens(raw.__getitem__, TINY, feats)
    seqs, rows = [], []
    for b in range(len(prompt)):
        ids = list(prompt[b, : plen[b]]) + [int(t) for t in served[b][:-1]]
        seqs.append((torch.tensor(ids, dtype=torch.long), audio[b], int(plen[b])))
        rows.append(list(range(plen[b] - 1, len(ids))))
    return ref.forward(_layer(raw), raw, TINY, seqs, rows=rows), seqs


def test_window_through_the_entry_points_matches_the_reference(model):
    raw, params, mel = model
    ctx = OmniContext(params, DIMS, compute_dtype=torch.float32, device="cpu", prompt_capacity=16,
                      max_new_tokens=6)
    prompt, plen = _prompts(DIMS, 7, 3, 16)
    res = ctx.run_window(prompt, plen, ctx.encode_window(mel), force_steps=5)
    assert res.tokens.shape == (3, 5) and res.routes.shape == (2, 3, 22, 2)
    out, seqs = _reference(raw, mel, prompt, plen, res.tokens)
    for b, o in enumerate(out):
        logp = torch.log_softmax(o["logits"], -1)
        top2 = o["logits"].topk(2, dim=-1).values
        for t in range(5):
            if float(top2[t, 0] - top2[t, 1]) > 1e-3:
                assert res.tokens[b, t] == int(o["logits"][t].argmax())
            assert abs(np.log(res.p[b, t]) - float(logp[t, res.tokens[b, t]])) < TOL
        # the routing the program recorded at every position it fed is the reference's own
        cols = [res.attn_start[b] + j for j in range(plen[b])] + [16 + t for t in range(4)]
        assert (o["margins"] == 0).all()
        np.testing.assert_array_equal(res.routes[:, b, cols], o["routes"].numpy())
    # the steps' columns hold the routing of every step; the pads' none
    assert (res.routes[:, 0, : res.attn_start[0]] == -1).all()


def test_prefill_then_steps_through_the_cache_match_the_full_forward(model):
    """Logits after the prompt and after each fed token, against the
    reference's one pass over the whole sequence."""
    raw, params, mel = model
    prompt, plen = _prompts(DIMS, 8, 2, 14)
    feats_ctx = OmniContext(params, DIMS, torch.float32, "cpu", prompt_capacity=14, max_new_tokens=4)
    audio = feats_ctx.encode_window(mel[:2])
    st = OmniState.zeros(DIMS, 2, 4, 18, CPU)
    st.routes.fill_(-1)
    kv = feats_ctx.self_kv(2)
    p = torch.from_numpy(prompt)
    attn_start = 14 - torch.from_numpy(plen)
    cols = torch.arange(14)[None]
    ids = p.gather(1, ((cols - attn_start[:, None]) % 14).long())
    with torch.inference_mode():
        logits = [prefill(params, DIMS, ids, audio, attn_start, kv, st.routes, st.counts, torch.float32)]
        st.logits.copy_(logits[0])
        st.attn_start.copy_(attn_start)
        st.n_past.copy_(torch.from_numpy(plen))
        for _ in range(3):
            omni_step(params, DIMS, st, kv, 14, torch.float32)
            logits.append(st.logits.clone())
    got = torch.stack(logits, 1)                                   # [B, 4, V]
    out, _ = _reference(raw, mel[:2], prompt, plen, st.tokens[:, :4].numpy())
    for b, o in enumerate(out):
        scale = float(o["logits"].abs().max())
        assert float((got[b] - o["logits"]).abs().max()) <= TOL * scale
    # counts: each real prompt token and each step, in every layer
    assert st.counts[:, -1].tolist() == [int(plen.sum()) + 2 * 3] * 2


def _route(probs: list[float]):
    xf = torch.log(torch.tensor([probs], dtype=torch.float32))
    return route(xf, torch.eye(5), DIMS)


@pytest.mark.parametrize("probs,kept", [
    ([0.75, 0.1, 0.08, 0.05, 0.02], [0]),           # one expert reaches 0.7
    ([0.5, 0.3, 0.1, 0.05, 0.05], [0, 1]),           # two are needed
    ([0.3, 0.25, 0.2, 0.15, 0.1], [0, 1]),           # the cap binds below 0.7
    ([0.1, 0.05, 0.05, 0.05, 0.75], [4]),            # the null expert first, alone
    ([0.05, 0.5, 0.05, 0.1, 0.3], [1, 4]),           # the null expert second
    ([0.1, 0.1, 0.1, 0.2, 0.5], [4, 3]),             # the null expert first, a routed one second
], ids=["one", "two", "cap", "null-first", "null-second", "null-then-routed"])
def test_router_keeps_the_shortest_prefix_reaching_top_p(probs, kept):
    gates, keep, choice = _route(probs)
    assert [int(e) for e in choice[0] if e >= 0] == kept == ref.routing(probs, 0.7, 2)
    want = [probs[e] if e in kept else 0.0 for e in range(4)]
    np.testing.assert_allclose(gates[0].numpy(), want, rtol=1e-6)
    assert keep[0].nonzero().squeeze(1).tolist() == sorted(kept)


def test_a_null_expert_alone_adds_nothing_routed(model):
    """Where only the null expert is kept, the layer's output is the shared
    experts' alone: the routed experts' part is zero."""
    _, params, _ = model
    blk = params.blocks[0]
    x = torch.randn(3, DIMS.d, generator=torch.Generator().manual_seed(3))
    null_only = blk.router_w.clone()
    null_only[:, 4] = 0.0
    null_only[:, :4] = -100.0 * x[0].sign()[:, None]               # routed logits far below the null's
    saved = blk.router_w
    blk.router_w = null_only
    try:
        out, choice, _ = moe_lanes(x[:1], blk, DIMS, torch.float32)
    finally:
        blk.router_w = saved
    assert choice[0].tolist() == [4, -1]
    from whisper_tpu_torch.kernels.moe import swiglu
    from whisper_tpu_torch.model.omni import rms_norm
    shared = swiglu(rms_norm(x[:1], blk.post_norm_w, DIMS.rms_eps), blk.shared_gate_up, blk.shared_down)
    torch.testing.assert_close(out, shared, rtol=0, atol=0)


def test_mrope_with_distinct_streams_matches_qwen2_vl_and_one_stream_is_rope():
    pos3 = torch.stack([torch.arange(9), torch.arange(9) * 2 + 1, 30 - torch.arange(9)])
    cos, sin = mrope(pos3[:, None], DIMS)
    rcos, rsin = ref.mrope_cos_sin(pos3, TINY)
    torch.testing.assert_close(cos[0], rcos, rtol=0, atol=1e-6)
    torch.testing.assert_close(sin[0], rsin, rtol=0, atol=1e-6)
    same = torch.arange(9)[None].expand(3, -1)
    cos, sin = mrope(same[:, None], DIMS)
    inv = 1.0 / (1e6 ** (torch.arange(0, 16, 2).float() / 16))
    ang = torch.arange(9).float()[:, None] * inv
    torch.testing.assert_close(cos[0], torch.cat([ang, ang], -1).cos(), rtol=0, atol=1e-6)
    torch.testing.assert_close(sin[0], torch.cat([ang, ang], -1).sin(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("g,n_kv,dh", [(7, 4, 128), (3, 2, 16)])
def test_gqa_fold_through_k2_plain_version_matches_repeated_heads(g, n_kv, dh):
    """The query heads of a K/V head as K2 lanes (``kv_group`` = g) against
    attention with the K/V heads repeated, over each lane's keys [start, valid)."""
    gen = torch.Generator().manual_seed(g)
    b, c = 3, 40
    q = torch.randn(b, n_kv * g, dh, generator=gen) * dh ** -0.5
    k = torch.randn(b, n_kv * dh, c, generator=gen)
    v = torch.randn(b, n_kv * dh, c, generator=gen)
    start = torch.tensor([0, 5, 17], dtype=torch.int32)
    valid = torch.full((b,), 33, dtype=torch.int32)
    lanes = lambda t: t[:, None].expand(b, g).reshape(-1).contiguous()   # noqa: E731
    got = gqa_decode(q, k, v, lanes(valid), lanes(start), g)
    kh = k.reshape(b, n_kv, dh, c).repeat_interleave(g, 1)            # [B, n_head, Dh, C]
    vh = v.reshape(b, n_kv, dh, c).repeat_interleave(g, 1)
    s = torch.einsum("bhd,bhdc->bhc", q, kh)
    col = torch.arange(c)
    keep = (col[None] >= start[:, None].long()) & (col[None] < valid[:, None].long())
    p = torch.softmax(s.masked_fill(~keep[:, None], float("-inf")), -1)
    torch.testing.assert_close(got, torch.einsum("bhc,bhdc->bhd", p, vh), rtol=1e-5, atol=1e-5)
    # and K2's plain version is what ran
    qg = q.reshape(b, n_kv, g, dh).transpose(1, 2).reshape(b * g, n_kv * dh, 1)
    plain = decode_attention_hd_ref(qg, k, v, n_kv, lanes(valid), lanes(start), kv_group=g)
    torch.testing.assert_close(got, plain.reshape(b, g, n_kv, dh).transpose(1, 2).reshape(b, -1, dh))


def test_loader_releases_every_raw_tensor_and_refuses_a_missing_one():
    raw = draw(DIMS, 9)
    n = len(raw)
    params = params_from_tensors(DIMS, raw, F32)
    assert raw == {} and n == len(tensor_names(DIMS))
    assert params.blocks[0].qkv_w.shape == (96, 96 + 2 * 32)
    assert params.blocks[1].gate_up_3.shape == (96, 128) and params.head_w.shape == (96, 97)
    raw = draw(DIMS, 9)
    del raw["model.layers.1.mlp.experts.2.up_proj.weight"]
    with pytest.raises(ValueError, match="experts.2.up_proj"):
        params_from_tensors(DIMS, raw, F32)


def test_the_configuration_file_holds_the_published_widths():
    cfg = json.loads((ROOT / "benchmark/configs/uni-moe-2.0-omni.bf16.json").read_text())
    d = OmniDims.from_config(cfg)
    assert (d.d, d.n_layer, d.n_head, d.n_kv_head, d.head_dim, d.group) == (3584, 28, 28, 4, 128, 7)
    assert (d.n_routed, d.n_null, d.n_shared, d.routed_width, d.shared_width) == (4, 1, 2, 18944, 2368)
    assert (d.top_p, d.top_k, d.n_vocab, d.rms_eps, d.rope_theta) == (0.7, 2, 152064, 1e-6, 1e6)
    assert d.mrope_section == (16, 24, 24) and cfg["model_type"] == "grin_qwen2_vl"
    a = d.audio
    assert (a.n_audio_state, a.n_audio_layer, a.n_audio_head, a.n_mels, a.n_audio_ctx) == (1280, 32, 20, 128, 1500)
    assert (d.audio_pool, d.audio_tokens) == (5, 300)
    per_layer = sum(int(np.prod(s)) for name, s in tensor_names(d).items() if name.startswith("model.layers.0."))
    # 29.36 M attention, 814.74 M routed, 50.92 M shared experts, 17,920 router, 7,168 norms
    assert per_layer == 895_054_848


def test_eager_and_replayed_state_layouts_agree():
    """The state a CUDA graph replays over is the one the eager loop uses."""
    st = OmniState.zeros(DIMS, 3, 6, 22, CPU)
    assert st.routes.shape == (2, 3, 22, 2) and st.counts.shape == (2, 6)
    kv = OmniContext(None, DIMS, torch.float32, "cpu", prompt_capacity=16, max_new_tokens=6).self_kv(3)
    assert isinstance(kv, SelfKV) and kv.k.shape == (2, 3, 32, 22)


def test_a_served_placeholder_id_is_a_token_after_the_prompt(model):
    """Only the prompt's placeholders take audio: a token step fed the
    placeholder's id embeds it as the token it is, and the reference reads
    it so past the prompt."""
    from whisper_tpu_torch.model.omni import embed

    _, params, _ = model
    ids = torch.tensor([[DIMS.audio_token_id, 3]])
    torch.testing.assert_close(embed(params, DIMS, ids, None, torch.float32)[0],
                               params.embed[[DIMS.audio_token_id, 3]], rtol=0, atol=0)
    audio = torch.randn(1, 1, DIMS.d)
    got = embed(params, DIMS, ids, audio, torch.float32)[0]
    torch.testing.assert_close(got[0], audio[0, 0], rtol=0, atol=0)


def test_a_window_longer_than_the_cache_is_refused(model):
    _, params, mel = model
    ctx = OmniContext(params, DIMS, torch.float32, "cpu", prompt_capacity=16, max_new_tokens=4)
    prompt, plen = _prompts(DIMS, 7, 3, 16)
    with pytest.raises(ValueError, match="holds 4 steps"):
        ctx.run_window(prompt, plen, ctx.encode_window(mel), force_steps=5)


# the step's expert layer (kernels/moe.py): its plain version, the wrapper's refusals, the counter

def _all_experts(h, gates, blk):
    """The step's expert layer as it was before the grouped kernel: every
    routed expert over every lane, times its gate (0 where a lane did not
    keep it)."""
    from whisper_tpu_torch.kernels.moe import swiglu

    out = swiglu(h, blk.shared_gate_up, blk.shared_down)
    for e in range(DIMS.n_routed):
        out = out + gates[:, e:e + 1] * swiglu(h, getattr(blk, f"gate_up_{e}"), getattr(blk, f"down_{e}"))
    return out


@pytest.mark.parametrize("policy", [F32, DtypePolicy()], ids=["f32", "bf16"])
def test_expert_layer_skipping_unkept_experts_equals_every_expert_zero_gated(policy):
    """Three lanes, routed expert 2 kept by none (its router column far below
    the rest for these positive rows): ``moe_lanes`` runs the shared experts
    and the three kept, and equals the all-experts arithmetic bit for bit
    (an unkept expert adds out + 0 * y = out); its counter adds 3."""
    from whisper_tpu_torch.model.omni import rms_norm

    params = params_from_tensors(DIMS, draw(DIMS, 11), policy)
    blk = params.blocks[1]
    x = torch.randn(3, DIMS.d, generator=torch.Generator().manual_seed(4)).abs().to(policy.param_dtype)
    blk.router_w[:, 2] = -100.0
    read = torch.zeros(1, dtype=torch.int32)
    out, _, kept = moe_lanes(x, blk, DIMS, policy.param_dtype, read)
    hf = rms_norm(x, blk.post_norm_w, DIMS.rms_eps)
    gates, kept_again, _ = route(hf, blk.router_w, DIMS)
    assert torch.equal(kept, kept_again)
    assert not kept[:, 2].any() and kept[:, [0, 1, 3]].any(0).all()
    assert torch.equal(out, _all_experts(hf.to(policy.param_dtype), gates, blk))
    assert int(read) == 3


def _refused(case):
    """Inputs the wrapper refuses, by case, on the CPU."""
    g = torch.Generator().manual_seed(2)
    d, w, ws = DIMS.d, DIMS.routed_width, 2 * DIMS.shared_width

    def pair(width, dtype=torch.float32):
        return (torch.randn(2 * width, d, generator=g).to(dtype).T, torch.randn(d, width, generator=g).to(dtype).T)

    h, gates = torch.randn(3, d, generator=g), torch.rand(3, 4, generator=g)
    shared, routed = pair(ws), [pair(w) for _ in range(4)]
    if case == "dtype":
        h = h.bfloat16()
    elif case == "gates dtype":
        gates = gates.bfloat16()
    elif case == "layout":
        routed[1] = (routed[1][0].contiguous(), routed[1][1])
    elif case == "lanes":
        h, gates = torch.randn(65, d, generator=g), torch.rand(65, 4, generator=g)
    return h, gates, shared, routed


@pytest.mark.parametrize("case,match", [("dtype", "is torch.float32, h torch.bfloat16"),
                                        ("gates dtype", "gates must be f32"),
                                        ("layout", "not the transpose of a contiguous"),
                                        ("lanes", "1 to 64 lanes")])
def test_expert_layer_wrapper_refuses_what_it_does_not_take(case, match):
    """A weight of another dtype than h, gates not f32, a gate_up that is not
    the transposed view of a contiguous [2w, d], more than 64 lanes: refused
    on the CPU as on the card (the inputs are otherwise well formed)."""
    from whisper_tpu_torch.kernels.moe import moe_experts

    with pytest.raises(ValueError, match=match):
        moe_experts(*_refused(case))
    moe_experts(*_refused("none"))


def test_a_window_counts_the_experts_its_steps_read(model):
    """Through ``OmniContext``, the steps' expert layers count the routed
    experts they read (``moe.experts_read``, from the device's counter):
    exactly the experts some lane kept (the routing record's
    ``moe.experts_touched``), over ``moe.step_layers`` = steps x layers; the
    benchmark's reader divides the two."""
    import importlib.util

    from whisper_tpu_torch.obs.profiler import TRACER

    _, params, mel = model
    ctx = OmniContext(params, DIMS, compute_dtype=torch.float32, device="cpu", prompt_capacity=16,
                      max_new_tokens=6)
    prompt, plen = _prompts(DIMS, 9, 3, 16)
    before = dict(TRACER.counters)
    res = ctx.run_window(prompt, plen, ctx.encode_window(mel), force_steps=6)
    delta = {k: TRACER.counters[k] - before.get(k, 0)
             for k in ("moe.experts_read", "moe.experts_touched", "moe.step_layers")}
    assert delta["moe.experts_read"] == delta["moe.experts_touched"] == int(res.touched.sum()) > 0
    assert delta["moe.step_layers"] == 6 * DIMS.n_layer
    spec = importlib.util.spec_from_file_location("omni_experts_read", ROOT / "benchmark/metrics/omni_experts_read.py")
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    got = reader.read(None)
    assert got == TRACER.counters["moe.experts_read"] / TRACER.counters["moe.step_layers"]
    assert 0 < got <= DIMS.n_routed

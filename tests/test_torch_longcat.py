"""LongCat-Flash-Omni's audio-to-text path in the port against its plain float32 reference.

At a tiny size on the CPU (2 double layers, 4 heads of 16 + 8 over a
16-wide latent, 8 published routed experts of which this card holds 2..5,
4 zero experts, top 3, 97 ids, a 2-layer Whisper encoder over 40 mel
frames: 4 audio tokens): the window through ``LongcatContext`` and the
model's prefill and cached token steps against the benchmark's reference
(``benchmark/reference/longcat_ref.py``) full forward pass, in f32 and
bf16; the expert shares adding up to the uncut layer; the reference against
transformers' ``LongcatFlashForCausalLM``; absorbed against expanded
latent attention; a zero expert; routing ids past 127; the loader.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import benchmark.reference.longcat_ref as ref
import benchmark.reference.omni_ref as omni_ref
from whisper_tpu_torch.kernels.mla import mla_decode, mla_decode_ref
from whisper_tpu_torch.model.longcat import _latent, moe_rows, prefill, rope_tables, route, step
from whisper_tpu_torch.model.longcat_params import LongcatDims, params_from_tensors, tensor_names
from whisper_tpu_torch.model.omni import rms_norm
from whisper_tpu_torch.model.params import DtypePolicy
from whisper_tpu_torch.runtime.longcat import LongcatContext
from whisper_tpu_torch.runtime.omni import OmniState, omni_step

CPU = torch.device("cpu")
F32 = DtypePolicy.f32()
AUDIO = {"whisper_hidden_size": 64, "whisper_encoder_layers": 2, "whisper_encoder_attention_heads": 4,
         "whisper_encoder_ffn_dim": 256, "whisper_num_mel_bins": 80, "whisper_max_source_positions": 20,
         "whisper_audio_time": 20, "whisper_query_tokens_size": 200}


def tiny(published=8, held=(2, 6), zero=4, top_k=3) -> dict:
    return {"hidden_size": 64, "num_layers": 2, "num_attention_heads": 4, "q_lora_rank": 32, "kv_lora_rank": 16,
            "qk_rope_head_dim": 8, "qk_nope_head_dim": 16, "v_head_dim": 16, "ffn_hidden_size": 96,
            "expert_ffn_hidden_size": 32, "n_routed_experts": held[1] - held[0], "zero_expert_num": zero,
            "moe_topk": top_k, "routed_scaling_factor": 6, "rms_norm_eps": 1e-5, "rope_theta": 10000000,
            "vocab_size": 97, "attention_bias": False, "zero_expert_type": "identity",
            "expert_share": {"published": published, "cards": published // (held[1] - held[0]),
                             "rank": held[0] // (held[1] - held[0]), "held": list(held)},
            "audio_config": AUDIO, "audio_token_id": 96}


TINY = tiny()
DIMS = LongcatDims.from_config(TINY)
# f32 against f32: the port sums in other orders (fused gate/up, einsum and cache layouts, the
# absorbed step's products through the latent) and moves a logit of magnitude ~3 by ~1e-6;
# 1e-4 of the largest logit leaves that ~30x of room, far below a bf16 rounding (~4e-3 relative)
TOL = 1e-4


def draw(cfg: dict, seed: int, all_experts: bool = False) -> dict:
    """Random f32 tensors by checkpoint name: matmul weights N(0, 1/fan_in),
    embeddings N(0, 1), biases N(0, 0.02^2), norm gains 1 + N(0, 0.05^2),
    the router's correction bias N(0, (0.1 / n_experts)^2). With
    ``all_experts``, every published routed expert (the uncut layer)."""
    if all_experts:
        cfg = dict(cfg, n_routed_experts=cfg["expert_share"]["published"],
                   expert_share={**cfg["expert_share"], "held": [0, cfg["expert_share"]["published"]]})
    dims = LongcatDims.from_config(cfg)
    g = torch.Generator().manual_seed(seed)
    out = {}
    for name, shape in tensor_names(dims).items():
        x = torch.randn(shape, generator=g)
        if name.endswith("e_score_correction_bias"):
            x = x * 0.1 / dims.n_experts
        elif name.endswith("bias"):
            x = x * 0.02
        elif "norm" in name:
            x = 1 + 0.05 * x
        elif not name.endswith(("embed_tokens.weight", "embed_positions.weight")):
            x = x * (int(np.prod(shape[1:])) ** -0.5)
        out[name] = x
    return out


def _layer(tensors: dict):
    def layer(i):
        p = f"model.layers.{i}."
        return {k[len(p):]: v for k, v in tensors.items() if k.startswith(p)}
    return layer


def _prompts(dims: LongcatDims, seed: int, lanes: int, width: int):
    """Right-padded prompts [lanes, width] of different lengths, each with
    the window's audio placeholders in the middle."""
    rng = np.random.default_rng(seed)
    prompt = np.zeros((lanes, width), np.int32)
    lens = []
    for b in range(lanes):
        seq = (rng.integers(0, dims.audio_token_id, size=2 + b).tolist() + [dims.audio_token_id] * dims.audio_tokens
               + rng.integers(0, dims.audio_token_id, size=3).tolist())
        prompt[b, : len(seq)] = seq
        lens.append(len(seq))
    return prompt, np.array(lens, np.int32)


@pytest.fixture(scope="module")
def model():
    raw = draw(TINY, 5)
    mel = torch.from_numpy(np.random.default_rng(6).normal(size=(3, 80, 40)).astype(np.float32))
    return raw, mel


def _reference(raw, cfg, mel, prompt, plen, served, prec=ref.Precision(), follow=None):
    """The reference's logits before each served token, its routing and
    margins (continuing with ``follow``'s routing where given)."""
    feats = omni_ref.encode(raw.__getitem__, cfg["audio_config"], mel, prec)
    audio = omni_ref.audio_tokens(raw.__getitem__, cfg["audio_config"], feats, prec)
    seqs, rows = [], []
    for b in range(len(prompt)):
        ids = list(prompt[b, : plen[b]]) + [int(t) for t in served[b][:-1]]
        seqs.append((torch.tensor(ids, dtype=torch.long), audio[b], int(plen[b])))
        rows.append(list(range(plen[b] - 1, len(ids))))
    return ref.forward(_layer(raw), raw, cfg, seqs, prec, follow, rows=rows)


def test_window_through_the_entry_points_matches_the_reference(model):
    raw, mel = model
    ctx = LongcatContext(params_from_tensors(DIMS, dict(raw), F32), DIMS, compute_dtype=torch.float32,
                         device="cpu", prompt_capacity=16, max_new_tokens=6)
    prompt, plen = _prompts(DIMS, 7, 3, 16)
    res = ctx.run_window(prompt, plen, ctx.encode_window(mel), force_steps=5)
    assert res.tokens.shape == (3, 5) and res.routes.shape == (2, 3, 22, 3) and res.routes.dtype == np.int8
    out = _reference(raw, TINY, mel, prompt, plen, res.tokens)
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
        np.testing.assert_array_equal(np.sort(res.routes[:, b, cols], -1), np.sort(o["routes"].numpy(), -1))
    assert (res.routes[:, 0, : res.attn_start[0]] == -1).all()


@pytest.mark.parametrize("policy,tol", [(F32, TOL), (DtypePolicy(), 0.1)], ids=["f32", "bf16"])
def test_prefill_then_steps_through_the_latent_cache_match_the_full_forward(model, policy, tol):
    """Logits after the prompt and after each fed token, against the
    reference's one pass over the whole sequence, which continues with the
    program's routing (a bf16 near-tie may choose another expert). bf16:
    weights, the latent cache and activations rounded through 2 double
    layers of width 64 move a logit by 1.6-3.3 % of the largest over weight
    seeds 5-9; 10 % leaves 3x of room, and a step that leaves out the zero
    experts reads 45-63 %."""
    raw, mel = model
    dtype = policy.compute_dtype
    params = params_from_tensors(DIMS, dict(raw), policy)
    prompt, plen = _prompts(DIMS, 8, 2, 14)
    ctx = LongcatContext(params, DIMS, dtype, "cpu", prompt_capacity=14, max_new_tokens=4)
    audio = ctx.encode_window(mel[:2])
    st = OmniState.zeros(DIMS, 2, 4, 18, CPU)
    st.routes.fill_(-1)
    kv = ctx.self_kv(2)
    p = torch.from_numpy(prompt)
    attn_start = 14 - torch.from_numpy(plen)
    ids = p.gather(1, ((torch.arange(14)[None] - attn_start[:, None]) % 14).long())
    with torch.inference_mode():
        logits = [prefill(params, DIMS, ids, audio, attn_start, kv, st.routes, st.counts, dtype)]
        st.logits.copy_(logits[0])
        st.attn_start.copy_(attn_start)
        st.n_past.copy_(torch.from_numpy(plen))
        for _ in range(3):
            omni_step(params, DIMS, st, kv, 14, dtype, ctx.family)
            logits.append(st.logits.clone())
    got = torch.stack(logits, 1)                                   # [B, 4, V]
    follow = [torch.cat([st.routes[:, b, int(attn_start[b]):14], st.routes[:, b, 14:17]], 1).long() for b in range(2)]
    for b, o in enumerate(_reference(raw, TINY, mel[:2], prompt, plen, st.tokens[:, :4].numpy(), follow=follow)):
        scale = float(o["logits"].abs().max())
        assert float((got[b] - o["logits"]).abs().max()) <= tol * scale
    # counts: each real prompt token and each step, in every layer; the held experts read
    assert st.counts[:, -1].tolist() == [int(plen.sum()) + 2 * 3] * 2
    assert 0 < int(st.read.sum()) <= 3 * DIMS.n_layer * DIMS.n_held


def test_the_expert_shares_add_up_to_the_uncut_layer():
    """Each card's expert layer (its held experts and the zero experts) over
    the same rows: their sum, the zero experts' part counted once, equals
    the reference's layer with every routed expert held."""
    uncut_cfg = dict(TINY, n_routed_experts=8, expert_share={"published": 8, "cards": 1, "rank": 0, "held": [0, 8]})
    raw = draw(TINY, 3, all_experts=True)
    n1 = torch.randn(10, DIMS.d, generator=torch.Generator().manual_seed(1))
    w = _layer(raw)(1)
    want, chosen, _ = ref.moe(n1, w, uncut_cfg, ref.Precision())
    total, zero_part = 0, None
    for held in ((0, 2), (2, 4), (4, 6), (6, 8)):
        cfg = tiny(held=held)
        dims = LongcatDims.from_config(cfg)
        share = {k: v for k, v in raw.items() if ".mlp.experts." not in k
                 or held[0] <= int(k.split(".mlp.experts.")[1].split(".")[0]) < held[1]}
        blk = params_from_tensors(dims, share, F32).blocks[1]
        out, choice = moe_rows(n1, blk, dims, torch.ones(10, dtype=torch.bool), torch.float32)
        assert torch.equal(choice, chosen)
        _, zero, _ = route(n1, blk, dims)
        zero_part = zero[:, None] * n1
        total = total + out
    total = total - 3 * zero_part
    assert float((total - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_the_reference_matches_transformers_longcat_flash():
    """The reference with every expert held against transformers'
    ``LongcatFlashForCausalLM`` at the same weights, f32, on one sequence
    of token ids (no audio). The RoPE tables take ``head_dim`` =
    ``qk_rope_head_dim``."""
    lf = pytest.importorskip("transformers.models.longcat_flash")
    cfg = dict(TINY, n_routed_experts=8, expert_share={"published": 8, "cards": 1, "rank": 0, "held": [0, 8]})
    raw = draw(TINY, 4, all_experts=True)
    hf_cfg = lf.LongcatFlashConfig(
        vocab_size=97, hidden_size=64, num_layers=2, num_attention_heads=4, q_lora_rank=32, kv_lora_rank=16,
        qk_rope_head_dim=8, qk_nope_head_dim=16, v_head_dim=16, head_dim=8, ffn_hidden_size=96,
        expert_ffn_hidden_size=32, n_routed_experts=8, zero_expert_num=4, moe_topk=3, routed_scaling_factor=6.0,
        rms_norm_eps=1e-5, rope_theta=10000000.0, attention_bias=False)
    hf_cfg._attn_implementation = "eager"
    model = lf.LongcatFlashForCausalLM(hf_cfg).eval()
    state = {k: v for k, v in raw.items() if not k.startswith(("model.audio_tower", "model.audio_projector"))}
    missing, unexpected = model.load_state_dict(state, strict=False)
    assert not unexpected and not [k for k in missing if "rotary" not in k], (missing, unexpected)
    ids = torch.tensor(np.random.default_rng(2).integers(0, 96, size=12), dtype=torch.long)
    with torch.no_grad():
        want = model(input_ids=ids[None]).logits[0]
    got = ref.forward(_layer(raw), raw, cfg, [(ids, None, 0)])[0]["logits"]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_absorbed_latent_attention_equals_the_expanded_form():
    """One sublayer's attention of the last of 9 tokens over the latent
    cache: q_nope through kv_b's K half, attention over the latent columns
    (``mla_decode``), then the V half, against kv_b applied to every key
    and value, in f32."""
    params = params_from_tensors(DIMS, draw(TINY, 6), F32)
    blk = params.blocks[0]
    x = torch.randn(1, 9, DIMS.d, generator=torch.Generator().manual_seed(3))
    cos, sin = rope_tables(torch.arange(9)[None], DIMS)
    q_nope, q_rope, cols = _latent(rms_norm(x, blk.ln_in_1, DIMS.rms_eps), blk, 1, DIMS, cos, sin)
    h, dn = DIMS.n_head, DIMS.nope_dim
    kvb = (cols[0, :, : DIMS.kv_rank] @ blk.kv_b_1).view(9, h, dn + DIMS.v_dim)
    scores = (torch.einsum("hd,thd->ht", q_nope[0, -1], kvb[..., :dn])
              + torch.einsum("hd,td->ht", q_rope[0, -1], cols[0, :, DIMS.kv_rank:])) * DIMS.attn_scale
    want = torch.einsum("ht,thd->hd", torch.softmax(scores, -1), kvb[..., dn:])
    q = torch.cat([torch.einsum("hn,hnc->hc", q_nope[0, -1], blk.w_k_1), q_rope[0, -1]], -1)
    one = torch.ones(1, dtype=torch.int32)
    lat = mla_decode(q[None], cols, 0 * one, 9 * one, DIMS.attn_scale, DIMS.kv_rank)[0]
    got = torch.einsum("hc,hnc->hn", lat, blk.w_v_1)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_mla_plain_version_reads_only_the_lanes_own_columns():
    """Columns outside [start, valid) of a lane change nothing."""
    g = torch.Generator().manual_seed(9)
    q, cache = torch.randn(3, 4, 24, generator=g), torch.randn(3, 10, 24, generator=g)
    start, valid = torch.tensor([0, 2, 5], dtype=torch.int32), torch.tensor([10, 7, 6], dtype=torch.int32)
    want = mla_decode_ref(q, cache, start, valid, 0.3, 16)
    poisoned = cache.clone()
    for b in range(3):
        poisoned[b, : int(start[b])] = float("nan")
        poisoned[b, int(valid[b]):] = float("nan")
    assert torch.equal(mla_decode(q, poisoned.nan_to_num(1e4), start, valid, 0.3, 16), want)
    with pytest.raises(ValueError, match="must be int32"):
        mla_decode(q, cache, start.long(), valid, 0.3, 16)


def test_a_zero_expert_alone_adds_its_weight_times_n1():
    """Rows whose router puts the zero experts far ahead choose only them:
    the layer's output is their summed weight (scores times 6) times n1,
    and no held expert is read."""
    params = params_from_tensors(DIMS, draw(TINY, 7), F32)
    blk = params.blocks[0]
    blk.router_w[:, DIMS.n_published:] += 50.0 * blk.router_w[:, :1].sign()
    n1 = blk.router_w[:, :1].sign().T.repeat(5, 1) * torch.rand(5, 1, generator=torch.Generator().manual_seed(2))
    out, choice = moe_rows(n1, blk, DIMS, torch.ones(5, dtype=torch.bool), torch.float32)
    assert (choice >= DIMS.n_published).all()
    scores = torch.softmax(n1 @ blk.router_w, -1)
    weight = scores.gather(1, choice).sum(-1, keepdim=True) * DIMS.routed_scale
    assert torch.allclose(out, weight * n1, rtol=1e-6, atol=0)


def test_routing_ids_past_127_are_recorded_exactly():
    """A router of 300 outputs (200 routed, this card holding 150..153, 100
    zero experts): the window's int16 record holds the reference's own
    choices, ids up to 299, at every position."""
    cfg = tiny(published=200, held=(150, 154), zero=100)
    dims = LongcatDims.from_config(cfg)
    raw = draw(cfg, 11)
    mel = torch.from_numpy(np.random.default_rng(6).normal(size=(2, 80, 40)).astype(np.float32))
    ctx = LongcatContext(params_from_tensors(dims, dict(raw), F32), dims, torch.float32, "cpu",
                         prompt_capacity=16, max_new_tokens=4)
    prompt, plen = _prompts(dims, 3, 2, 16)
    res = ctx.run_window(prompt, plen, ctx.encode_window(mel), force_steps=4)
    assert res.routes.dtype == np.int16 and int(res.routes.max()) > 127
    for b, o in enumerate(_reference(raw, cfg, mel, prompt, plen, res.tokens)):
        cols = [res.attn_start[b] + j for j in range(plen[b])] + [16 + t for t in range(3)]
        assert (o["margins"] == 0).all()
        np.testing.assert_array_equal(np.sort(res.routes[:, b, cols], -1), np.sort(o["routes"].numpy(), -1))


def test_loader_releases_every_raw_tensor_and_refuses_a_missing_one():
    raw = draw(TINY, 12)
    tensors = dict(raw)
    params = params_from_tensors(DIMS, tensors, F32)
    assert not tensors
    # kv_b's halves are views of kv_b's storage, per head
    assert params.blocks[0].w_k_0.data_ptr() == params.blocks[0].kv_b_0.data_ptr()
    del raw["model.layers.1.mlp.experts.3.up_proj.weight"]
    with pytest.raises(ValueError, match="missing tensor"):
        params_from_tensors(DIMS, raw, F32)


def test_a_step_reads_no_host_value_and_writes_its_column(model):
    """The step as the graph runs it: the latent column and the routing at
    the device column, the held experts read counted."""
    raw, _ = model
    params = params_from_tensors(DIMS, dict(raw), F32)
    kv = LongcatContext(params, DIMS, torch.float32, "cpu").self_kv(2)
    st = OmniState.zeros(DIMS, 2, 1, 8, CPU)
    st.routes.fill_(-1)
    with torch.inference_mode():
        step(params, DIMS, torch.tensor([3, 4]), torch.tensor([0, 0], dtype=torch.int32),
             torch.tensor([5, 5], dtype=torch.int32), torch.tensor(5), kv, st.routes, st.counts,
             torch.float32, st.read)
    assert (kv.c[:, :, 5] != 0).all(-1).all() and (kv.c[:, :, :5] == 0).all() and (kv.c[:, :, 6:] == 0).all()
    assert (st.routes[:, :, 5] >= 0).all() and (st.routes[:, :, :5] == -1).all()
    assert st.counts[:, -1].tolist() == [2, 2]

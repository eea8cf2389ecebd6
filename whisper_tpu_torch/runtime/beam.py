"""Beam-search window decode, batched over utterances.

Counterpart of ``whisper_tpu.runtime.beam`` (the reference declares
``eSamplingStrategy::BeamSearch`` but never implements it,
sFullParams.h:12-13):

  - beams compose with the batch dimension: U utterances x ``beam`` lanes
    ride one [U*beam]-lane decode, so the batched scheduler
    (runtime/batch.py) serves beam search with the same decode step
  - the self-attention cache is lane-contiguous [L, U*beam, HD, C]; each
    step reorders by parent lane only the generated columns written so far,
    [p_max, p_max + i) (``model.decoder.reorder_self_kv``): the prompt
    region is the same on every beam of an utterance, column p_max + i is
    written by this step's decode before any query reads it, and later
    columns are masked until written. The JAX package reorders the whole
    region [p_max, p_max + n_max) every step; the tokens are the same.
  - the cross K/V is never broadcast per beam: it stays [L, U, HD, Sx] and
    ``kv_group=beam`` points ``beam`` consecutive query lanes of the
    decode-attention kernel at one shared K/V lane
  - the prompt, the same on every beam of an utterance, is ingested once
    per utterance and its cache columns and logits copied to the beams
    (the JAX package ingests it on all U*beam lanes: ``beam`` times the
    work and, in the einsum's f32 scores, ``beam`` times the memory)
  - per-step token masking is whisper's sampleBest rule set in log space
    (initial-timestamp restriction, sum_ts > max_tx -> text ban, banned
    specials), the same numerics as the greedy path per beam
  - the top ``beam`` candidates over [beam * V] scores per utterance
    (OpenAI BeamSearchDecoder semantics); finished beams only propose EOT
    at unchanged score. Ties go to the lower flat index, as
    ``jax.lax.top_k`` gives them: on the scripted checkpoint thousands of
    candidates tie at log(1e-30), and beams that start at NEG = -1e30 tie
    on every candidate (-1e30 + logp == -1e30 in f32). ``torch.topk``
    promises no order among ties, so the candidates are taken from a
    stable descending sort.
  - winner = best average log-prob among finished beams (all beams if none
    finished), independently per utterance

The token loop is a Python loop over on-device state, like
runtime/decode.py, with one host read per step (are all beams finished?)
in place of ``lax.while_loop``'s condition. The sliding-window and
timestamp-failure rules (ContextImpl.cpp:594-673) are applied on the host
by replaying them over each winning token sequence: they decide how the
window advances, not which tokens are chosen, so the replay is exact.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_tpu_torch.api.params import Flags
from whisper_tpu_torch.hparams import N_FRAMES
from whisper_tpu_torch.model.decoder import decode_step, init_self_kv, reorder_self_kv
from whisper_tpu_torch.runtime.decode import WindowResult
from whisper_tpu_torch.runtime.sampler import SpecialIds

NEG = -1e30


def _masked_logprobs(logits: torch.Tensor, ids: SpecialIds, is_initial: bool):
    """sampleBest's masking rules in log space; also returns (probs, tid,
    pt, ptsum) per lane, computed from the softmax distribution like the
    reference."""
    probs = torch.softmax(logits.float(), dim=-1)                   # [lanes, V]
    logp = torch.log(torch.clamp(probs, min=1e-30))
    v = logits.shape[-1]
    tok = torch.arange(v, device=logits.device)[None, :]

    text_mask = tok < ids.beg
    ts_ok = (tok >= ids.beg) & ((tok <= ids.beg + 100) if is_initial else True)

    max_tx = torch.where(text_mask, probs, 0.0).amax(dim=-1)       # [lanes]
    sum_ts = torch.where(ts_ok, probs, 0.0).sum(dim=-1)
    ts_probs = torch.where(ts_ok, probs, float("-inf"))
    tid = ts_probs.argmax(dim=-1).to(torch.int32)
    max_ts = ts_probs.amax(dim=-1)
    pt = max_ts / (sum_ts + 1e-10)

    take_ts = (sum_ts > max_tx)[:, None] | is_initial              # initial forces ts
    banned = (tok == ids.sot) | (tok == ids.solm) | (tok == ids.not_) | (take_ts & text_mask)
    if is_initial:
        banned = banned | (tok > ids.beg + 100)
    return torch.where(banned, NEG, logp), probs, tid, pt, sum_ts


def _top_k_lower_index_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of ``x``,
    equal values in ascending index order (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


@torch.inference_mode()
def _beam_window(runtime, prompts: torch.Tensor, prompt_lens: torch.Tensor, cross_kv, beam: int,
                 n_max: int, force_steps: int = 0):
    """prompts [U, P] right-padded, prompt_lens [U], cross_kv [L, U, HD, Sx]
    (+ int8 scales). Returns per-utterance winner tensors (tokens, p, pt,
    ptsum, tid: [U, n_max]; length [U]) and the number of steps run.
    ``force_steps > 0`` is a benchmarking mode: exactly that many steps
    run, whether or not every beam has finished."""
    dims, ids, dtype = runtime.dims, runtime.ids, runtime.compute_dtype
    device = prompts.device
    v = dims.n_vocab
    u, p_max = prompts.shape
    lanes = u * beam
    if p_max + n_max > dims.n_text_ctx:
        raise ValueError(
            f"prompt capacity {p_max} + max steps {n_max} exceeds cache length {dims.n_text_ctx}"
        )
    steps = force_steps or n_max
    if steps > n_max:
        raise ValueError(f"force_steps {force_steps} exceeds the step cap {n_max}")

    # --- prompt ingest, left-aligned so the shared write column / last-row
    # logits contract of decode_step holds. The beams of an utterance share
    # their prompt, so it is ingested once per utterance (into a cache of
    # p_max columns) and its columns and logits are copied to the beams;
    # the JAX package ingests it on every beam lane, with the same result. ---
    prompt_lens = prompt_lens.to(torch.int32)
    cols = torch.arange(p_max, device=device)[None, :]
    src = (cols - (p_max - prompt_lens)[:, None]) % p_max                  # roll right
    kv_u = init_self_kv(dims, u, dtype=dtype, device=device, cache_len=p_max,
                        quant=runtime.kv_int8)
    logits_u, kv_u = decode_step(runtime.params, dims, prompts.gather(1, src.long()),
                                 prompt_lens - p_max, kv_u, cross_kv, write_pos=0,
                                 attn_start=p_max - prompt_lens, compute_dtype=dtype)
    kv = init_self_kv(dims, lanes, dtype=dtype, device=device, quant=runtime.kv_int8)
    for a, a_u in zip(kv, kv_u):
        if a is not None:        # [L, U*beam, HD, C] viewed [L, U, beam, HD, C]
            a.view(a.shape[0], u, beam, *a.shape[2:])[..., :p_max].copy_(a_u[:, :, None])
    logits = logits_u.repeat_interleave(beam, dim=0)
    plen_b = prompt_lens.repeat_interleave(beam)                              # [lanes]
    attn_start = p_max - plen_b

    lane_ids = torch.arange(lanes, device=device)
    # only beam 0 of each utterance is live at first (identical lanes would be clones)
    scores = torch.where(lane_ids % beam == 0, 0.0, NEG).to(torch.float32)
    finished = torch.zeros((lanes,), dtype=torch.bool, device=device)
    length = torch.zeros((lanes,), dtype=torch.int32, device=device)
    tokens = torch.zeros((lanes, n_max), dtype=torch.int32, device=device)
    p_arr = torch.zeros((lanes, n_max), dtype=torch.float32, device=device)
    pt_arr = torch.zeros_like(p_arr)
    pts_arr = torch.zeros_like(p_arr)
    tid_arr = torch.zeros_like(tokens)
    eot_only = torch.full((1, v), NEG, dtype=torch.float32, device=device)
    eot_only[0, ids.eot] = 0.0
    utt_base = (torch.arange(u, device=device) * beam)[:, None]

    i = 0
    while i < steps:
        logp, probs, tid, pt, ptsum = _masked_logprobs(logits, ids, i == 0)
        # finished beams: only an EOT self-loop at unchanged score
        logp = torch.where(finished[:, None], eot_only, logp)

        cand = (scores[:, None] + logp).reshape(u, beam * v)
        top_scores, flat_idx = _top_k_lower_index_first(cand, beam)   # [U, beam]
        parent = (utt_base + flat_idx // v).reshape(-1)               # [lanes] global lane
        token = (flat_idx % v).reshape(-1).to(torch.int32)
        scores = top_scores.reshape(-1)

        reorder_self_kv(kv, parent, p_max, i)
        tokens, p_arr, pt_arr, pts_arr, tid_arr = (
            a.index_select(0, parent) for a in (tokens, p_arr, pt_arr, pts_arr, tid_arr))
        finished = finished[parent]
        length = length[parent]

        rec = ~finished
        tokens[:, i] = torch.where(rec, token, tokens[:, i])
        p_arr[:, i] = torch.where(rec, probs[parent, token.long()], 0.0)
        pt_arr[:, i] = torch.where(rec, pt[parent], 0.0)
        pts_arr[:, i] = torch.where(rec, ptsum[parent], 0.0)
        tid_arr[:, i] = torch.where(rec, tid[parent], 0)
        length = torch.where(rec, i + 1, length).to(torch.int32)
        finished = finished | (token == ids.eot)

        # every lane sits at the shared cache column p_max + i; its real
        # position is its prompt length + i (finished lanes included)
        logits, kv = decode_step(runtime.params, dims, token[:, None], plen_b + i, kv, cross_kv,
                                 write_pos=p_max + i, attn_start=attn_start, compute_dtype=dtype,
                                 cross_group=beam)
        i += 1
        if not force_steps and bool(finished.all()):
            break

    # winner per utterance: best average log-prob; finished beams strongly
    # preferred when any exist. argmax takes the first maximum, as jnp's does.
    norm = (scores / length.clamp(min=1)).reshape(u, beam)
    fin = finished.reshape(u, beam)
    pref = torch.where(fin, norm, norm - 1e4)
    best = torch.where(fin.any(dim=1, keepdim=True), pref, norm).argmax(dim=1)
    sel = utt_base[:, 0] + best
    return (tokens[sel], p_arr[sel], pt_arr[sel], pts_arr[sel], tid_arr[sel], length[sel]), i


def _replay_window_rules(tokens, ids: SpecialIds, seek, seek_end, n_max, max_tokens,
                         single_segment):
    """Host replay of ContextImpl.cpp:594-673 over a fixed token sequence."""
    chunk = N_FRAMES
    seek_delta = chunk
    result_len = 0
    has_ts = False
    failed = False
    kept = 0
    for i, tok in enumerate(tokens):
        tok = int(tok)
        if tok > ids.beg:
            sd_new = 2 * (tok - ids.beg)
            if has_ts and seek_delta > sd_new and result_len < i:
                break
            seek_delta = sd_new
            result_len = i + 1
            has_ts = True
        kept = i + 1
        eoa = seek + seek_delta + 100 >= seek_end
        if tok == ids.eot or (max_tokens > 0 and i >= max_tokens) or (has_ts and eoa):
            if result_len == 0:
                if eoa:
                    result_len = i + 1
                else:
                    failed = True
                    break
            if single_segment:
                result_len = i + 1
                seek_delta = chunk
            break
        if i == n_max - 1 and (result_len == 0 or seek_delta < chunk // 2):
            failed = True
            break
    else:
        if kept and (result_len == 0 or seek_delta < chunk // 2):
            failed = True
    return result_len, seek_delta, failed


def decode_window_beam(runtime, params, prompt, prompt_len, cross_kv, seek, seek_end,
                       force_steps: int = 0) -> WindowResult:
    """Entry point shared by Context (U=1) and BatchTranscriber (U=batch):
    a WindowResult with one row per utterance, like the greedy
    ``WhisperRuntime.run_window`` (tokens and probabilities on the
    runtime's device, the replayed window rules on the host).
    ``force_steps`` is the benchmarking mode of ``_beam_window``."""
    beam = int(params.beam_width)
    n_max = runtime.n_max_steps

    prompts = np.atleast_2d(np.asarray(prompt, np.int32))
    u = prompts.shape[0]
    plens = np.broadcast_to(np.asarray(prompt_len, np.int32).reshape(-1), (u,))
    seeks = np.broadcast_to(np.asarray(seek, np.int64).reshape(-1), (u,))
    ends = np.broadcast_to(np.asarray(seek_end, np.int64).reshape(-1), (u,))

    (tokens, p, pt, ptsum, tid, length), steps = _beam_window(
        runtime, torch.as_tensor(prompts, dtype=torch.int32, device=runtime.device),
        torch.as_tensor(plens.copy(), dtype=torch.int32, device=runtime.device),
        cross_kv, beam, n_max, force_steps)
    tokens_h, length_h = tokens.cpu().numpy(), length.cpu().numpy()

    result_len = np.zeros((u,), np.int32)
    seek_delta = np.zeros((u,), np.int32)
    failed = np.zeros((u,), bool)
    for uu in range(u):
        result_len[uu], seek_delta[uu], failed[uu] = _replay_window_rules(
            tokens_h[uu][: int(length_h[uu])], runtime.ids, int(seeks[uu]), int(ends[uu]), n_max,
            int(params.max_tokens), params.flag(Flags.SINGLE_SEGMENT),
        )

    return WindowResult(
        tokens=tokens, p=p, pt=pt, ptsum=ptsum, tid=tid,
        result_len=torch.from_numpy(result_len),
        seek_delta=torch.from_numpy(seek_delta),
        failed=torch.from_numpy(failed),
        steps=torch.tensor(steps, dtype=torch.int32),
    )

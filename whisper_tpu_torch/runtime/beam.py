"""Beam-search window decode, batched over utterances.

Counterpart of ``whisper_tpu.runtime.beam`` (the reference declares
``eSamplingStrategy::BeamSearch`` but never implements it,
sFullParams.h:12-13):

  - beams compose with the batch dimension: U utterances x ``beam`` lanes
    ride one [U*beam]-lane decode, so the batched scheduler
    (runtime/batch.py) serves beam search with the same decode step
  - the self-attention cache is lane-contiguous [L, U*beam, HD, C]; step i
    reorders by parent lane the generated columns [p_max, p_max + n) with
    n = ``REORDER_COLUMNS`` * (i // ``REORDER_COLUMNS`` + 1), at most
    n_max (``model.decoder.reorder_self_kv``): every column written so
    far, [p_max, p_max + i), and at most ``REORDER_COLUMNS`` unwritten
    (zero) ones. The prompt region is the same on every beam of an
    utterance, column p_max + i is written by this step's decode before any
    query reads it, and later columns are masked until written. A captured
    step cannot size the range by a device counter, so there is one graph
    per range; the JAX package reorders the whole region
    [p_max, p_max + n_max) every step. The tokens are the same.
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

One token step (``beam_step``) reads and writes tensors on the device alone
(its counter ``i`` is a device scalar, as in runtime/decode.py), so on the
card the runtime replays it as a CUDA graph (runtime/graph.py), and the
host reads one flag per step (are all beams finished?), one step behind
when it replays, in place of ``lax.while_loop``'s condition. The sliding-window and
timestamp-failure rules (ContextImpl.cpp:594-673) are applied on the host
by replaying them over each winning token sequence: they decide how the
window advances, not which tokens are chosen, so the replay is exact.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from whisper_tpu_torch.api.params import Flags
from whisper_tpu_torch.hparams import N_FRAMES
from whisper_tpu_torch.model.decoder import SelfKV, decode_step, init_self_kv, reorder_self_kv
from whisper_tpu_torch.obs.profiler import TRACER
from whisper_tpu_torch.runtime.decode import WindowResult, check_cache_room, ingest_prompt, run_steps
from whisper_tpu_torch.runtime.sampler import SpecialIds

NEG = -1e30
REORDER_COLUMNS = 32     # generated cache columns a captured step reorders, per range


def _masked_logprobs(logits: torch.Tensor, ids: SpecialIds, is_initial):
    """sampleBest's masking rules in log space; also returns (probs, tid,
    pt, ptsum) per lane, computed from the softmax distribution like the
    reference. ``is_initial``: a bool, or a bool tensor on the logits'
    device (the token loop's ``i == 0``)."""
    probs = torch.softmax(logits.float(), dim=-1)                   # [lanes, V]
    logp = torch.log(torch.clamp(probs, min=1e-30))
    v = logits.shape[-1]
    tok = torch.arange(v, device=logits.device)[None, :]
    first = torch.as_tensor(is_initial, device=logits.device)

    text_mask = tok < ids.beg
    ts_ok = (tok >= ids.beg) & ((tok <= ids.beg + 100) | ~first)

    max_tx = torch.where(text_mask, probs, 0.0).amax(dim=-1)       # [lanes]
    sum_ts = torch.where(ts_ok, probs, 0.0).sum(dim=-1)
    ts_probs = torch.where(ts_ok, probs, float("-inf"))
    tid = ts_probs.argmax(dim=-1).to(torch.int32)
    max_ts = ts_probs.amax(dim=-1)
    pt = max_ts / (sum_ts + 1e-10)

    take_ts = (sum_ts > max_tx)[:, None] | first                   # initial forces ts
    banned = ((tok == ids.sot) | (tok == ids.solm) | (tok == ids.not_) | (take_ts & text_mask)
              | (first & (tok > ids.beg + 100)))
    return torch.where(banned, NEG, logp), probs, tid, pt, sum_ts


def _top_k_lower_index_first(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row of ``x``,
    equal values in ascending index order (``jax.lax.top_k``'s order)."""
    values, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[:, :k], idx[:, :k]


def reorder_columns(i: int, n_max: int) -> int:
    """The generated columns step ``i`` reorders: whole ranges of
    ``REORDER_COLUMNS`` covering [0, i), at most n_max."""
    return min(n_max, REORDER_COLUMNS * (i // REORDER_COLUMNS + 1))


class BeamState(NamedTuple):
    """The beam loop's state and its per-window inputs, [lanes = U * beam]:
    tensors on the device that ``beam_step`` reads and updates in place."""

    i: torch.Tensor           # [] int32 step counter
    stop: torch.Tensor        # [] bool: every beam finished
    logits: torch.Tensor      # [lanes, V] f32
    scores: torch.Tensor      # [lanes] f32 summed log-probs
    finished: torch.Tensor    # [lanes] bool
    length: torch.Tensor      # [lanes] int32
    tokens: torch.Tensor      # [lanes, n_max] int32
    p: torch.Tensor           # [lanes, n_max] f32
    pt: torch.Tensor          # [lanes, n_max] f32
    ptsum: torch.Tensor       # [lanes, n_max] f32
    tid: torch.Tensor         # [lanes, n_max] int32
    plen: torch.Tensor        # [lanes] int32 input: prompt length
    attn_start: torch.Tensor  # [lanes] int32 input: first valid cache column

    @staticmethod
    def zeros(lanes: int, n_max: int, n_vocab: int, device) -> "BeamState":
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        f32 = torch.float32
        return BeamState(
            i=z(), stop=z(dtype=torch.bool), logits=z(lanes, n_vocab, dtype=f32),
            scores=z(lanes, dtype=f32), finished=z(lanes, dtype=torch.bool), length=z(lanes),
            tokens=z(lanes, n_max), p=z(lanes, n_max, dtype=f32), pt=z(lanes, n_max, dtype=f32),
            ptsum=z(lanes, n_max, dtype=f32), tid=z(lanes, n_max), plen=z(lanes),
            attn_start=z(lanes),
        )


def beam_step(runtime, st: BeamState, kv: SelfKV, cross_kv, p_max: int, beam: int,
              n_cols: int) -> None:
    """One beam step, in place on ``st`` and ``kv``: mask, take the top
    ``beam`` candidates of each utterance, reorder the state and the
    generated cache columns [p_max, p_max + n_cols) by parent lane, record
    the tokens at column ``st.i`` and feed them to the decoder at cache
    column ``p_max + st.i``. Every value that changes from step to step is
    a device tensor; ``p_max``, ``beam`` and ``n_cols`` are constants.
    A step after every beam finished (the one a read behind lets run)
    changes nothing the window returns: it keeps every lane as its own
    parent and its score (else finished beams would be re-sorted by
    score), and a finished lane records nothing."""
    ids = runtime.ids
    i = st.i
    col = i.view(1).long()
    lanes, v = st.logits.shape
    u = lanes // beam
    logp, probs, tid, pt, ptsum = _masked_logprobs(st.logits, ids, i == 0)
    # finished beams: only an EOT self-loop at unchanged score
    tok = torch.arange(v, device=logp.device)
    logp = torch.where(st.finished[:, None], torch.where(tok == ids.eot, 0.0, NEG)[None, :], logp)

    cand = (st.scores[:, None] + logp).reshape(u, beam * v)
    top_scores, flat_idx = _top_k_lower_index_first(cand, beam)   # [U, beam]
    utt_base = (torch.arange(u, device=logp.device) * beam)[:, None]
    parent = (utt_base + flat_idx // v).reshape(-1)               # [lanes] global lane
    token = (flat_idx % v).reshape(-1).to(torch.int32)
    parent = torch.where(st.stop, torch.arange(lanes, device=logp.device), parent)
    scores = torch.where(st.stop, st.scores, top_scores.reshape(-1))

    reorder_self_kv(kv, parent, p_max, n_cols)
    for a in (st.tokens, st.p, st.pt, st.ptsum, st.tid):
        a.copy_(a.index_select(0, parent))
    finished = st.finished[parent]
    rec = ~finished
    for arr, val, other in ((st.tokens, token, st.tokens.index_select(1, col)[:, 0]),
                            (st.p, probs[parent, token.long()], 0.0), (st.pt, pt[parent], 0.0),
                            (st.ptsum, ptsum[parent], 0.0), (st.tid, tid[parent], 0)):
        arr.index_copy_(1, col, torch.where(rec, val, other)[:, None])
    length = torch.where(rec, i + 1, st.length[parent])
    finished = finished | (token == ids.eot)

    # every lane sits at the shared cache column p_max + i; its real
    # position is its prompt length + i (finished lanes included)
    logits, _ = decode_step(runtime.params, runtime.dims, token[:, None], st.plen + i, kv, cross_kv,
                            write_pos=p_max + i, attn_start=st.attn_start,
                            compute_dtype=runtime.compute_dtype, cross_group=beam)
    st.logits.copy_(logits)
    st.scores.copy_(scores)
    st.finished.copy_(finished)
    st.length.copy_(length)
    st.stop.copy_(finished.all())
    i.add_(1)


@torch.inference_mode()
def _beam_window(runtime, prompts: torch.Tensor, prompt_lens: torch.Tensor, cross_kv, beam: int,
                 n_max: int, force_steps: int = 0):
    """prompts [U, P] right-padded, prompt_lens [U], cross_kv [L, U, HD, Sx]
    (+ int8 scales). Returns per-utterance winner tensors (tokens, p, pt,
    ptsum, tid: [U, n_max]; length [U]) and the number of steps run.
    ``force_steps > 0`` is a benchmarking mode: exactly that many steps
    run, whether or not every beam has finished. On the card with
    ``runtime.cuda_graphs`` the steps are replayed graphs over the
    runtime's tensors for this shape; else ``beam_step`` runs eagerly over
    tensors of this window."""
    dims = runtime.dims
    device = prompts.device
    u, p_max = prompts.shape
    lanes = u * beam
    check_cache_room(p_max, n_max, dims.n_text_ctx)
    limit = force_steps or n_max
    if limit > n_max:
        raise ValueError(f"force_steps {force_steps} exceeds the step cap {n_max}")

    def state():
        return BeamState.zeros(lanes, n_max, dims.n_vocab, device)

    with runtime.graphs.lock:
        if runtime.replays:
            slot = runtime.slot("beam", state, lanes, p_max, cross_kv)
            st, kv, cross = slot.state, slot.kv, slot.cross
            graphs = {}
            for n in sorted({reorder_columns(i, n_max) for i in range(limit)}):
                graphs[n] = slot.step(("beam", n), lambda n=n: beam_step(
                    runtime, st, kv, cross, p_max, beam, n))
            slot.load(cross_kv)

            def step(i):
                graphs[reorder_columns(i, n_max)]()
        else:
            st, kv, cross = state(), runtime.self_kv(lanes), cross_kv

            def step(i):
                beam_step(runtime, st, kv, cross, p_max, beam, reorder_columns(i, n_max))

        # --- prompt ingest. The beams of an utterance share their prompt, so
        # it is ingested once per utterance (into a cache of p_max columns)
        # and its columns and logits are copied to the beams; the JAX
        # package ingests it on every beam lane, with the same result. ---
        with TRACER.span("ingest", device=device):
            kv_u = init_self_kv(dims, u, dtype=runtime.compute_dtype, device=device, cache_len=p_max,
                                quant=runtime.kv_int8, tp=runtime.params.tp)
            logits_u, attn_u = ingest_prompt(runtime.params, dims, prompts, prompt_lens, kv_u, cross,
                                             runtime.compute_dtype)
            for a, a_u in zip(kv, kv_u):
                if a is not None:        # [L, U*beam, HD, C] viewed [L, U, beam, HD, C]
                    a.view(a.shape[0], u, beam, *a.shape[2:])[..., :p_max].copy_(a_u[:, :, None])
            for a in (st.i, st.stop, st.finished, st.length, st.tokens, st.p, st.pt, st.ptsum, st.tid):
                a.zero_()
            st.logits.copy_(logits_u.repeat_interleave(beam, dim=0))
            st.plen.copy_(prompt_lens.repeat_interleave(beam))
            st.attn_start.copy_(attn_u.repeat_interleave(beam))
            # only beam 0 of each utterance is live at first (identical lanes would be clones)
            lane_ids = torch.arange(lanes, device=device)
            st.scores.copy_(torch.where(lane_ids % beam == 0, 0.0, NEG))

        steps = run_steps(step, st.stop, limit, force_steps, behind=runtime.replays)

        # winner per utterance: best average log-prob; finished beams strongly
        # preferred when any exist. argmax takes the first maximum, as jnp's does.
        norm = (st.scores / st.length.clamp(min=1)).reshape(u, beam)
        fin = st.finished.reshape(u, beam)
        pref = torch.where(fin, norm, norm - 1e4)
        best = torch.where(fin.any(dim=1, keepdim=True), pref, norm).argmax(dim=1)
        sel = torch.arange(u, device=device) * beam + best
        return (st.tokens[sel], st.p[sel], st.pt[sel], st.ptsum[sel], st.tid[sel],
                st.length[sel]), steps


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
    with TRACER.span("decode", device=runtime.device):
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

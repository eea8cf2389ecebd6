"""The 30 s-window decode loop.

Counterpart of ``whisper_tpu.runtime.decode``. The JAX package runs the
whole token loop on device inside ``lax.while_loop``. Here the loop is a
Python loop over on-device state tensors: every step's sampling, timestamp
and termination rules are masked lane updates on the card, and the host
reads one flag per step (are all lanes done?) to decide whether to go on.
That read is the loop's only per-step sync; under ``force_steps`` the stop
step is known in advance, so there is none. Capturing the step as a CUDA
graph that reads ``done`` only every few steps is later work.

Rule set (ContextImpl.cpp:594-673), as in the JAX package:
  - timestamp token (id > beg): new seek_delta = 2*(id-beg); "do not go back
    in time" break when has_ts && seek_delta shrinks && result_len < i
  - EOT / max_tokens / end-of-audio terminate the lane; if no timestamp was
    ever accepted: end-of-audio keeps the tail (result_len = i+1), otherwise
    the lane is marked failed (host advances seek by +1 s)
  - at the step cap (n_text_ctx/2 - 4): repetition failure when no usable
    timestamp progress was made (result_len==0 or seek_delta < 1500)
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from whisper_tpu_torch.hparams import N_FRAMES, ModelDims
from whisper_tpu_torch.model.decoder import SelfKV, decode_step
from whisper_tpu_torch.model.params import WhisperParams
from whisper_tpu_torch.runtime.sampler import SpecialIds, sample_best


class WindowResult(NamedTuple):
    tokens: torch.Tensor      # [B, n_max] int32 (valid up to result_len)
    p: torch.Tensor           # [B, n_max] f32
    pt: torch.Tensor          # [B, n_max] f32
    ptsum: torch.Tensor       # [B, n_max] f32
    tid: torch.Tensor         # [B, n_max] int32
    result_len: torch.Tensor  # [B] int32
    seek_delta: torch.Tensor  # [B] int32 (mel frames)
    failed: torch.Tensor      # [B] bool
    steps: torch.Tensor       # [] int32: loop iterations executed


def decode_window(
    params: WhisperParams,
    dims: ModelDims,
    ids: SpecialIds,
    prompt: torch.Tensor,       # [B, P] int32, right-padded
    prompt_len: torch.Tensor,   # [B] int32 true lengths (>= 1)
    self_kv: SelfKV,
    cross_kv,
    seek: torch.Tensor,         # [B] int32, mel-frame position of this window
    seek_end: torch.Tensor,     # [B] int32, mel-frame end of audio
    max_tokens: int = 0,
    single_segment: bool = False,
    compute_dtype: torch.dtype = torch.bfloat16,
    force_steps: int = 0,
) -> WindowResult:
    """``force_steps > 0`` is a benchmarking mode: termination rules are
    bypassed and exactly that many decode steps run."""
    b, p_max = prompt.shape
    device = prompt.device
    n_max = dims.n_text_ctx // 2 - 4
    # cache headroom: the last write lands at column p_max + n_max - 1
    if p_max + n_max > dims.n_text_ctx:
        raise ValueError(
            f"prompt capacity {p_max} + max steps {n_max} exceeds cache length {dims.n_text_ctx}"
        )
    chunk_frames = N_FRAMES

    # ---- prompt ingest: left-align the right-padded prompt so every lane's
    # last real token sits at column p_max-1 (one shared write column) ----
    prompt_len = prompt_len.to(torch.int32)
    attn_start = p_max - prompt_len                                      # [B]
    cols = torch.arange(p_max, device=device)[None, :]
    src = (cols - attn_start[:, None]) % p_max                           # roll right
    prompt = prompt.gather(1, src.long())
    logits, kv = decode_step(
        params, dims, prompt, prompt_len - p_max, self_kv, cross_kv,
        write_pos=0, attn_start=attn_start, compute_dtype=compute_dtype,
    )

    n_past = prompt_len.clone()
    tokens = torch.zeros((b, n_max), dtype=torch.int32, device=device)
    p_arr = torch.zeros((b, n_max), dtype=torch.float32, device=device)
    pt_arr = torch.zeros_like(p_arr)
    pts_arr = torch.zeros_like(p_arr)
    tid_arr = torch.zeros_like(tokens)
    seek_delta = torch.full((b,), chunk_frames, dtype=torch.int32, device=device)
    result_len = torch.zeros((b,), dtype=torch.int32, device=device)
    has_ts = torch.zeros((b,), dtype=torch.bool, device=device)
    failed = torch.zeros((b,), dtype=torch.bool, device=device)
    done = torch.zeros((b,), dtype=torch.bool, device=device)

    i = 0
    while i < n_max:
        active = ~done
        probs = torch.softmax(logits, dim=-1)
        out = sample_best(probs, ids, is_initial=(i == 0), force_timestamp=(i == 0))

        # --- timestamp sliding-window rules ---
        is_ts = out.id > ids.beg
        sd_new = 2 * (out.id - ids.beg)
        go_back = is_ts & has_ts & (seek_delta > sd_new) & (result_len < i) & active
        upd = is_ts & ~go_back & active
        seek_delta = torch.where(upd, sd_new, seek_delta)
        result_len = torch.where(upd, i + 1, result_len).to(torch.int32)
        has_ts = has_ts | upd

        # --- record the sampled token (not on break/done lanes) ---
        rec = active & ~go_back
        tokens[:, i] = torch.where(rec, out.id, 0)
        p_arr[:, i] = torch.where(rec, out.p, 0.0)
        pt_arr[:, i] = torch.where(rec, out.pt, 0.0)
        pts_arr[:, i] = torch.where(rec, out.ptsum, 0.0)
        tid_arr[:, i] = torch.where(rec, out.tid, 0)

        # --- termination rules ---
        end_of_audio = seek + seek_delta + 100 >= seek_end
        eot_cond = (out.id == ids.eot) | (has_ts & end_of_audio)
        if max_tokens > 0 and i >= max_tokens:
            eot_cond = torch.ones_like(eot_cond)
        end_here = rec & eot_cond

        rl0 = result_len == 0
        result_len = torch.where(end_here & rl0 & end_of_audio, i + 1, result_len).to(torch.int32)
        failed = failed | (end_here & rl0 & ~end_of_audio)
        if single_segment:
            result_len = torch.where(end_here, i + 1, result_len).to(torch.int32)
            seek_delta = torch.where(end_here, chunk_frames, seek_delta)

        done = done | go_back | end_here

        # --- repetition-loop failure at the step cap ---
        if i == n_max - 1:
            failed = failed | (~done & ((result_len == 0) | (seek_delta < chunk_frames // 2)))

        if force_steps > 0:  # bench mode: fixed-length decode
            done = torch.full_like(done, i + 1 >= force_steps)
            failed = torch.zeros_like(failed)
            result_len = torch.where(done, i + 1, result_len).to(torch.int32)

        # --- decode the next token (all lanes at the shared cache column
        # p_max+i; frozen lanes ignore the result) ---
        logits, kv = decode_step(
            params, dims, out.id[:, None], n_past, kv, cross_kv,
            write_pos=p_max + i, attn_start=attn_start, compute_dtype=compute_dtype,
        )
        n_past = torch.where(rec, n_past + 1, n_past)
        i += 1

        if (i >= force_steps) if force_steps > 0 else bool(done.all()):
            break

    return WindowResult(
        tokens=tokens, p=p_arr, pt=pt_arr, ptsum=pts_arr, tid=tid_arr,
        result_len=result_len, seek_delta=seek_delta.to(torch.int32), failed=failed,
        steps=torch.tensor(i, dtype=torch.int32),
    )

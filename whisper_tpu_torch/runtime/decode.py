"""The 30 s-window decode loop.

Counterpart of ``whisper_tpu.runtime.decode``. The JAX package runs the
whole token loop on device inside ``lax.while_loop``. Here one token step
(``greedy_step``) is a function of tensors on the device alone: the loop
counter ``i`` is a device int32 scalar in the loop state (``GreedyState``),
every rule that reads it reads that tensor, the sampled token's column is
written by ``index_copy_`` at ``i``, and the new K/V column at the device
column ``p_max + i``. The step makes no host read and no host-to-device
copy, so on the card the runtime captures it once as a CUDA graph and
replays it (``runtime/graph.py``); on the CPU, and on the card when graphs
are turned off, the same function runs step by step. The host reads one
flag per step (``stop``: are all lanes done?) to decide whether to go on,
one step behind when it replays (``run_steps``); under ``force_steps``
the stop step is known in advance, so there is none.
The step count is never past ``n_max``, so no step writes past column
``p_max + n_max - 1``, which the loop checks against the cache length once,
before its first step.

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

from typing import Callable, NamedTuple

import torch

from whisper_tpu_torch.hparams import N_FRAMES, ModelDims
from whisper_tpu_torch.model.decoder import SelfKV, decode_step
from whisper_tpu_torch.model.params import WhisperParams
from whisper_tpu_torch.obs.profiler import TRACER
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


class GreedyState(NamedTuple):
    """The greedy loop's state and its per-window inputs: tensors on the
    device that ``greedy_step`` reads and updates in place."""

    i: torch.Tensor           # [] int32 step counter
    stop: torch.Tensor        # [] bool: every lane done
    logits: torch.Tensor      # [B, V] f32 logits of the last token fed
    n_past: torch.Tensor      # [B] int32 real position of the next token
    tokens: torch.Tensor      # [B, n_max] int32
    p: torch.Tensor           # [B, n_max] f32
    pt: torch.Tensor          # [B, n_max] f32
    ptsum: torch.Tensor       # [B, n_max] f32
    tid: torch.Tensor         # [B, n_max] int32
    seek_delta: torch.Tensor  # [B] int32
    result_len: torch.Tensor  # [B] int32
    has_ts: torch.Tensor      # [B] bool
    failed: torch.Tensor      # [B] bool
    done: torch.Tensor        # [B] bool
    attn_start: torch.Tensor  # [B] int32 input: first valid cache column
    seek: torch.Tensor        # [B] int32 input
    seek_end: torch.Tensor    # [B] int32 input

    @staticmethod
    def zeros(b: int, n_max: int, n_vocab: int, device) -> "GreedyState":
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        f32, bool_ = torch.float32, torch.bool
        return GreedyState(
            i=z(), stop=z(dtype=bool_), logits=z(b, n_vocab, dtype=f32), n_past=z(b),
            tokens=z(b, n_max), p=z(b, n_max, dtype=f32), pt=z(b, n_max, dtype=f32),
            ptsum=z(b, n_max, dtype=f32), tid=z(b, n_max), seek_delta=z(b), result_len=z(b),
            has_ts=z(b, dtype=bool_), failed=z(b, dtype=bool_), done=z(b, dtype=bool_),
            attn_start=z(b), seek=z(b), seek_end=z(b),
        )


def greedy_step(
    params: WhisperParams,
    dims: ModelDims,
    ids: SpecialIds,
    st: GreedyState,
    kv: SelfKV,
    cross_kv,
    p_max: int,
    max_tokens: int,
    single_segment: bool,
    force_steps: int,
    compute_dtype: torch.dtype,
) -> None:
    """One token step, in place on ``st`` and ``kv``: sample from
    ``st.logits``, apply the window rules, record the token at column
    ``st.i``, feed it to the decoder at cache column ``p_max + st.i``.
    Every value that changes from step to step is a device tensor;
    ``p_max``, ``max_tokens``, ``single_segment`` and ``force_steps`` are
    constants of the loop. A step after every lane is done (the one a read
    behind lets run) changes nothing the window returns: no lane is active,
    so no rule fires and every recorded column keeps its zero."""
    n_max = st.tokens.shape[1]
    chunk_frames = N_FRAMES
    i = st.i
    col = i.view(1).long()
    first = i == 0
    active = ~st.done
    probs = torch.softmax(st.logits, dim=-1)
    out = sample_best(probs, ids, is_initial=first, force_timestamp=first)

    # --- timestamp sliding-window rules ---
    is_ts = out.id > ids.beg
    sd_new = 2 * (out.id - ids.beg)
    go_back = is_ts & st.has_ts & (st.seek_delta > sd_new) & (st.result_len < i) & active
    upd = is_ts & ~go_back & active
    seek_delta = torch.where(upd, sd_new, st.seek_delta)
    result_len = torch.where(upd, i + 1, st.result_len)
    has_ts = st.has_ts | upd

    # --- record the sampled token (not on break/done lanes) ---
    rec = active & ~go_back
    for arr, val, zero in ((st.tokens, out.id, 0), (st.p, out.p, 0.0), (st.pt, out.pt, 0.0),
                           (st.ptsum, out.ptsum, 0.0), (st.tid, out.tid, 0)):
        arr.index_copy_(1, col, torch.where(rec, val, zero)[:, None])

    # --- termination rules ---
    end_of_audio = st.seek + seek_delta + 100 >= st.seek_end
    eot_cond = (out.id == ids.eot) | (has_ts & end_of_audio)
    if max_tokens > 0:
        eot_cond = eot_cond | (i >= max_tokens)
    end_here = rec & eot_cond

    rl0 = result_len == 0
    result_len = torch.where(end_here & rl0 & end_of_audio, i + 1, result_len)
    failed = st.failed | (end_here & rl0 & ~end_of_audio)
    if single_segment:
        result_len = torch.where(end_here, i + 1, result_len)
        seek_delta = torch.where(end_here, chunk_frames, seek_delta)

    done = st.done | go_back | end_here

    # --- repetition-loop failure at the step cap ---
    failed = failed | ((i == n_max - 1) & ~done
                       & ((result_len == 0) | (seek_delta < chunk_frames // 2)))

    if force_steps > 0:  # bench mode: fixed-length decode
        done = (i + 1 >= force_steps).expand_as(done)
        failed = torch.zeros_like(failed)
        result_len = torch.where(done, i + 1, result_len)

    # --- decode the next token (all lanes at the shared cache column
    # p_max+i; frozen lanes ignore the result) ---
    logits, _ = decode_step(
        params, dims, out.id[:, None], st.n_past, kv, cross_kv,
        write_pos=p_max + i, attn_start=st.attn_start, compute_dtype=compute_dtype,
    )
    st.logits.copy_(logits)
    st.n_past.copy_(torch.where(rec, st.n_past + 1, st.n_past))
    st.seek_delta.copy_(seek_delta)
    st.result_len.copy_(result_len)
    st.has_ts.copy_(has_ts)
    st.failed.copy_(failed)
    st.done.copy_(done)
    st.stop.copy_(done.all())
    i.add_(1)


def check_cache_room(p_max: int, n_max: int, cache_len: int) -> None:
    """The loops' one range check of the cache columns they write: the
    last step writes column p_max + n_max - 1."""
    if p_max + n_max > cache_len:
        raise ValueError(
            f"prompt capacity {p_max} + max steps {n_max} exceeds cache length {cache_len}"
        )


def run_steps(step: Callable[[int], None], stop: torch.Tensor, limit: int, force_steps: int,
              behind: bool = False) -> int:
    """Runs ``step(i)`` for i = 0, 1, ... until ``stop`` is set after a
    step, or ``limit`` steps; under ``force_steps`` exactly ``limit`` steps,
    with no read. Returns the steps run up to the one that set ``stop``.

    The flag is read after every step, or with ``behind`` one step late:
    step i's flag goes to pinned host memory by an asynchronous copy, and
    the host waits for it only once step i + 1 is queued, so the card
    never idles while the host launches. The step after the one that set
    ``stop`` then runs too, and must change nothing that the window
    returns. No step past ``limit`` is launched.

    The loop is the span ``steps``, whose units are the steps launched,
    the one behind the stop flag included."""
    with TRACER.span("steps", device=stop.device) as span:
        n = _launch_steps(step, stop, limit, force_steps, behind)
        span.units = min(n + 1, limit) if behind and not force_steps else n
    return n


def _launch_steps(step, stop: torch.Tensor, limit: int, force_steps: int, behind: bool) -> int:
    if force_steps:
        for i in range(limit):
            step(i)
        return limit
    if not behind:
        for i in range(limit):
            step(i)
            if bool(stop):
                return i + 1
        return limit
    flags = [torch.zeros((), dtype=torch.bool, pin_memory=True) for _ in range(2)]
    last = None                     # (flag, event) of the step before the one just queued
    for i in range(limit):
        step(i)
        flag = flags[i % 2]
        flag.copy_(stop, non_blocking=True)
        done = torch.cuda.Event()
        done.record()
        if last is not None:
            last[1].synchronize()
            if bool(last[0]):
                return i            # step i - 1 set the flag; step i changed nothing
        last = (flag, done)
    return limit


def ingest_prompt(params, dims, prompt: torch.Tensor, prompt_len: torch.Tensor, kv: SelfKV, cross_kv,
                  compute_dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """Prompt ingest, eagerly, into cache columns [0, P): the right-padded
    prompt [B, P] is left-aligned so every lane's last real token sits at
    column P-1 (one shared write column for the steps after it). Returns
    (logits [B, V], attn_start [B])."""
    p_max = prompt.shape[1]
    prompt_len = prompt_len.to(torch.int32)
    attn_start = p_max - prompt_len                                      # [B]
    cols = torch.arange(p_max, device=prompt.device)[None, :]
    src = (cols - attn_start[:, None]) % p_max                           # roll right
    logits, _ = decode_step(
        params, dims, prompt.gather(1, src.long()), prompt_len - p_max, kv, cross_kv,
        write_pos=0, attn_start=attn_start, compute_dtype=compute_dtype,
    )
    return logits, attn_start


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
    state: GreedyState | None = None,
    step: Callable[[int], None] | None = None,
) -> WindowResult:
    """``force_steps > 0`` is a benchmarking mode: termination rules are
    bypassed and exactly that many decode steps run.

    ``self_kv`` (zeroed) and ``cross_kv`` are the caches the steps read.
    By default the window allocates its state and runs ``greedy_step``
    directly. A caller that replays a captured step passes the ``state``
    that step reads (zeros of the window's shape, or a previous window's:
    every field is reset here) and ``step``, called with the host's step
    index; the flag of a replayed step is read one step behind
    (``run_steps``)."""
    b, p_max = prompt.shape
    n_max = dims.n_text_ctx // 2 - 4
    check_cache_room(p_max, n_max, self_kv.k.shape[-1])

    with TRACER.span("ingest", device=prompt.device):
        logits, attn_start = ingest_prompt(params, dims, prompt, prompt_len, self_kv, cross_kv,
                                           compute_dtype)
        st = GreedyState.zeros(b, n_max, logits.shape[-1], prompt.device) if state is None else state
        for a in (st.i, st.stop, st.tokens, st.p, st.pt, st.ptsum, st.tid, st.result_len, st.has_ts,
                  st.failed, st.done):
            a.zero_()
        st.logits.copy_(logits)
        st.n_past.copy_(prompt_len)
        st.seek_delta.fill_(N_FRAMES)
        st.attn_start.copy_(attn_start)
        st.seek.copy_(seek)
        st.seek_end.copy_(seek_end)
    replayed = step is not None
    if not replayed:
        def step(_):
            greedy_step(params, dims, ids, st, self_kv, cross_kv, p_max, max_tokens,
                        single_segment, force_steps, compute_dtype)

    steps = run_steps(step, st.stop, min(n_max, force_steps) if force_steps else n_max,
                      force_steps, behind=replayed)
    return WindowResult(
        tokens=st.tokens.clone(), p=st.p.clone(), pt=st.pt.clone(), ptsum=st.ptsum.clone(),
        tid=st.tid.clone(), result_len=st.result_len.clone(), seek_delta=st.seek_delta.clone(),
        failed=st.failed.clone(), steps=torch.tensor(steps, dtype=torch.int32),
    )

"""On-device greedy sampling with whisper's timestamp rules.

Counterpart of ``whisper_tpu.runtime.sampler`` (the reference's
``sampleBest``/``sampleTimestamp``, ContextImpl.cpp:71-169), as batched
tensor ops:

  1. max_tx = max prob over text tokens (ids < token_beg)
  2. initial step: timestamp candidates are restricted to the first 101
     timestamps; everything past token_beg+100 is banned outright
  3. sum_ts = sum of candidate timestamp probs; tid/max_ts = its argmax/max
  4. if sum_ts > max_tx (or forced): ban all text tokens
  5. ban sot/solm/not, take the argmax
  6. report p (prob of chosen), pt = max_ts/(sum_ts+1e-10), ptsum = sum_ts

``torch.argmax``, like ``jnp.argmax``, returns the FIRST maximal index, so
ties resolve identically in both packages.

The flags may be device tensors (the token loop passes ``i == 0`` of its
device step counter) and the sampler makes no host-to-device copy of its
own, so it runs inside a captured CUDA graph.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SpecialIds(NamedTuple):
    """Special token ids (Vocabulary.h:27-36)."""

    eot: int
    sot: int
    prev: int
    solm: int
    not_: int
    beg: int
    translate: int = 50_358
    transcribe: int = 50_359

    @staticmethod
    def from_vocab(v) -> "SpecialIds":
        return SpecialIds(
            eot=v.token_eot,
            sot=v.token_sot,
            prev=v.token_prev,
            solm=v.token_solm,
            not_=v.token_not,
            beg=v.token_beg,
            translate=v.token_translate,
            transcribe=v.token_transcribe,
        )


class SampleOut(NamedTuple):
    id: torch.Tensor      # [B] int32 chosen token
    p: torch.Tensor       # [B] f32 prob of chosen token
    tid: torch.Tensor     # [B] int32 best timestamp token
    pt: torch.Tensor      # [B] f32 max_ts / (sum_ts + 1e-10)
    ptsum: torch.Tensor   # [B] f32 sum of timestamp probs


def _lanes(flag, b: int, device) -> torch.Tensor:
    """A scalar or [B] bool as a [B, 1] bool tensor (a bool tensor on
    ``device`` is used as it is: no host copy)."""
    return torch.as_tensor(flag, dtype=torch.bool, device=device).expand(b)[:, None]


def sample_best(
    probs: torch.Tensor,        # [B, V] f32 (softmaxed)
    ids: SpecialIds,
    is_initial,                 # bool or [B] bool, or such a tensor
    force_timestamp,            # bool or [B] bool, or such a tensor
) -> SampleOut:
    b, v = probs.shape
    device = probs.device
    neg_inf = torch.full((), float("-inf"), dtype=probs.dtype, device=device)
    tok = torch.arange(v, device=device)[None, :]          # [1, V]
    is_initial = _lanes(is_initial, b, device)
    force_timestamp = _lanes(force_timestamp, b, device)

    text_mask = tok < ids.beg                              # [1, V]
    ts_ok = (tok >= ids.beg) & torch.where(is_initial, tok <= ids.beg + 100, True)

    max_tx = torch.where(text_mask, probs, neg_inf).amax(dim=-1)      # [B]
    ts_probs = torch.where(ts_ok, probs, neg_inf)
    sum_ts = torch.where(ts_ok, probs, 0.0).sum(dim=-1)               # [B]
    tid = ts_probs.argmax(dim=-1).to(torch.int32)                     # [B]
    max_ts = ts_probs.amax(dim=-1)                                    # [B]

    take_ts = (sum_ts > max_tx)[:, None] | force_timestamp

    banned = (
        (tok == ids.sot) | (tok == ids.solm) | (tok == ids.not_)
        | (take_ts & text_mask)
        | (is_initial & (tok > ids.beg + 100))
    )
    scores = torch.where(banned, neg_inf, probs)
    chosen = scores.argmax(dim=-1).to(torch.int32)                    # [B]
    p = probs.gather(-1, chosen[:, None].long())[:, 0]

    return SampleOut(id=chosen, p=p, tid=tid, pt=max_ts / (sum_ts + 1e-10), ptsum=sum_ts)

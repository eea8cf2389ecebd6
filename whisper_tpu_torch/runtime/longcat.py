"""LongCat-Flash-Omni's audio-to-text window: ``runtime/omni.py``'s context over the longcat family.

``LongcatContext`` is ``OmniContext`` with the family ``LONGCAT``
(``model/longcat.py``): ``encode_window`` (the Whisper stand-in encoder and
the connector), ``run_window`` (the eager prefill into the latent cache
[2L, B, P + max_new_tokens, kv_rank + rope_dim], then ``force_steps``
greedy token steps replayed as a CUDA graph on the card). Its spans are
``longcat_encode``, ``longcat_prefill`` and ``longcat_steps`` (units = the
steps launched). When a window's result is copied back, besides
``moe.tokens``, ``moe.experts_touched``, ``moe.experts_read`` and
``moe.step_layers`` (``runtime/omni.py``; the experts the steps' kernel may
read are this card's held ones): ``moe.routed_slots`` (choices of any of
the published routed experts), ``moe.zero_slots`` (of a zero expert) and
``moe.held_slots`` (of one this card holds).
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_tpu_torch.model import longcat
from whisper_tpu_torch.model.longcat import LatentKV
from whisper_tpu_torch.obs.profiler import TRACER
from whisper_tpu_torch.runtime.omni import Family, OmniContext


def _cache(dims, lanes: int, columns: int, dtype, device) -> LatentKV:
    return LatentKV(torch.zeros((dims.n_sublayers, lanes, columns, dims.latent_dim), dtype=dtype, device=device))


def _count(dims, counts: np.ndarray) -> None:
    TRACER.count("moe.routed_slots", int(counts[: dims.n_published].sum()))
    TRACER.count("moe.zero_slots", int(counts[dims.n_published: dims.n_experts].sum()))
    TRACER.count("moe.held_slots", int(counts[dims.held[0]: dims.held[1]].sum()))


LONGCAT = Family("longcat", longcat.prefill, longcat.step, _cache, lambda dims: range(*dims.held), _count)


class LongcatContext(OmniContext):
    """The compute state of one LongCat-Flash-Omni share (``OmniContext``'s)."""

    family = LONGCAT

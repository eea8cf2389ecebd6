"""WhisperContext analogue: owns the encode/decode entry points of a model.

Counterpart of ``whisper_tpu.runtime.context``:

  encode_window : mel [B, n_mels, 2*T] -> (audio features, cross K/V for
                  all decoder layers)
  run_window    : padded prompt + cross K/V -> WindowResult (the token loop
                  of runtime/decode.py)

Both run under ``torch.inference_mode`` on the runtime's device. On the
card, ``run_window`` replays its token step as a CUDA graph
(``runtime/graph.py``; ``cuda_graphs=True``, the default) over tensors the
runtime keeps per loop shape: the counterpart of the JAX package compiling
the loop into one device program. ``cuda_graphs=False`` runs the same step
eagerly, launch by launch: the plain version the graph is held against.
On the CPU the step always runs eagerly.

``kv_int8`` is the counterpart of ``KernelConfig.kv_int8``: int8 cross and
self K/V caches with per-column scales, read by the decode-attention kernel
(the serving tier, with ``DtypePolicy.serving()`` weights). KernelConfig's
other fields have no counterpart: the tensors' device selects kernel or
plain version.

Parameters sharded over a mesh's "model" axis (``parallel.sharding``) run
their collectives inside the step. NCCL's can be captured in a CUDA graph,
gloo's cannot (gloo is how two ranks share one card), so a runtime whose
model group is gloo with more than one rank on the card takes
``cuda_graphs=False``; asking it for graphs raises.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.model.decoder import init_self_kv
from whisper_tpu_torch.model.encoder import CrossKV, encode, precompute_cross_kv
from whisper_tpu_torch.model.params import WhisperParams
from whisper_tpu_torch.obs.profiler import TRACER
from whisper_tpu_torch.runtime.decode import (GreedyState, WindowResult, check_cache_room,
                                              decode_window, greedy_step)
from whisper_tpu_torch.runtime.graph import Slot, StepGraphs
from whisper_tpu_torch.runtime.sampler import SpecialIds


class WhisperRuntime:
    """Compute state for one model (shareable across Contexts)."""

    def __init__(
        self,
        params: WhisperParams,
        dims: ModelDims,
        special_ids: SpecialIds,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        kv_int8: bool = False,
        cuda_graphs: bool = True,
    ):
        self.device = resolve_device(device)
        self.params = params
        self.dims = dims
        self.ids = special_ids
        self.compute_dtype = compute_dtype
        self.kv_int8 = kv_int8
        self.cuda_graphs = cuda_graphs
        self.graphs = StepGraphs()

    @property
    def cuda_graphs(self) -> bool:
        return self._cuda_graphs

    @cuda_graphs.setter
    def cuda_graphs(self, on: bool) -> None:
        tp = self.params.tp
        if on and self.device.type == "cuda" and not tp.capturable:
            raise ValueError(f"a CUDA graph cannot capture {tp.backend} collectives (a model group "
                             f"of {tp.size} ranks): pass cuda_graphs=False")
        self._cuda_graphs = on

    # Prompt capacity: [_PREV_] + n_text_ctx/2 past tokens + SOT + lang + task
    # (reference prompt assembly, ContextImpl.cpp:562-576).
    @property
    def prompt_capacity(self) -> int:
        return self.dims.n_text_ctx // 2 + 4

    @property
    def n_max_steps(self) -> int:
        return self.dims.n_text_ctx // 2 - 4

    @property
    def replays(self) -> bool:
        """Whether the token loops replay captured steps (on the card, with
        ``cuda_graphs``)."""
        return self.device.type == "cuda" and self.cuda_graphs

    def self_kv(self, lanes: int):
        """A zeroed self cache of ``lanes`` lanes in this runtime's layout."""
        return init_self_kv(self.dims, lanes, dtype=self.compute_dtype, device=self.device,
                            quant=self.kv_int8, tp=self.params.tp)

    def slot(self, kind: str, state_fn, lanes: int, p_max: int, cross_kv: CrossKV) -> Slot:
        """The static tensors of a ``kind`` loop of this shape (made at first
        use, zeros): ``state_fn()``'s state, a self cache of ``lanes`` lanes
        and a buffer of ``cross_kv``'s shapes (whose lanes, with ``lanes``,
        fix the beam width)."""
        key = (kind, lanes, p_max,
               *(None if a is None else (tuple(a.shape), a.dtype) for a in cross_kv))
        return self.graphs.slot(key, lambda: Slot(
            state_fn(), self.self_kv(lanes),
            CrossKV(*(None if a is None else torch.zeros_like(a) for a in cross_kv))))

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    @torch.inference_mode()
    def encode_window(self, mel) -> tuple[torch.Tensor, CrossKV]:
        """mel [B, n_mels, 2*T] -> (audio_features, cross_kv)."""
        with TRACER.span("encode", device=self.device):
            mel = self._tensor(mel, torch.float32)
            feats = encode(self.params, self.dims, mel, compute_dtype=self.compute_dtype)
            with TRACER.span("cross_kv", device=self.device):
                cross = precompute_cross_kv(self.params, self.dims, feats,
                                            compute_dtype=self.compute_dtype, quant=self.kv_int8)
            return feats, cross

    @torch.inference_mode()
    def run_window(
        self,
        prompt,
        prompt_len,
        cross_kv: CrossKV,
        seek,
        seek_end,
        max_tokens: int = 0,
        single_segment: bool = False,
        force_steps: int = 0,
    ) -> WindowResult:
        with TRACER.span("decode", device=self.device):
            prompt = self._tensor(prompt, torch.int32)
            b, p_max = prompt.shape
            plen = self._tensor(prompt_len, torch.int32)
            lim = (self._tensor(seek, torch.int32), self._tensor(seek_end, torch.int32))
            kw = dict(max_tokens=max_tokens, single_segment=single_segment,
                      compute_dtype=self.compute_dtype, force_steps=force_steps)
            if not self.replays:
                return decode_window(self.params, self.dims, self.ids, prompt, plen, self.self_kv(b),
                                     cross_kv, *lim, **kw)
            check_cache_room(p_max, self.n_max_steps, self.dims.n_text_ctx)  # before any warm-up step
            with self.graphs.lock:
                slot = self.slot("greedy", lambda: GreedyState.zeros(
                    b, self.n_max_steps, self.dims.n_vocab, self.device), b, p_max, cross_kv)

                def body():
                    greedy_step(self.params, self.dims, self.ids, slot.state, slot.kv, slot.cross,
                                p_max, max_tokens, single_segment, force_steps, self.compute_dtype)

                graph = slot.step((max_tokens, single_segment, force_steps), body)
                slot.load(cross_kv)
                return decode_window(self.params, self.dims, self.ids, prompt, plen, slot.kv,
                                     slot.cross, *lim, **kw, state=slot.state, step=lambda _: graph())

"""The audio-to-text window of a decoder-only family: the encoder, an eager prefill, replayed token steps.

``OmniContext`` is ``runtime/context.py``'s counterpart for the
decoder-only families that take Whisper's encoder as their audio tower. A
``Family`` names the model's own parts: its prefill and token step, its
cache, the experts its steps' kernel may read and its routing counters.
``OMNI`` is Uni-MoE-2.0-Omni's (``model/omni.py``), ``OmniContext``'s
default; ``runtime/longcat.py`` holds LongCat-Flash-Omni's. A context:

  encode_window : mel [B, n_mels, 3000] -> audio tokens [B, 300, d]: the
                  Whisper encoder (``model/encoder.py:encode``, K1), then
                  the connector
  run_window    : a right-padded prompt [B, P] whose audio placeholders
                  take the lanes' audio tokens -> ``OmniResult``: the
                  prompt left-aligned and prefilled eagerly into the
                  family's cache of P + max_new_tokens columns, then
                  ``force_steps`` greedy token steps (argmax over the
                  vocabulary), each feeding its token

On the card the token step is captured once per loop shape as a CUDA
graph (``runtime/graph.py``'s ``Slot``: the state, the family's cache, no
cross K/V) and replayed through ``runtime/decode.py:run_steps``;
``cuda_graphs=False``, and the CPU, run the same step eagerly: the plain
version the graph is held against.

Spans and counters (``obs/profiler.py:TRACER``), the spans named by the
family: ``<name>_encode`` (per call), ``<name>_prefill`` (per call) and
``<name>_steps`` (units = the steps launched); when a window's result is
copied back, ``moe.tokens`` (token-layer pairs through an expert layer,
prompt and steps), ``moe.experts_touched`` (summed over the steps' layers,
the experts the steps' kernel may read that at least one lane chose),
``moe.experts_read`` (the experts the steps' expert layers read, counted on
the device by ``kernels/moe.py:moe_experts``), ``moe.step_layers`` (the
steps' layers) and the family's own counts of the choices: the omni
family's ``moe.routed_slots`` and ``moe.null_slots`` (kept routed and null
choices). All are read from the device's routing record and counts, with
no host read inside the steps.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import numpy as np
import torch

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.model.decoder import SelfKV
from whisper_tpu_torch.model.encoder import encode
from whisper_tpu_torch.model import omni
from whisper_tpu_torch.model.omni import connect
from whisper_tpu_torch.obs.profiler import TRACER
from whisper_tpu_torch.runtime.decode import run_steps
from whisper_tpu_torch.runtime.graph import Slot, StepGraphs


class OmniResult(NamedTuple):
    """A window's result, on the host."""

    tokens: np.ndarray       # [B, T] int32: the greedy tokens served
    p: np.ndarray            # [B, T] f32: each one's probability
    routes: np.ndarray       # [L, B, C, top_k] int8 (int16 past 127 experts): each column's kept experts, -1 for none
    attn_start: np.ndarray   # [B] int32: a lane's first prompt column (left-aligned)
    prompt_cols: int         # P: the steps' tokens sit at columns P, P + 1, ...
    touched: np.ndarray      # [T, L] int32: experts the steps' kernel may read that a lane chose at each step


class OmniState(NamedTuple):
    """The token loop's state: tensors on the device that ``step`` reads and
    updates in place."""

    i: torch.Tensor          # [] int32 step counter
    logits: torch.Tensor     # [B, V] f32 logits after the last token fed
    n_past: torch.Tensor     # [B] int32 real position of the next token
    attn_start: torch.Tensor  # [B] int32 first valid cache column
    tokens: torch.Tensor     # [B, T_max] int32
    p: torch.Tensor          # [B, T_max] f32
    routes: torch.Tensor     # [L, B, C, top_k] int8, or int16 past 127 router outputs
    counts: torch.Tensor     # [L, n_experts + 1] int32
    read: torch.Tensor       # [L] int32: experts the steps' expert layers read

    @staticmethod
    def zeros(dims, b: int, t_max: int, cache_len: int, device) -> "OmniState":
        """``dims``: a family's sizes (``n_vocab``, ``n_layer`` expert
        layers, ``top_k``, ``n_experts`` router outputs)."""
        def z(*shape, dtype=torch.int32):
            return torch.zeros(shape, dtype=dtype, device=device)

        ids = torch.int8 if dims.n_experts <= 127 else torch.int16
        return OmniState(i=z(), logits=z(b, dims.n_vocab, dtype=torch.float32), n_past=z(b),
                         attn_start=z(b), tokens=z(b, t_max), p=z(b, t_max, dtype=torch.float32),
                         routes=z(dims.n_layer, b, cache_len, dims.top_k, dtype=ids),
                         counts=z(dims.n_layer, dims.n_experts + 1), read=z(dims.n_layer))


class Family(NamedTuple):
    """A decoder-only family's parts, as the context drives them."""

    name: str            # the spans' prefix
    prefill: Callable    # (params, dims, ids, audio, attn_start, kv, routes, counts, dtype) -> logits
    step: Callable       # (params, dims, tokens, pos, attn_start, col, kv, routes, counts, dtype, read) -> logits
    cache: Callable      # (dims, lanes, columns, dtype, device) -> the cache, a NamedTuple of tensors
    readable: Callable   # dims -> range: the expert ids the steps' kernel may read
    count: Callable      # (dims, counts [n_experts + 1] summed over layers) -> None: the family's counters


def _omni_cache(dims, lanes: int, columns: int, dtype, device) -> SelfKV:
    shape = (dims.n_layer, lanes, dims.kv_dim, columns)
    return SelfKV(torch.zeros(shape, dtype=dtype, device=device), torch.zeros(shape, dtype=dtype, device=device))


def _omni_count(dims, counts: np.ndarray) -> None:
    TRACER.count("moe.routed_slots", int(counts[: dims.n_routed].sum()))
    TRACER.count("moe.null_slots", int(counts[dims.n_routed: dims.n_experts].sum()))


OMNI = Family("omni", omni.prefill, omni.step, _omni_cache, lambda dims: range(dims.n_routed), _omni_count)


def omni_step(params, dims, st: OmniState, kv, p_max: int, compute_dtype: torch.dtype,
              family: Family = OMNI) -> None:
    """One greedy token step of ``family``, in place: the argmax of
    ``st.logits`` and its probability recorded at column ``st.i``, then
    fed at cache column ``p_max + st.i``."""
    i = st.i
    col = i.view(1).long()
    tok = st.logits.argmax(dim=-1)
    p = torch.softmax(st.logits, dim=-1).gather(1, tok[:, None])
    st.tokens.index_copy_(1, col, tok.to(torch.int32)[:, None])
    st.p.index_copy_(1, col, p)
    logits = family.step(params, dims, tok, st.n_past, st.attn_start, p_max + i, kv, st.routes, st.counts,
                         compute_dtype, st.read)
    st.logits.copy_(logits)
    st.n_past.add_(1)
    i.add_(1)


class OmniContext:
    """The compute state of one model of the family ``family`` (Uni-MoE-2.0-
    Omni's here): its parameters, the prompt capacity and the most token
    steps a window takes (which size the cache), and the captured steps by
    loop shape."""

    family: Family = OMNI

    def __init__(self, params, dims, compute_dtype: torch.dtype = torch.bfloat16,
                 device: str | torch.device = "cuda", cuda_graphs: bool = True,
                 prompt_capacity: int = 448, max_new_tokens: int = 112):
        self.device = resolve_device(device)
        self.params, self.dims, self.compute_dtype = params, dims, compute_dtype
        self.cuda_graphs = cuda_graphs
        self.prompt_capacity, self.max_new_tokens = prompt_capacity, max_new_tokens
        self.graphs = StepGraphs()

    @property
    def cache_len(self) -> int:
        return self.prompt_capacity + self.max_new_tokens

    @property
    def replays(self) -> bool:
        return self.device.type == "cuda" and self.cuda_graphs

    def self_kv(self, lanes: int):
        """The family's cache for ``lanes`` lanes, zeros."""
        return self.family.cache(self.dims, lanes, self.cache_len, self.compute_dtype, self.device)

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    @torch.inference_mode()
    def encode_window(self, mel) -> torch.Tensor:
        """mel [B, n_mels, 3000] -> audio tokens [B, audio_tokens, d] in the compute dtype."""
        with TRACER.span(f"{self.family.name}_encode", device=self.device):
            mel = self._tensor(mel, torch.float32)
            feats = encode(self.params, self.dims.audio, mel, compute_dtype=self.compute_dtype)
            return connect(self.params, self.dims, feats, self.compute_dtype)

    @torch.inference_mode()
    def run_window(self, prompt, prompt_len, audio: torch.Tensor, force_steps: int) -> OmniResult:
        """``prompt`` [B, P] ids right-padded (P at most ``prompt_capacity``),
        ``prompt_len`` [B] their real lengths, each lane's holding exactly
        ``audio_tokens`` placeholders that take ``audio`` [B, A, d] in
        order; exactly ``force_steps`` greedy steps (1 to ``max_new_tokens``)."""
        prompt = self._tensor(prompt, torch.int32)
        b, p_max = prompt.shape
        if not 1 <= force_steps <= self.max_new_tokens or p_max > self.prompt_capacity:
            raise ValueError(f"{force_steps} steps after a prompt of {p_max} columns: the window holds "
                             f"{self.max_new_tokens} steps after {self.prompt_capacity}")
        plen = self._tensor(prompt_len, torch.int32)
        dims, dtype, fam = self.dims, self.compute_dtype, self.family
        if self.replays:
            slot = self.graphs.slot((fam.name, b, p_max), lambda: Slot(
                OmniState.zeros(dims, b, self.max_new_tokens, self.cache_len, self.device),
                self.self_kv(b), ()))
            st, kv = slot.state, slot.kv
            run = slot.step((), partial(omni_step, self.params, dims, st, kv, p_max, dtype, fam))
            slot.load(())
        else:
            st = OmniState.zeros(dims, b, self.max_new_tokens, self.cache_len, self.device)
            kv = self.self_kv(b)
            run = partial(omni_step, self.params, dims, st, kv, p_max, dtype, fam)

        with TRACER.span(f"{fam.name}_prefill", device=self.device):
            for a in (st.i, st.tokens, st.p, st.routes, st.counts, st.read):
                a.zero_()
            st.routes.fill_(-1)
            attn_start = p_max - plen
            cols = torch.arange(p_max, device=self.device)[None, :]
            ids = prompt.gather(1, ((cols - attn_start[:, None]) % p_max).long())   # left-aligned
            st.logits.copy_(fam.prefill(self.params, dims, ids, audio, attn_start, kv, st.routes,
                                        st.counts, dtype))
            st.attn_start.copy_(attn_start)
            st.n_past.copy_(plen)
        with TRACER.span(f"{fam.name}_steps", device=self.device) as span:
            # forced steps: run_steps reads no flag (``st.i`` names the device)
            span.units = run_steps(lambda _: run(), st.i, force_steps, force_steps)
        routed = st.routes[:, :, p_max: p_max + force_steps]                # [L, B, T, top_k]
        chosen = torch.stack([(routed == e).any(-1).any(1) for e in fam.readable(dims)])
        res = OmniResult(tokens=st.tokens[:, :force_steps].cpu().numpy(),
                         p=st.p[:, :force_steps].cpu().numpy(), routes=st.routes.cpu().numpy(),
                         attn_start=st.attn_start.cpu().numpy(), prompt_cols=p_max,
                         touched=chosen.sum(0, dtype=torch.int32).T.cpu().numpy())
        counts = st.counts.sum(0).cpu().numpy()
        TRACER.count("moe.tokens", int(counts[-1]))
        fam.count(dims, counts)
        TRACER.count("moe.experts_touched", int(res.touched.sum()))
        TRACER.count("moe.experts_read", int(st.read.sum()))
        TRACER.count("moe.step_layers", force_steps * dims.n_layer)
        return res

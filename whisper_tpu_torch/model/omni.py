"""Uni-MoE-2.0-Omni's audio-to-text path: connector, language model and its expert layers.

The audio tower is the Whisper encoder (``model/encoder.py:encode``, K1),
read from ``OmniParams.enc``. Then, with d the hidden size:

  - connector: the encoder's 1500 frames of a window averaged in groups of
    ``audio_pool`` (5: 300 tokens, 10 a second), then a linear layer with a
    bias, 1280 -> d
  - language model: token embeddings, whose audio placeholders take the
    window's audio tokens in order; L blocks of
    ``h = x + Attn(RMSNorm(x))``, ``y = h + MoE(RMSNorm(h))``; RMSNorm and
    the untied head over the vocabulary
  - attention: grouped-query, ``n_head`` query heads over ``n_kv_head``
    K/V heads of ``head_dim`` (query head j reads K/V head j // group),
    q, k and v with biases, o without; M-RoPE on q and k; scale
    1/sqrt(head_dim); causal over the lane's own positions
  - M-RoPE: rotate-half rotary embedding with theta ``rope_theta``; its
    head_dim / 2 frequency pairs are split by ``mrope_section`` into a
    temporal, a height and a width stream, each turned by its own position
    id. Text and audio take one consecutive index in all three streams
  - MoE: a router ``softmax(x_f32 @ W_g)`` in f32 over ``n_routed`` routed
    experts and ``n_null`` null experts (computing nothing); the
    probabilities sorted in descending order keep the shortest prefix whose
    sum reaches ``top_p``, at most ``top_k`` of them;
    ``MoE(x) = sum_kept_routed p_e E_e(x) + sum_s S_s(x)``, the weights not
    renormalised, the shared experts ungated; every expert a SwiGLU
    ``W_down(silu(W_gate x) * W_up x)``

Products go through ``kernels/w8a16.py:dense`` (bf16 operands, f32 results
on the card). Activations travel in the compute dtype, norms, the router,
softmax and rotary angles in f32.

The self cache is one [L, B, n_kv_head * head_dim, C] pair of K and V,
transposed (features-major, as Whisper's), K rotated and unscaled.
``prefill`` writes a left-aligned prompt's columns [0, P) eagerly and
attends by plain masked einsums; its expert layer groups the prompt's real
positions by expert and runs one product per routed expert over its rows.
``step`` (runtime/omni.py replays it as a CUDA graph) feeds one token per
lane at a device column: self-attention through K2 with the query heads of
a K/V head folded into lanes (``kv_group``), and the expert layer over all
lanes through ``kernels/moe.py:moe_experts`` (on the card a kernel pair that
reads each expert some lane kept once, decided from the gates on the
device, so no host value is read; it adds the routed experts it read to
``read`` [L], a layer's count each). Both
write each position's routing into ``routes`` [L, B, C, top_k] (int8,
the kept experts in order of probability, -1 for none; null experts are
n_routed..) and add to ``counts`` [L, n_experts + 1] the kept choices of
each expert and, in the last column, the tokens routed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd
from whisper_tpu_torch.kernels.moe import moe_experts, swiglu
from whisper_tpu_torch.kernels.w8a16 import dense
from whisper_tpu_torch.model.omni_params import OmniBlock, OmniDims, OmniParams


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm in f32 (x * rsqrt(mean(x^2) + eps) * w), returns f32."""
    xf = x.float()
    return xf * torch.rsqrt(xf.square().mean(-1, keepdim=True) + eps) * w.float()


def inv_freq(dims: OmniDims, device) -> torch.Tensor:
    """[head_dim / 2] f32 rotary frequencies theta^(-2i/head_dim)."""
    dh = dims.head_dim
    return 1.0 / (dims.rope_theta ** (torch.arange(0, dh, 2, device=device, dtype=torch.int64).float() / dh))


def mrope(pos3: torch.Tensor, dims: OmniDims) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [..., head_dim] f32 for position ids ``pos3`` [3, ...]
    (temporal, height, width): frequency pair i turns by the id of its
    section's stream; the two halves of a head repeat the pairs."""
    freq = inv_freq(dims, pos3.device)
    t, h, _ = dims.mrope_section
    pair = torch.arange(dims.head_dim // 2, device=pos3.device)
    stream = (pair >= t).long() + (pair >= t + h).long()            # no host-to-device copy
    ang = pos3.float().movedim(0, -1)[..., stream] * freq          # [..., head_dim / 2]
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate-half rotary embedding of x [B, S, H, Dh] f32 by cos/sin [B, S, Dh]."""
    half = x.shape[-1] // 2
    turned = torch.cat([-x[..., half:], x[..., :half]], dim=-1)
    return x * cos[:, :, None] + turned * sin[:, :, None]


def route(xf: torch.Tensor, router_w: torch.Tensor, dims: OmniDims):
    """The router over rows ``xf`` [N, d] (f32): (gates [N, n_routed] f32,
    the kept routed experts' probabilities and 0 elsewhere; kept [N,
    n_experts] bool; choice [N, top_k] int64, the kept experts in order of
    probability, -1 past the cut). No host read."""
    probs = torch.softmax(dense(xf, router_w), dim=-1)
    top, idx = probs.sort(dim=-1, descending=True, stable=True)
    before = F.pad(top.cumsum(-1)[:, :-1], (1, 0))                  # mass above each sorted slot
    keep = before[:, : dims.top_k] < dims.top_p                     # slot 0 always
    kept = torch.zeros_like(probs, dtype=torch.bool).scatter(1, idx[:, : dims.top_k], keep)
    gates = torch.where(kept, probs, 0.0)[:, : dims.n_routed]
    choice = torch.where(keep, idx[:, : dims.top_k], -1)
    return gates, kept, choice


def moe_rows(x: torch.Tensor, blk: OmniBlock, dims: OmniDims, real: torch.Tensor, dtype):
    """The expert layer over rows x [N, d] (the prefill's positions), eager:
    routing on the device, then each routed expert over the real rows that
    kept it. ``real`` [N] bool: rows that are not padding. Returns (the
    layer's output [N, d] f32, choice [N, top_k], kept [N, n_experts])."""
    hf = rms_norm(x, blk.post_norm_w, dims.rms_eps)
    h = hf.to(dtype)
    gates, kept, choice = route(hf, blk.router_w, dims)
    kept = kept & real[:, None]
    choice = torch.where(real[:, None], choice, -1)
    out = swiglu(h, blk.shared_gate_up, blk.shared_down)
    for e in range(dims.n_routed):
        rows = kept[:, e].nonzero().squeeze(1)
        if rows.numel():
            y = swiglu(h[rows], getattr(blk, f"gate_up_{e}"), getattr(blk, f"down_{e}"))
            out.index_add_(0, rows, y * gates[rows, e:e + 1])
    return out, choice, kept


def moe_lanes(x: torch.Tensor, blk: OmniBlock, dims: OmniDims, dtype, read: torch.Tensor | None = None):
    """The expert layer over one token a lane, x [B, d] (B <= 8), with static
    shapes and no host read on the card: ``moe_experts`` runs the shared
    experts and each routed expert some lane kept, times its gates (0 where
    a lane did not keep it), and adds the routed experts it read to
    ``read`` (one int32). Returns (output [B, d] f32, choice, kept)."""
    hf = rms_norm(x, blk.post_norm_w, dims.rms_eps)
    h = hf.to(dtype)
    gates, kept, choice = route(hf, blk.router_w, dims)
    routed = [(getattr(blk, f"gate_up_{e}"), getattr(blk, f"down_{e}")) for e in range(dims.n_routed)]
    out = moe_experts(h, gates, (blk.shared_gate_up, blk.shared_down), routed, read)
    return out, choice, kept


def _qkv(x: torch.Tensor, blk: OmniBlock, dims: OmniDims, cos, sin):
    """q [B, S, n_head, Dh] (rotated, times 1/sqrt(Dh)), k and v [B, S, kv_dim]
    (k rotated), all f32, from x [B, S, d]."""
    b, s, _ = x.shape
    dh, d, kv = dims.head_dim, dims.d, dims.kv_dim
    h = rms_norm(x, blk.in_norm_w, dims.rms_eps).to(x.dtype)
    y = dense(h, blk.qkv_w, blk.qkv_b)
    q = rotate(y[..., :d].reshape(b, s, dims.n_head, dh), cos, sin) * dh ** -0.5
    k = rotate(y[..., d:d + kv].reshape(b, s, dims.n_kv_head, dh), cos, sin).reshape(b, s, kv)
    return q, k, y[..., d + kv:]


def _record(routes: torch.Tensor, counts: torch.Tensor, li: int, choice: torch.Tensor,
            kept: torch.Tensor, real: torch.Tensor, cols) -> None:
    """Writes a layer's routing of rows [B, S] at cache columns ``cols`` (a
    host slice, or a device index for S = 1) and adds its counts."""
    b = routes.shape[1]
    rec = choice.to(torch.int8).reshape(b, -1, choice.shape[-1])
    if isinstance(cols, torch.Tensor):
        routes[li].index_copy_(1, cols, rec)
    else:
        routes[li, :, cols] = rec
    counts[li, :-1] += kept.sum(0, dtype=torch.int32)
    counts[li, -1] += real.sum(dtype=torch.int32)


def connect(params: OmniParams, dims: OmniDims, feats: torch.Tensor, dtype) -> torch.Tensor:
    """Encoder features [B, T, 1280] (f32) -> audio tokens [B, T / pool, d]
    in ``dtype``: frames averaged in groups of ``audio_pool``, then the
    connector's linear layer."""
    b, t, w = feats.shape
    pooled = feats.float().reshape(b, t // dims.audio_pool, dims.audio_pool, w).mean(2)
    return dense(pooled.to(dtype), params.proj_w, params.proj_b).to(dtype)


def embed(params: OmniParams, dims: OmniDims, ids: torch.Tensor, audio: torch.Tensor | None,
          dtype) -> torch.Tensor:
    """Token embeddings [B, S, d] of ``ids`` [B, S]; with ``audio`` [B, A,
    d], positions holding ``audio_token_id`` take its rows in order (each
    lane holds exactly A of them). Without, every id is a token."""
    if audio is None:
        return params.embed[ids.long()].to(dtype)
    is_audio = ids == dims.audio_token_id
    x = params.embed[torch.where(is_audio, 0, ids).long()].to(dtype)
    return x.masked_scatter(is_audio[..., None], audio.to(dtype))


def prefill(params: OmniParams, dims: OmniDims, ids: torch.Tensor, audio: torch.Tensor,
            attn_start: torch.Tensor, kv, routes: torch.Tensor, counts: torch.Tensor,
            dtype) -> torch.Tensor:
    """The prompt, eagerly, into cache columns [0, P): ``ids`` [B, P]
    left-aligned (lane b's real tokens in columns [attn_start_b, P)), the
    audio placeholders among them filled from ``audio``. Writes the K/V
    columns, the routing record and the counts; returns the logits [B, V]
    (f32) after each lane's last token."""
    b, p = ids.shape
    device = ids.device
    col = torch.arange(p, device=device)
    pos = (col[None, :] - attn_start[:, None]).clamp_min(0)           # real positions; pads at 0
    cos, sin = mrope(pos[None].expand(3, b, p), dims)
    real = col[None, :] >= attn_start[:, None]                         # [B, P]
    keep = (col[None, :, None] >= col[None, None, :]) & real[:, None, :]  # [B, Sq, Sk]
    x = embed(params, dims, ids, audio, dtype)
    g, dh, n_kv = dims.group, dims.head_dim, dims.n_kv_head
    for li, blk in enumerate(params.blocks):
        q, k, v = _qkv(x, blk, dims, cos, sin)
        kv.k[li, :, :, :p] = k.to(kv.k.dtype).transpose(1, 2)
        kv.v[li, :, :, :p] = v.to(kv.v.dtype).transpose(1, 2)
        k4 = kv.k[li, :, :, :p].float().reshape(b, n_kv, dh, p)
        v4 = kv.v[li, :, :, :p].float().reshape(b, n_kv, dh, p)
        q5 = q.to(dtype).float().reshape(b, p, n_kv, g, dh)
        scores = torch.einsum("bsngd,bndt->bngst", q5, k4)
        scores = scores.masked_fill(~keep[:, None, None], -1e30)
        probs = torch.softmax(scores, dim=-1).to(dtype).float()
        att = torch.einsum("bngst,bndt->bsngd", probs, v4).reshape(b, p, dims.d)
        x = x + dense(att.to(dtype), blk.o_w).to(dtype)
        out, choice, kept = moe_rows(x.reshape(b * p, -1), blk, dims, real.reshape(-1), dtype)
        x = x + out.reshape(b, p, -1).to(dtype)
        _record(routes, counts, li, choice, kept, real, slice(0, p))
    h = rms_norm(x[:, -1], params.norm_w, dims.rms_eps).to(dtype)
    return dense(h, params.head_w)


def gqa_decode(q: torch.Tensor, k_t: torch.Tensor, v_t: torch.Tensor, valid: torch.Tensor,
               start: torch.Tensor, g: int) -> torch.Tensor:
    """One query a lane, q [B, n_head, Dh] (pre-scaled), over the transposed
    cache k_t/v_t [B, n_kv * Dh, C] of n_kv = n_head / g K/V heads, keys
    [start, valid) of each of the B * g lanes: K2 with the g query heads of
    a K/V head folded into g lanes ([B, n_kv, g, Dh] -> [B * g, n_kv * Dh]),
    lane b * g + j reading K/V lane b. Returns [B, n_head, Dh] f32."""
    b, nh, dh = q.shape
    n_kv = nh // g
    qg = q.reshape(b, n_kv, g, dh).transpose(1, 2).reshape(b * g, n_kv * dh, 1).contiguous()
    att = decode_attention_hd(qg, k_t, v_t, n_kv, valid_len=valid, start=start, kv_group=g)
    return att.reshape(b, g, n_kv, dh).transpose(1, 2).reshape(b, nh, dh)


def step(params: OmniParams, dims: OmniDims, tokens: torch.Tensor, pos: torch.Tensor,
         attn_start: torch.Tensor, col: torch.Tensor, kv, routes: torch.Tensor,
         counts: torch.Tensor, dtype, read: torch.Tensor) -> torch.Tensor:
    """One token a lane, ``tokens`` [B] at real positions ``pos`` [B] and
    cache column ``col`` (device int32 scalar, shared by the lanes): writes
    its K/V column and routing, adds each layer's routed experts read to
    ``read`` [L] (int32), returns the logits [B, V] f32. Reads no
    host value: runtime/omni.py captures it as a CUDA graph."""
    b = tokens.shape[0]
    g, dh, n_kv = dims.group, dims.head_dim, dims.n_kv_head
    cos, sin = mrope(pos[None, :, None].expand(3, b, 1), dims)
    cols = col.view(1).long()
    start = attn_start[:, None].expand(b, g).reshape(b * g)            # lane b*g + j reads K/V lane b
    valid = col.to(torch.int32).view(1).expand(b * g) + 1
    real = torch.ones(b, dtype=torch.bool, device=tokens.device)
    x = embed(params, dims, tokens[:, None], None, dtype)
    for li, blk in enumerate(params.blocks):
        q, k, v = _qkv(x, blk, dims, cos, sin)
        kv.k[li].index_copy_(2, cols, k.to(kv.k.dtype).transpose(1, 2))
        kv.v[li].index_copy_(2, cols, v.to(kv.v.dtype).transpose(1, 2))
        att = gqa_decode(q.to(dtype).reshape(b, dims.n_head, dh), kv.k[li], kv.v[li], valid, start, g)
        x = x + dense(att.reshape(b, 1, dims.d).to(dtype), blk.o_w).to(dtype)
        out, choice, kept = moe_lanes(x.reshape(b, -1), blk, dims, dtype, read[li:li + 1])
        x = x + out.reshape(b, 1, -1).to(dtype)
        _record(routes, counts, li, choice, kept, real, cols)
    h = rms_norm(x[:, 0], params.norm_w, dims.rms_eps).to(dtype)
    return dense(h, params.head_w)

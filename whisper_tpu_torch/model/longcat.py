"""LongCat-Flash-Omni's audio-to-text path, one card's expert share: connector, language model, expert layer.

The audio tower is the Whisper encoder (``model/encoder.py:encode``, K1) and
the connector ``model/omni.py:connect`` (a stand-in: the configuration's
``audio_config``). Then, with d the hidden size, L double layers of

    h1 = x + MLA_0(RMSNorm(x));  n1 = RMSNorm(h1)
    m  = MoE(n1)                                  the shortcut branch
    h2 = h1 + FFN_0(n1)
    h3 = h2 + MLA_1(RMSNorm(h2))
    y  = h3 + FFN_1(RMSNorm(h3)) + m

an RMSNorm and the untied head. FFN is a SwiGLU of width ``ffn``.

  - MLA (latent attention): ``q = q_b(RMSNorm(q_a x)) * (d / q_rank)^0.5``,
    ``n_head`` heads of ``nope_dim`` + ``rope_dim``; ``[c, k_rope] = kv_a
    x`` with ``c = RMSNorm(c) * (d / kv_rank)^0.5``; per head ``k_nope`` and
    ``v`` from ``kv_b c``; RoPE (theta ``rope_theta``, interleaved: a
    head's adjacent pairs gathered into halves, then rotate-half) on q's
    rope dims and on ``k_rope``, one head that every query head reads;
    scale (nope_dim + rope_dim)^-0.5, causal over the lane's own
    positions; ``o`` over the heads' values. The two latent norms take eps
    1e-6 (transformers' default there), the layer norms ``rms_eps``.
  - MoE: a router ``softmax(n1_f32 @ W_r)`` in f32 over the ``n_published``
    routed and ``n_zero`` zero experts; the top ``top_k`` of ``scores +
    router_bias`` are chosen, each weighted by its score times
    ``routed_scale``, not renormalised. A routed expert is a SwiGLU of
    width ``expert_width``, a zero expert the identity (it adds ``weight *
    n1``). This card computes its held experts' part and the zero experts'
    part; the other cards' routed experts add theirs there, not here.

The cache is one latent tensor [2L, B, C, kv_rank + rope_dim] (a
``LatentKV``), position-major: sublayer s of lane b keeps at column t the
token's normed, scaled latent ``c`` and its rotated ``k_rope``, in the
compute dtype. ``prefill`` writes a left-aligned prompt's columns [0, P)
eagerly, in groups of ``PREFILL_LANES`` lanes, with the attention expanded
(``kv_b`` over the cached latent: every head's keys and values) by plain
masked batched products (bf16 operands, f32 scores and sums on the card),
and the expert layer grouping the real positions by held expert. ``step``
(replayed as a CUDA graph) feeds one token per lane at a device column
with the attention absorbed: q_nope taken through ``kv_b``'s K half into
the latent's width, attention over the latent columns by
``kernels/mla.py:mla_decode`` (K and V both read from them), then the V
half before ``o``; its expert layer over all lanes through
``kernels/moe.py:moe_experts`` (the held experts some lane chose, read
once, counted into ``read``), the zero experts' summed weight times n1
added beside it. Both write each position's routing into ``routes`` [L, B,
C, top_k] (int16: every chosen expert id, 0..n_experts - 1) and add to
``counts`` [L, n_experts + 1] each expert's choices and, in the last
column, the tokens routed.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from whisper_tpu_torch.kernels.mla import mla_decode
from whisper_tpu_torch.kernels.moe import moe_experts, swiglu
from whisper_tpu_torch.kernels.w8a16 import dense
from whisper_tpu_torch.model.longcat_params import LongcatBlock, LongcatDims, LongcatParams
from whisper_tpu_torch.model.omni import _record, embed, rms_norm

LATENT_EPS = 1e-6        # q_a_layernorm and kv_a_layernorm
PREFILL_LANES = 16       # lanes a prefill pass takes: its f32 scores are ~0.8 GB a sublayer at 448 columns


class LatentKV(NamedTuple):
    """The latent cache: ``c`` [2L, B, C, kv_rank + rope_dim]."""

    c: torch.Tensor


def rope_tables(pos: torch.Tensor, dims: LongcatDims) -> tuple[torch.Tensor, torch.Tensor]:
    """(cos, sin) [..., rope_dim] f32 for positions ``pos`` (rotate-half layout)."""
    dr = dims.rope_dim
    inv = 1.0 / (dims.rope_theta ** (torch.arange(0, dr, 2, device=pos.device, dtype=torch.int64).float() / dr))
    ang = pos.float()[..., None] * inv
    ang = torch.cat([ang, ang], dim=-1)
    return ang.cos(), ang.sin()


def rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Interleaved RoPE of x [..., rope_dim] (f32): adjacent pairs gathered
    into halves (even dims, then odd), then rotate-half by cos/sin
    broadcast over x's leading dims."""
    dr = x.shape[-1]
    x = x.unflatten(-1, (dr // 2, 2)).transpose(-1, -2).flatten(-2)
    turned = torch.cat([-x[..., dr // 2:], x[..., : dr // 2]], dim=-1)
    return x * cos + turned * sin


def _latent(h: torch.Tensor, blk: LongcatBlock, j: int, dims: LongcatDims, cos, sin):
    """From normed rows h [B, S, d] (compute dtype): q_nope [B, S, H,
    nope_dim] and q_rope [B, S, H, rope_dim] (rotated, both times the q
    scale), and the cache columns [B, S, kv_rank + rope_dim] (c normed and
    scaled, k_rope rotated), all f32; cos/sin [B, S, rope_dim]."""
    b, s, _ = h.shape
    qa = dense(h, getattr(blk, f"q_a_{j}"))
    q = dense(rms_norm(qa, getattr(blk, f"q_norm_{j}"), LATENT_EPS).to(h.dtype), getattr(blk, f"q_b_{j}"))
    q = q.view(b, s, dims.n_head, dims.qk_dim) * dims.q_scale
    ckv = dense(h, getattr(blk, f"kv_a_{j}"))
    c = rms_norm(ckv[..., : dims.kv_rank], getattr(blk, f"kv_norm_{j}"), LATENT_EPS) * dims.kv_scale
    col = torch.cat([c, rope(ckv[..., dims.kv_rank:], cos, sin)], dim=-1)
    q_rope = rope(q[..., dims.nope_dim:], cos[:, :, None], sin[:, :, None])
    return q[..., : dims.nope_dim], q_rope, col


def route(xf: torch.Tensor, blk: LongcatBlock, dims: LongcatDims):
    """The router over rows ``xf`` [N, d] (f32): (gates [N, n_held] f32,
    each held expert's weight where a row chose it and 0 elsewhere; zero
    [N] f32, the summed weight of the zero experts a row chose; choice [N,
    top_k] int64, the chosen experts by descending selection score). No
    host read."""
    scores = torch.softmax(dense(xf, blk.router_w), dim=-1)
    choice = (scores + blk.router_bias).topk(dims.top_k, dim=-1).indices
    weight = scores.gather(1, choice) * dims.routed_scale
    local = choice - dims.held[0]
    mine = (local >= 0) & (local < dims.n_held)
    gates = torch.zeros((len(xf), dims.n_held), dtype=torch.float32, device=xf.device)
    gates.scatter_add_(1, local.clamp(0, dims.n_held - 1), torch.where(mine, weight, 0.0))
    zero = torch.where(choice >= dims.n_published, weight, 0.0).sum(-1)
    return gates, zero, choice


def _held(blk: LongcatBlock, dims: LongcatDims) -> list:
    return [(getattr(blk, f"gate_up_e{k}"), getattr(blk, f"down_e{k}")) for k in range(dims.n_held)]


def moe_rows(n1: torch.Tensor, blk: LongcatBlock, dims: LongcatDims, real: torch.Tensor, dtype):
    """This card's part of the expert layer over rows n1 [N, d] (f32; the
    prefill's positions), eager: each held expert over the real rows that
    chose it, and the zero experts. ``real`` [N] bool: rows that are not
    padding. Returns (output [N, d] f32, choice [N, top_k])."""
    h = n1.to(dtype)
    gates, zero, choice = route(n1, blk, dims)
    out = zero[:, None] * h.float()
    for k, (gate_up, down) in enumerate(_held(blk, dims)):
        rows = ((gates[:, k] != 0) & real).nonzero().squeeze(1)
        if rows.numel():
            out.index_add_(0, rows, swiglu(h[rows], gate_up, down) * gates[rows, k:k + 1])
    return out, choice


def moe_lanes(n1: torch.Tensor, blk: LongcatBlock, dims: LongcatDims, dtype, read: torch.Tensor | None = None):
    """This card's part of the expert layer over one token a lane, n1 [B,
    d] (f32), with static shapes and no host read on the card:
    ``moe_experts`` runs each held expert some lane chose, times its gates
    (and adds the experts it read to ``read``), and the zero experts'
    summed weight times n1 is added. Returns (output [B, d] f32, choice)."""
    h = n1.to(dtype)
    gates, zero, choice = route(n1, blk, dims)
    return moe_experts(h, gates, None, _held(blk, dims), read) + zero[:, None] * h.float(), choice


def _bmm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b batched, f32 result: on the card bf16 operands with f32 sums
    and output (as ``dense``), elsewhere in f32."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _kept(choice: torch.Tensor, dims: LongcatDims) -> torch.Tensor:
    return torch.zeros((len(choice), dims.n_experts), dtype=torch.bool, device=choice.device).scatter_(1, choice, True)


def _prefill_lanes(params: LongcatParams, dims: LongcatDims, ids, audio, attn_start, kv: torch.Tensor,
                   routes, counts, dtype) -> torch.Tensor:
    """``prefill`` over one group of lanes; ``kv`` [2L, b, C, 576] and
    ``routes`` [L, b, C, top_k] are the group's views."""
    b, p = ids.shape
    device = ids.device
    h, dn, dv = dims.n_head, dims.nope_dim, dims.v_dim
    col = torch.arange(p, device=device)
    cos, sin = rope_tables((col[None, :] - attn_start[:, None]).clamp_min(0), dims)   # pads at position 0
    real = col[None, :] >= attn_start[:, None]                                        # [b, P]
    keep = (col[None, :, None] >= col[None, None, :]) & real[:, None, :]               # [b, Sq, Sk]
    x = embed(params, dims, ids, audio, dtype)
    for li, blk in enumerate(params.blocks):
        for j in range(2):
            s = 2 * li + j
            hn = rms_norm(x, getattr(blk, f"ln_in_{j}"), dims.rms_eps).to(dtype)
            q_nope, q_rope, cols = _latent(hn, blk, j, dims, cos, sin)
            kv[s, :, :p] = cols.to(kv.dtype)
            c = kv[s, :, :p]
            kvb = dense(c[..., : dims.kv_rank], getattr(blk, f"kv_b_{j}")).to(dtype).view(b, p, h, dn + dv)
            k = torch.cat([kvb[..., :dn], c[:, :, None, dims.kv_rank:].expand(b, p, h, dims.rope_dim)], dim=-1)
            q = torch.cat([q_nope, q_rope], dim=-1).to(dtype)
            scores = _bmm_f32(q.transpose(1, 2).reshape(b * h, p, -1), k.permute(0, 2, 3, 1).reshape(b * h, -1, p))
            scores = (scores.view(b, h, p, p) * dims.attn_scale).masked_fill_(~keep[:, None], -1e30)
            probs = torch.softmax(scores, dim=-1).to(dtype).view(b * h, p, p)
            del scores, k, q
            att = _bmm_f32(probs, kvb[..., dn:].transpose(1, 2).reshape(b * h, p, dv))
            att = att.view(b, h, p, dv).transpose(1, 2).reshape(b, p, h * dv)
            del probs, kvb
            x = x + dense(att.to(dtype), getattr(blk, f"o_{j}")).to(dtype)
            n = rms_norm(x, getattr(blk, f"ln_post_{j}"), dims.rms_eps)
            ffn = swiglu(n.to(dtype), getattr(blk, f"gate_up_{j}"), getattr(blk, f"down_{j}"))
            if j == 0:
                m, choice = moe_rows(n.reshape(b * p, -1), blk, dims, real.reshape(-1), dtype)
                choice = torch.where(real.reshape(-1, 1), choice, -1)
                _record(routes, counts, li, choice, _kept(choice.clamp_min(0), dims) & real.reshape(-1, 1),
                        real, slice(0, p))
                x = x + ffn.to(dtype)
            else:
                x = x + (ffn + m.reshape(b, p, -1)).to(dtype)
    hf = rms_norm(x[:, -1], params.norm_w, dims.rms_eps).to(dtype)
    return dense(hf, params.head_w)


def prefill(params: LongcatParams, dims: LongcatDims, ids: torch.Tensor, audio: torch.Tensor,
            attn_start: torch.Tensor, kv: LatentKV, routes: torch.Tensor, counts: torch.Tensor,
            dtype) -> torch.Tensor:
    """The prompt, eagerly, into cache columns [0, P): ``ids`` [B, P]
    left-aligned (lane b's real tokens in columns [attn_start_b, P)), the
    audio placeholders among them filled from ``audio``; ``PREFILL_LANES``
    lanes a pass. Writes the latent columns, the routing record and the
    counts; returns the logits [B, V] (f32) after each lane's last token."""
    out = []
    for g in range(0, ids.shape[0], PREFILL_LANES):
        sl = slice(g, g + PREFILL_LANES)
        out.append(_prefill_lanes(params, dims, ids[sl], audio[sl], attn_start[sl], kv.c[:, sl], routes[:, sl],
                                  counts, dtype))
    return torch.cat(out)


def step(params: LongcatParams, dims: LongcatDims, tokens: torch.Tensor, pos: torch.Tensor,
         attn_start: torch.Tensor, col: torch.Tensor, kv: LatentKV, routes: torch.Tensor,
         counts: torch.Tensor, dtype, read: torch.Tensor) -> torch.Tensor:
    """One token a lane, ``tokens`` [B] at real positions ``pos`` [B] and
    cache column ``col`` (device int scalar, shared by the lanes): writes
    its latent columns and routing, adds each layer's held experts read to
    ``read`` [L] (int32), returns the logits [B, V] f32. Reads no host
    value: runtime/omni.py captures it as a CUDA graph."""
    b = tokens.shape[0]
    h, dn = dims.n_head, dims.nope_dim
    cos, sin = rope_tables(pos[:, None], dims)
    cols = col.view(1).long()
    valid = col.to(torch.int32).view(1).expand(b) + 1
    real = torch.ones(b, dtype=torch.bool, device=tokens.device)
    x = embed(params, dims, tokens[:, None], None, dtype)
    for li, blk in enumerate(params.blocks):
        for j in range(2):
            s = 2 * li + j
            hn = rms_norm(x, getattr(blk, f"ln_in_{j}"), dims.rms_eps).to(dtype)
            q_nope, q_rope, new = _latent(hn, blk, j, dims, cos, sin)
            kv.c[s].index_copy_(1, cols, new.to(kv.c.dtype))
            q_lat = torch.bmm(q_nope[:, 0].to(dtype).transpose(0, 1), getattr(blk, f"w_k_{j}"))  # [H, B, kv_rank]
            q = torch.cat([q_lat.transpose(0, 1), q_rope[:, 0].to(dtype)], dim=-1)              # [B, H, 576]
            lat = mla_decode(q, kv.c[s], attn_start, valid, dims.attn_scale, dims.kv_rank)       # [B, H, kv_rank]
            att = torch.bmm(lat.to(dtype).transpose(0, 1), getattr(blk, f"w_v_{j}").transpose(1, 2))
            x = x + dense(att.transpose(0, 1).reshape(b, 1, h * dims.v_dim), getattr(blk, f"o_{j}")).to(dtype)
            n = rms_norm(x, getattr(blk, f"ln_post_{j}"), dims.rms_eps)
            ffn = swiglu(n.to(dtype), getattr(blk, f"gate_up_{j}"), getattr(blk, f"down_{j}"))
            if j == 0:
                m, choice = moe_lanes(n[:, 0], blk, dims, dtype, read[li:li + 1])
                _record(routes, counts, li, choice, _kept(choice, dims), real, cols)
                x = x + ffn.to(dtype)
            else:
                x = x + (ffn + m[:, None]).to(dtype)
    hf = rms_norm(x[:, 0], params.norm_w, dims.rms_eps).to(dtype)
    return dense(hf, params.head_w)

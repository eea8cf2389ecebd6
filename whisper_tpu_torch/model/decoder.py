"""Text decoder with a preallocated, transposed self-attention KV cache.

Counterpart of ``whisper_tpu.model.decoder``:
  - embeddings: token_embedding[ids] + positional_embedding[pos], with the
    position clamped to [0, n_text_ctx - 1]
  - masked self-attention writes this step's K/V into the cache at column
    ``write_pos`` (a scalar shared by all lanes), then attends over the
    lane's columns [attn_start_b, query column]
  - cross-attention reads the precomputed, pre-scaled, transposed K/V
  - logits = ln(x) @ token_embedding^T

The cache is one stacked [L, B, H*Dh, C] pair per K and V. A step writes its
new column IN PLACE (never a copy of the cache: on large-v2 at B=8 a
whole-cache copy per step would cost more than the step): the prompt
ingest by slice assignment at a host column, a single-token step by
``index_copy_`` at ``write_pos`` given as a device int32 scalar, so that
the step reads no host value and can be captured as a CUDA graph. A
device column cannot be range-checked without a host read: the token
loops check ``p_max + n_max <= n_text_ctx`` once, before their first step.
Padded prompts are LEFT-aligned, so every lane's last real token sits in
the same column and the logits row is always the last row; lanes with
shorter prompts hold garbage in columns < ``attn_start``, which the mask
hides. Prompt ingest (S > 1) takes the einsum path; single-token steps take
the decode-attention kernel, for self- and cross-attention alike.

int8 caches (the serving tier): the self cache is int8 with one f32 scale
per column [L, B, 1, C]; each new column is quantized (``quantize_cols``)
and written, codes and scales, in place. The kernel reads codes and scales
directly; the einsum path of prompt ingest dequantizes to compute_dtype
first. Int8 weights carry ``<key>_s`` scales that every ``dense`` applies,
and an int8 token embedding ``tok_s``: gathered rows are dequantized, the
logits get a per-vocab-row scale. A token step's int8 products, the
logits' over the table included, go to the W8A16 kernel (``dense``), which
converts the codes in registers as XLA fused the conversion into the
product; the prompt ingest's larger products convert each weight first.

Tensor parallelism (``params.tp`` of size n > 1, ``parallel/sharding.py``):
a rank holds H/n heads, so its caches are [L, B, HD/n, C]; the out
projections and fc2 are row-parallel (``dense(..., tp=)``: all-reduce, then
the bias); the int8 caches' column scales take the max over every rank's rows
(a MAX all-reduce); the token table is split by vocabulary rows, so the
embedding is a masked lookup of the rank's rows plus an all-reduce and the
logits are the rank's columns gathered from every rank and cut back to
``n_vocab``. At n = 1 none of this launches anything.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.kernels.decode_attention import decode_attention_hd
from whisper_tpu_torch.kernels.quant import dequantize, quantize_cols
from whisper_tpu_torch.kernels.w8a16 import dense
from whisper_tpu_torch.model.layers import gelu, layer_norm, qkv_proj
from whisper_tpu_torch.model.params import Block, WhisperParams
from whisper_tpu_torch.parallel.group import SINGLE, AxisGroup


class SelfKV(NamedTuple):
    """Preallocated self-attention cache, TRANSPOSED [L, B, H*Dh, C]; when
    int8, k_s/v_s hold the per-column f32 scales [L, B, 1, C], else None."""

    k: torch.Tensor
    v: torch.Tensor
    k_s: torch.Tensor | None = None
    v_s: torch.Tensor | None = None


def init_self_kv(
    dims: ModelDims, batch: int, dtype: torch.dtype = torch.bfloat16,
    device: str | torch.device = "cuda", cache_len: int | None = None, quant: bool = False,
    tp: AxisGroup = SINGLE,
) -> SelfKV:
    """A zeroed self cache of ``batch`` lanes holding this rank's rows of
    ``tp`` (all of them unsharded)."""
    shape = (dims.n_text_layer, batch, tp.part(dims.n_text_state), cache_len or dims.n_text_ctx)
    if quant:
        sshape = shape[:2] + (1, shape[3])
        return SelfKV(torch.zeros(shape, dtype=torch.int8, device=device),
                      torch.zeros(shape, dtype=torch.int8, device=device),
                      torch.zeros(sshape, dtype=torch.float32, device=device),
                      torch.zeros(sshape, dtype=torch.float32, device=device))
    return SelfKV(torch.zeros(shape, dtype=dtype, device=device),
                  torch.zeros(shape, dtype=dtype, device=device))


def reorder_self_kv(kv: SelfKV, parent: torch.Tensor, col0: int, n_cols: int) -> None:
    """Beam search's cache reorder, in place: lane b of columns
    [col0, col0 + n_cols) of every cache tensor (codes and, when int8, the
    [L, B, 1, C] scale columns) takes lane ``parent[b]``'s. Columns outside
    the range are left alone: the prompt region is the same on every beam
    of an utterance, and columns past the last write are masked."""
    if n_cols <= 0:
        return
    for a in kv:
        if a is not None:
            gen = a[..., col0 : col0 + n_cols]
            gen.copy_(gen.index_select(1, parent))


def _cache_write(cache: torch.Tensor, li: int, new: torch.Tensor, col) -> None:
    """In-place column write: cache [L,B,HD,C], new [B,S,HD] at columns
    col..col+S-1 of layer li. A host ``col`` is checked: where JAX's
    dynamic_update_slice would clamp the start (and silently overwrite the
    last columns), this raises. A device ``col`` (int64 [1], S = 1) is
    written by ``index_copy_`` unchecked; its caller checks the range."""
    if isinstance(col, torch.Tensor):
        cache[li].index_copy_(2, col, new.transpose(1, 2))
        return
    s, c = new.shape[1], cache.shape[-1]
    if col < 0 or col + s > c:
        raise ValueError(f"cache write at columns [{col}, {col + s}) outside cache length {c}")
    cache[li, :, :, col : col + s] = new.transpose(1, 2)


def _cross_attention(h, blk: Block, xk, xv, xk_s, xv_s, n_head: int, compute_dtype,
                     cross_group: int = 1):
    """Cross-attention over transposed K/V [B/G, HD, Sx] (int8 with column
    scales xk_s/xv_s [B/G, 1, Sx], or None); ``cross_group`` G consecutive
    query lanes share one K/V lane. h: normalized input [B, S, d].
    Returns [B, S, HD] f32, HD = this rank's heads x Dh."""
    b, s, _ = h.shape
    q = dense(h, blk.xq_w, blk.xq_b, s=getattr(blk, "xq_w_s", None)).to(compute_dtype)
    d = q.shape[-1]
    if s == 1:
        out = decode_attention_hd(q.reshape(b, d, 1), xk, xv, n_head, k_scale=xk_s,
                                  v_scale=xv_s, kv_group=cross_group)
        return out.reshape(b, 1, d)
    if xk_s is not None:
        xk = dequantize(xk, xk_s, compute_dtype)
        xv = dequantize(xv, xv_s, compute_dtype)
    dh = d // n_head
    sx = xk.shape[-1]
    u = b // cross_group
    # grouped lanes fold into the row axis: cross-attention has no
    # positional mask, so beams and positions are interchangeable rows
    q4 = q.reshape(u, cross_group * s, n_head, dh).float()
    k4 = xk.reshape(u, n_head, dh, sx).float()
    v4 = xv.reshape(u, n_head, dh, sx).float()
    scores = torch.einsum("bthd,bhds->bhts", q4, k4)
    p = torch.softmax(scores, dim=-1).to(compute_dtype).float()
    out = torch.einsum("bhts,bhds->bthd", p, v4)
    return out.reshape(b, s, d)


def _self_attention(q, k_cache, v_cache, k_s, v_s, write_pos, attn_start, valid_len,
                    n_head: int, compute_dtype):
    """Masked self-attention over the transposed cache [B, HD, C] (int8 with
    column scales k_s/v_s [B, 1, C], or None).
    q [B,S,H,Dh]; queries sit at cache columns write_pos..write_pos+S-1;
    lane b attends keys [attn_start_b, query column]. Returns [B,S,d] f32."""
    b, s, h, dh = q.shape
    d = h * dh
    cache_len = k_cache.shape[-1]
    if s == 1:
        out = decode_attention_hd(q.reshape(b, d, 1), k_cache, v_cache, n_head,
                                  valid_len=valid_len, start=attn_start, k_scale=k_s, v_scale=v_s)
        return out.reshape(b, 1, d)
    if k_s is not None:
        k_cache = dequantize(k_cache, k_s, compute_dtype)
        v_cache = dequantize(v_cache, v_s, compute_dtype)
    k4 = k_cache.reshape(b, h, dh, cache_len).float()
    v4 = v_cache.reshape(b, h, dh, cache_len).float()
    scores = torch.einsum("bthd,bhds->bhts", q.float(), k4)
    key_idx = torch.arange(cache_len, device=q.device)[None, None, None, :]
    q_pos = (write_pos + torch.arange(s, device=q.device))[None, None, :, None]
    lo = attn_start[:, None, None, None]
    # -1e30 (not -inf): fully-masked pad query rows (q_pos < attn_start)
    # softmax to a harmless uniform instead of NaN
    keep = (key_idx <= q_pos) & (key_idx >= lo)
    scores = scores.masked_fill(~keep, -1e30)
    p = torch.softmax(scores, dim=-1).to(compute_dtype).float()
    out = torch.einsum("bhts,bhds->bthd", p, v4)
    return out.reshape(b, s, d)


def _decoder_block(x, blk: Block, kv: SelfKV, li: int, write_pos, attn_start, valid_len,
                   xk, xv, xk_s, xv_s, n_head: int, compute_dtype, cross_group: int = 1,
                   tp: AxisGroup = SINGLE):
    """One decoder block; writes layer li's new K/V columns (and, for an
    int8 cache, their scales) in place. x [B,S,d]; xk/xv [B/G,HD,Sx] with
    optional scales xk_s/xv_s [B/G,1,Sx]; ``n_head`` and HD are this
    rank's share of ``tp``. Returns x."""
    b, s, _ = x.shape
    quant = kv.k_s is not None

    h = layer_norm(x, blk.attn_ln_w, blk.attn_ln_b).to(compute_dtype)
    # an int8 cache quantizes the f32 projection, as the JAX package does
    q, k_new, v_new = qkv_proj(h, blk.qkv_w, blk.qkv_b, n_head,
                               dtype=torch.float32 if quant else compute_dtype,
                               qkv_s=getattr(blk, "qkv_w_s", None))
    q = q.to(compute_dtype)
    k_new, v_new = k_new.reshape(b, s, -1), v_new.reshape(b, s, -1)
    if quant:
        for cache, scales, new in ((kv.k, kv.k_s, k_new), (kv.v, kv.v_s, v_new)):
            # int8 [B,S,HD], f32 [B,S,1]; each scale the max over all ranks' rows
            codes, sc = quantize_cols(new, axis=-1, reduce_max=tp.max)
            _cache_write(cache, li, codes, write_pos)
            _cache_write(scales, li, sc, write_pos)
        k_s, v_s = kv.k_s[li], kv.v_s[li]
    else:
        _cache_write(kv.k, li, k_new.to(kv.k.dtype), write_pos)
        _cache_write(kv.v, li, v_new.to(kv.v.dtype), write_pos)
        k_s = v_s = None
    att = _self_attention(q, kv.k[li], kv.v[li], k_s, v_s, write_pos, attn_start, valid_len,
                          n_head, compute_dtype)
    x = x + dense(att.to(compute_dtype), blk.o_w, blk.o_b,
                  s=getattr(blk, "o_w_s", None), tp=tp).to(compute_dtype)

    h = layer_norm(x, blk.x_ln_w, blk.x_ln_b).to(compute_dtype)
    att = _cross_attention(h, blk, xk, xv, xk_s, xv_s, n_head, compute_dtype, cross_group)
    x = x + dense(att.to(compute_dtype), blk.xo_w, blk.xo_b,
                  s=getattr(blk, "xo_w_s", None), tp=tp).to(compute_dtype)

    h = layer_norm(x, blk.mlp_ln_w, blk.mlp_ln_b).to(compute_dtype)
    h = gelu(dense(h, blk.fc1_w, blk.fc1_b, s=getattr(blk, "fc1_w_s", None))).to(compute_dtype)
    return x + dense(h, blk.fc2_w, blk.fc2_b, s=getattr(blk, "fc2_w_s", None),
                     tp=tp).to(compute_dtype)


def decode_step(
    params: WhisperParams,
    dims: ModelDims,
    tokens: torch.Tensor,        # [B, S] int (left-aligned if padded)
    pos0: torch.Tensor,          # [B] int32: REAL position of tokens[:, 0]
    self_kv: SelfKV,             # [L, B, HD, C] x2 (+ int8 scales), written in place
    cross_kv,                    # (k, v) [L, B/G, HD, Sx] x2, or a CrossKV (+ int8 scales)
    write_pos=0,                 # cache column of tokens[:, 0]: a host int, or for S = 1
                                 # a device int32 scalar
    attn_start: torch.Tensor | None = None,  # [B] int32 first valid cache column
    compute_dtype: torch.dtype = torch.bfloat16,
    last_only: bool = True,
    cross_group: int = 1,
):
    """Run the decoder on S tokens at cache columns write_pos..write_pos+S-1.

    ``pos0`` is the real (unpadded) position used for positional embeddings;
    for a left-padded prompt of true length n in a [B, P] buffer it is n - P
    (pad rows clamp to position 0: their outputs are masked garbage).
    Returns (logits, self_kv): logits [B, n_vocab] f32 when ``last_only``,
    else [B, S, n_vocab]; self_kv is the same cache, updated in place.

    A single-token step (S = 1) reads no host value when ``write_pos`` and
    ``attn_start`` are device tensors: the token loops capture it in a CUDA
    graph. A host ``write_pos`` there is checked against the cache length
    and becomes a device scalar. Prompt ingest (S > 1) takes a host int.
    """
    dec = params.dec
    b, s = tokens.shape
    device = tokens.device
    if attn_start is None:
        attn_start = torch.zeros((b,), dtype=torch.int32, device=device)
    valid_len = None
    if s == 1:
        if not isinstance(write_pos, torch.Tensor):
            c = self_kv.k.shape[-1]
            if not 0 <= int(write_pos) < c:
                raise ValueError(f"cache write at column {int(write_pos)} outside cache length {c}")
            write_pos = torch.full((), int(write_pos), dtype=torch.int32, device=device)
        # keys < write_pos + 1, one [B] vector for all layers; the column index
        # of the K/V write, int64 [1]
        valid_len = write_pos.to(torch.int32).view(1).expand(b) + 1
        write_pos = write_pos.view(1).long()
    else:
        write_pos = int(write_pos)

    xk_s = cross_kv[2] if len(cross_kv) > 2 else None
    xv_s = cross_kv[3] if len(cross_kv) > 2 else None
    tok_s = getattr(dec, "tok_s", None)
    tp = params.tp
    n_head = tp.part(dims.n_text_head)

    n_ctx = dec.pos.shape[0]
    pos_idx = (pos0.long()[:, None] + torch.arange(s, device=device)[None, :]).clamp(0, n_ctx - 1)
    x = (_embed(dec, tokens.long(), tp) + dec.pos[pos_idx]).to(compute_dtype)

    for li, blk in enumerate(dec.blocks):
        x = _decoder_block(x, blk, self_kv, li, write_pos, attn_start, valid_len,
                           cross_kv[0][li], cross_kv[1][li],
                           None if xk_s is None else xk_s[li], None if xv_s is None else xv_s[li],
                           n_head, compute_dtype, cross_group, tp)

    x = layer_norm(x, dec.ln_w, dec.ln_b)        # [B, S, d] f32
    if last_only:
        x = x[:, -1]
    # int8 table: its codes, read transposed, with the per-vocab-row scale as
    # the epilogue ([V, 1] -> [1, V])
    tok = dec.tok.T if tok_s is not None else dec.tok.T.to(compute_dtype)
    logits = dense(x.to(compute_dtype), tok, s=None if tok_s is None else tok_s.T)
    if tp.size > 1:          # the rank's vocab columns, gathered; the pad rows cut
        logits = tp.gather(logits)[..., : dims.n_vocab]
    return logits, self_kv


def _embed(dec, tokens: torch.Tensor, tp: AxisGroup) -> torch.Tensor:
    """Token embedding rows of ``tokens`` (int64), dequantized for an int8
    table. Under tensor parallelism a rank holds rows [r*V', (r+1)*V') of
    the (padded) table: it looks up the tokens it holds, zeros the others,
    and the ranks' rows are summed (all-reduce, f32)."""
    tok_s = getattr(dec, "tok_s", None)
    if tp.size > 1:
        rows = dec.tok.shape[0]
        tokens = tokens - tp.rank * rows
        held = (tokens >= 0) & (tokens < rows)
        tokens = torch.where(held, tokens, 0)
    emb = dec.tok[tokens]
    if tok_s is not None:                        # int8 embedding: dequantize the gathered rows
        emb = emb.float() * tok_s[tokens]
    if tp.size > 1:
        emb = tp.sum(torch.where(held[..., None], emb.float(), 0.0))
    return emb

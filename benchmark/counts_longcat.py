"""The work of a longcat window (LongCat-Flash-Omni's audio-to-text path, one card's expert share), in operations and bytes.

Counted from the configuration's published sizes, whatever implements
them: each input byte read once, each output byte written once, a product
of m x k by k x n 2mkn operations. Latent attention is counted in its
expanded form (``kv_b`` over a position's latent once, then every head's
192-wide keys and 128-wide values), the held routed experts as the routing
chose them, a zero expert as one scaled add of n1. So a change that fuses,
absorbs or replaces a kernel leaves this yardstick as it is. The card's
peaks are ``benchmark/counts.py``'s.
"""

from __future__ import annotations

import numpy as np

from benchmark.counts import BF16_FLOPS, HBM_BYTES_PER_S

BF16, F32 = 2, 4


class LongcatWork:
    """Parameters, operations and a token step's bytes of one configuration
    (``cfg``: the configuration file's keys)."""

    def __init__(self, cfg: dict):
        self.d = d = cfg["hidden_size"]
        self.layers = cfg["num_layers"]
        self.heads = h = cfg["num_attention_heads"]
        self.vocab = cfg["vocab_size"]
        self.kv_rank = cfg["kv_lora_rank"]
        self.rope = cfg["qk_rope_head_dim"]
        self.nope, self.v = cfg["qk_nope_head_dim"], cfg["v_head_dim"]
        q_rank = cfg["q_lora_rank"]
        share = cfg["expert_share"]
        self.held = tuple(share["held"])
        self.published = share["published"]
        self.n_experts = self.published + cfg["zero_expert_num"]
        # weights of one attention sublayer, of one dense FFN, of one routed expert
        self.attn = (d * q_rank + q_rank * h * (self.nope + self.rope) + d * (self.kv_rank + self.rope)
                     + self.kv_rank * h * (self.nope + self.v) + h * self.v * d)
        self.attn_norms = q_rank + self.kv_rank + 2 * d
        self.ffn = 3 * d * cfg["ffn_hidden_size"]
        self.expert = 3 * d * cfg["expert_ffn_hidden_size"]
        self.router = self.n_experts * d
        a = cfg["audio_config"]
        self.wd, self.enc_layers, self.enc_ffn = a["whisper_hidden_size"], a["whisper_encoder_layers"], a["whisper_encoder_ffn_dim"]
        self.n_mels, self.frames = a["whisper_num_mel_bins"], a["whisper_max_source_positions"]
        self.pool = round(50 * a["whisper_audio_time"] / a["whisper_query_tokens_size"])

    @property
    def latent_bytes(self) -> int:
        """One cache column of one sublayer."""
        return BF16 * (self.kv_rank + self.rope)

    def layer_params(self) -> int:
        """Every weight of one double layer this card holds: two attention
        sublayers and two dense FFNs with their norms, the router and its
        bias, the held experts."""
        return (2 * (self.attn + self.attn_norms + self.ffn) + self.router + self.n_experts
                + (self.held[1] - self.held[0]) * self.expert)

    def encode_flops(self, lanes: int) -> float:
        """The Whisper stand-in encoder over ``lanes`` 30 s windows, and the connector."""
        t, w = self.frames, self.wd
        stem = 2 * (2 * t) * 3 * self.n_mels * w + 2 * t * 3 * w * w
        block = 2 * t * w * (4 * w + 2 * self.enc_ffn) + 4 * t * t * w
        return lanes * (stem + self.enc_layers * block + 2 * (t // self.pool) * w * self.d)

    def token_flops(self, keys: np.ndarray, held: np.ndarray, zero: np.ndarray) -> float:
        """Tokens through the language model (arrays of one entry a token),
        each attending ``keys`` keys (its own and those before it) in each
        of its 2L sublayers, with ``held`` held-expert and ``zero``
        zero-expert choices over all its layers; no logits."""
        dense = self.layers * 2 * (2 * (self.attn + self.ffn) + self.router)
        attn = 2 * self.layers * 2 * self.heads * (self.nope + self.rope + self.v)
        return float(len(keys) * dense + attn * np.sum(keys) + 2 * self.expert * np.sum(held)
                     + 2 * self.d * np.sum(zero))

    def logits_flops(self) -> float:
        return 2.0 * self.d * self.vocab

    def mla_call(self, keys: np.ndarray) -> tuple[float, float]:
        """One call of the step's latent attention (``mla_decode``) over
        len(keys) lanes of 64 heads: (bytes, operations). Each lane's cache
        rows read once, its query read and its output written once; scores
        over 576 columns and values over 512 a key."""
        b, h = len(keys), self.heads
        width = self.kv_rank + self.rope
        nbytes = self.latent_bytes * int(np.sum(keys)) + b * h * width * BF16 + b * h * self.kv_rank * F32
        flops = 2.0 * h * (width + self.kv_rank) * int(np.sum(keys))
        return float(nbytes), flops

    def mla_bound_s(self, keys: np.ndarray) -> float:
        nbytes, flops = self.mla_call(keys)
        return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)

    def step_bytes(self, touched: np.ndarray, keys: np.ndarray) -> float:
        """One token step of len(keys) lanes: every weight this card holds
        but the held experts (bf16; norms, the router and its bias f32),
        each held expert some lane chose in a layer once (``touched`` [L]:
        how many in each), the head, the latent columns each lane reads
        (``keys``: its keys, this step's included) and writes in each of the
        2L sublayers, the embedding rows read and the logits written (f32)."""
        b = len(keys)
        weights = (self.layers * (BF16 * 2 * (self.attn + self.ffn) + F32 * (2 * self.attn_norms + self.router
                                                                           + self.n_experts))
                   + BF16 * self.expert * int(np.sum(touched)) + BF16 * self.vocab * self.d + F32 * self.d)
        cache = 2 * self.layers * self.latent_bytes * (int(np.sum(keys)) + b)
        return float(weights + cache + b * self.d * BF16 + b * self.vocab * F32)

    def step_bound_s(self, touched: np.ndarray, keys: np.ndarray) -> float:
        """The least time of one token step on the card: its bytes at 3.35
        TB/s (its operations at 989 TFLOP/s take ~6x less at 64 lanes)."""
        return self.step_bytes(touched, keys) / HBM_BYTES_PER_S

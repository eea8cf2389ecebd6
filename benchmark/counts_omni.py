"""The work of an omni window (Uni-MoE-2.0-Omni's audio-to-text path), in operations and bytes.

Counted from the configuration's published sizes, whatever implements
them, with the routed experts as the routing chose them (a null expert
computes nothing): each input byte read once, each output byte written
once, a product of m x k by k x n 2mkn operations. So a change that fuses
or replaces a kernel leaves this yardstick as it is. The card's peaks are
``benchmark/counts.py``'s.
"""

from __future__ import annotations

import numpy as np

from benchmark.counts import HBM_BYTES_PER_S

BF16, F32 = 2, 4


class OmniWork:
    """Parameters, operations and a token step's bytes of one configuration
    (``cfg``: the configuration file's keys)."""

    def __init__(self, cfg: dict):
        self.d = d = cfg["hidden_size"]
        self.layers = cfg["num_hidden_layers"]
        self.kv = cfg["num_key_value_heads"] * d // cfg["num_attention_heads"]
        self.vocab = cfg["vocab_size"]
        self.n_routed = cfg["mlp_dynamic_expert_num"]
        self.n_experts = self.n_routed + cfg["mlp_dynamic_null_expert_num"]
        # weights of one layer, by part
        self.attn = 2 * d * d + 2 * d * self.kv                    # q, o; k, v
        self.attn_bias = d + 2 * self.kv
        self.expert = 3 * d * cfg["dynamic_intermediate_size"]   # gate, up, down of one routed expert
        self.shared = cfg["mlp_fixed_expert_num"] * 3 * d * cfg["shared_intermediate_size"]
        self.router = self.n_experts * d
        self.norms = 2 * d
        self.wd = cfg["whisper_hidden_size"]
        self.enc_layers = cfg["whisper_encoder_layers"]
        self.enc_ffn = cfg["whisper_encoder_ffn_dim"]
        self.n_mels = cfg["whisper_num_mel_bins"]
        self.frames = cfg["whisper_max_source_positions"]
        self.pool = round(50 * cfg["whisper_audio_time"] / cfg["whisper_query_tokens_size"])

    def layer_params(self) -> int:
        """Every weight of one language-model layer, every routed expert held."""
        return self.attn + self.attn_bias + self.n_routed * self.expert + self.shared + self.router + self.norms

    def encode_flops(self, lanes: int) -> float:
        """The Whisper encoder over ``lanes`` 30 s windows, and the connector."""
        t, w = self.frames, self.wd
        stem = 2 * (2 * t) * 3 * self.n_mels * w + 2 * t * 3 * w * w
        block = 2 * t * w * (4 * w + 2 * self.enc_ffn) + 4 * t * t * w
        connector = 2 * (t // self.pool) * w * self.d
        return lanes * (stem + self.enc_layers * block + connector)

    def token_flops(self, keys: np.ndarray, routed: np.ndarray) -> float:
        """Tokens through the language model, each attending ``keys`` keys
        (its own and those before it) with ``routed`` routed experts chosen
        over all its layers (arrays of one entry a token); no logits."""
        dense = self.layers * 2 * (self.attn + self.shared + self.router)
        return float(len(keys) * dense + 2 * self.expert * np.sum(routed)
                     + self.layers * 4 * self.d * np.sum(keys))

    def logits_flops(self) -> float:
        return 2.0 * self.d * self.vocab

    def step_bytes(self, touched: np.ndarray, keys: np.ndarray) -> float:
        """One token step of len(keys) lanes: every weight but the routed
        experts' (bf16; norms, biases and the router f32), each routed
        expert that some lane chose in a layer once (``touched`` [L]: how
        many in each), the head, the K/V columns each lane reads (``keys``:
        its keys, this step's included) and writes, the embedding rows read
        and the logits written (f32)."""
        b = len(keys)
        weights = (self.layers * (BF16 * (self.attn + self.shared) + F32 * (self.attn_bias + self.router + self.norms))
                   + BF16 * self.expert * int(np.sum(touched)) + BF16 * self.vocab * self.d + F32 * self.d)
        cache = self.layers * 2 * self.kv * BF16 * (int(np.sum(keys)) + b)
        return float(weights + cache + b * self.d * BF16 + b * self.vocab * F32)

    def step_bound_s(self, touched: np.ndarray, keys: np.ndarray) -> float:
        """The least time of one token step on the card: its bytes at 3.35
        TB/s (its operations at 989 TFLOP/s are ~100x less at 8 lanes)."""
        return self.step_bytes(touched, keys) / HBM_BYTES_PER_S

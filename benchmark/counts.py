"""The work a window needs, in operations and bytes, and the card's peaks.

Counted from the shapes of the function, whatever implements it: each
input byte read once, each output byte written once, and the operations
the algorithm needs (a product of m x k by k x n is 2mkn). So a later
change that fuses, replaces or removes a kernel leaves this yardstick as
it is. The arithmetic of K1's and K2's bounds is ``chip_smoke.py``'s
(``flash_case``, ``decode_case``).

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the 700 W
power limit): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s of HBM3.
"""

from __future__ import annotations

BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12


def k1_bound_s(b: int, t: int, n_head: int, dh: int) -> float:
    """K1 (``flash_attention``), one call: non-causal attention of B lanes,
    T queries and keys, bf16 q/k/v in and out."""
    flops = 4 * b * n_head * t * t * dh
    nbytes = 4 * b * t * n_head * dh * 2
    return max(flops / BF16_FLOPS, nbytes / HBM_BYTES_PER_S)


def k2_bound_s(keys: list[int], hd: int, kv_bytes: int) -> float:
    """K2 (``decode_attention_hd``), one call: one bf16 query per lane over
    that lane's ``keys`` keys of K and V (``kv_bytes`` each element: 2 bf16,
    1 int8 with a 4-byte scale per key), f32 out."""
    n_keys = sum(keys)
    kv = 2 * n_keys * hd * kv_bytes + (2 * n_keys * 4 if kv_bytes == 1 else 0)
    nbytes = len(keys) * hd * 2 + kv + len(keys) * hd * 4
    flops = 2 * hd * 2 * n_keys
    return max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOPS)


class Work:
    """Operations and bounds of one configuration's windows (``dims``: a
    ``benchmark.inputs.Dims``; ``kv_int8``: the tier's caches)."""

    def __init__(self, dims, kv_int8: bool):
        self.dims = dims
        self.kv_bytes = 1 if kv_int8 else 2

    def k1_bound_s(self, lanes: int) -> float:
        """One encode of ``lanes`` windows: K1 in every encoder layer."""
        d = self.dims
        return d.enc_layers * k1_bound_s(lanes, d.n_audio_ctx, d.enc_heads, d.d // d.enc_heads)

    def k2_bound_s(self, prompt_lens: list[int], steps: int) -> float:
        """One window decode of len(prompt_lens) lanes for ``steps`` token
        steps: K2 over the cross K/V and over the self cache (a lane's prompt
        and the tokens so far) in every decoder layer. The prompt's ingest
        is not K2's."""
        d = self.dims
        cross = k2_bound_s([d.n_audio_ctx] * len(prompt_lens), d.d, self.kv_bytes)
        total = 0.0
        for i in range(steps):
            total += cross + k2_bound_s([p + i + 1 for p in prompt_lens], d.d, self.kv_bytes)
        return d.dec_layers * total

    def encode_flops(self, lanes: int) -> float:
        """Conv stem, encoder blocks and every decoder layer's cross K/V."""
        d = self.dims
        t, w = d.n_audio_ctx, d.d
        stem = 2 * (2 * t) * 3 * d.n_mels * w + 2 * t * 3 * w * w
        block = 2 * t * w * (3 * w + w + 2 * d.ffn) + 4 * t * t * w
        cross = d.dec_layers * 2 * (2 * t * w * w)
        return lanes * (stem + d.enc_layers * block + cross)

    def token_flops(self, keys: int) -> float:
        """One token through the decoder, attending ``keys`` keys of its own
        and the whole audio, with its row of logits."""
        d = self.dims
        w = d.d
        layer = 2 * w * (3 * w + w + w + w + 2 * d.ffn) + 4 * w * keys + 4 * w * d.n_audio_ctx
        return d.dec_layers * layer

    def window_flops(self, prompt_len: int, steps: int) -> float:
        """One lane's decode: its real prompt tokens (one row of logits) and
        ``steps`` token steps (a row of logits each)."""
        logits = 2 * self.dims.d * self.dims.n_vocab
        ingest = sum(self.token_flops(p + 1) for p in range(prompt_len)) + logits
        return ingest + sum(self.token_flops(prompt_len + i + 1) + logits for i in range(steps))

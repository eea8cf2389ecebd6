"""What the benchmark makes from ``--seed`` and hands to both sides: the raw
weights in the checkpoint's layout, the audio, and the mel filterbank.

The weights are drawn on the device by one ``torch.Generator`` in a few
large calls, stacked over layers, in the types a checkpoint holds them in:
matmul weights, convolutions and embeddings in bfloat16 (the layout of
OpenAI's ``state_dict``: [out, in], q, k and v apart, the key without a
bias), norms and biases in float32. The same seed draws the same values in
the same order, so the reference draws them again after the window
instead of keeping a copy on the card.

Audio is PCM drawn on the device (tones that glide, noise, a slow
envelope) and copied to the host, where a user's decoded file would be.
Its content does not change the cost of a window: the weights are random.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *stream: int) -> int:
    """A 63-bit seed for one stream of ``seed``'s draws (any whole number)."""
    ss = np.random.SeedSequence([seed % 2**64, *stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Dims:
    """A configuration file's model sizes, under OpenAI's ``config.json`` names."""

    def __init__(self, cfg: dict):
        self.d = cfg["d_model"]
        self.n_mels = cfg["num_mel_bins"]
        self.n_vocab = cfg["vocab_size"]
        self.n_audio_ctx = cfg["max_source_positions"]
        self.n_text_ctx = cfg["max_target_positions"]
        self.enc_layers = cfg["encoder_layers"]
        self.dec_layers = cfg["decoder_layers"]
        self.enc_heads = cfg["encoder_attention_heads"]
        self.dec_heads = cfg["decoder_attention_heads"]
        self.ffn = cfg["encoder_ffn_dim"]
        if cfg["decoder_ffn_dim"] != self.ffn:
            raise ValueError("encoder_ffn_dim and decoder_ffn_dim differ")

    @property
    def window_frames(self) -> int:
        """Mel frames of one window (3000 for 30 s)."""
        return 2 * self.n_audio_ctx


def draw_raw(dims: Dims, seed: int, device) -> dict:
    """The raw weights of one model, drawn from ``seed`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 1))
    bf16, f32 = torch.bfloat16, torch.float32
    d, f = dims.d, dims.ffn

    def randn(*shape, scale, dtype=bf16):
        return (torch.randn(shape, generator=gen, device=device) * scale).to(dtype)

    def blocks(n: int, cross: bool) -> dict:
        proj = randn(n, 8 if cross else 4, d, d, scale=d ** -0.5)
        vec = randn(n, 16 if cross else 9, d, scale=0.02, dtype=f32)
        b = {"q_w": proj[:, 0], "k_w": proj[:, 1], "v_w": proj[:, 2], "o_w": proj[:, 3],
             "fc1_w": randn(n, f, d, scale=d ** -0.5), "fc2_w": randn(n, d, f, scale=f ** -0.5),
             "fc1_b": randn(n, f, scale=0.02, dtype=f32),
             "q_b": vec[:, 0], "v_b": vec[:, 1], "o_b": vec[:, 2], "fc2_b": vec[:, 3],
             "attn_ln_w": 1 + vec[:, 4] * 2.5, "attn_ln_b": vec[:, 5],
             "mlp_ln_w": 1 + vec[:, 6] * 2.5, "mlp_ln_b": vec[:, 7]}
        if cross:
            b.update(xq_w=proj[:, 4], xk_w=proj[:, 5], xv_w=proj[:, 6], xo_w=proj[:, 7],
                     xq_b=vec[:, 9], xv_b=vec[:, 10], xo_b=vec[:, 11],
                     x_ln_w=1 + vec[:, 12] * 2.5, x_ln_b=vec[:, 13])
        return b

    enc_vec = randn(4, d, scale=0.02, dtype=f32)
    dec_vec = randn(2, d, scale=0.02, dtype=f32)
    return {
        "enc": {
            "conv1_w": randn(d, dims.n_mels, 3, scale=(3 * dims.n_mels) ** -0.5),
            "conv1_b": enc_vec[0],
            "conv2_w": randn(d, d, 3, scale=(3 * d) ** -0.5),
            "conv2_b": enc_vec[1],
            "pos": randn(dims.n_audio_ctx, d, scale=0.02),
            "ln_post_w": 1 + enc_vec[2] * 2.5, "ln_post_b": enc_vec[3],
            "blocks": blocks(dims.enc_layers, cross=False),
        },
        "dec": {
            "tok": randn(dims.n_vocab, d, scale=0.02),
            "pos": randn(dims.n_text_ctx, d, scale=0.02),
            "ln_w": 1 + dec_vec[0] * 2.5, "ln_b": dec_vec[1],
            "blocks": blocks(dims.dec_layers, cross=True),
        },
    }


def draw_pcm(seed: int, index: int, seconds: float, device) -> torch.Tensor:
    """Item ``index`` of ``seed``'s audio: ``seconds`` of 16 kHz float32 PCM,
    on the host. Four tones gliding over 80-3000 Hz under a slow envelope,
    with noise at about -30 dB."""
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, 2, index))
    n = int(round(seconds * 16_000))
    t = torch.arange(n, device=device, dtype=torch.float64) / 16_000
    par = torch.rand((4, 4), generator=gen, device=device, dtype=torch.float64)
    f0 = 80 + 2920 * par[:, 0:1]
    glide = (par[:, 1:2] - 0.5) * 40
    phase = 2 * torch.pi * (f0 * t + glide * torch.sin(2 * torch.pi * 0.05 * t)) + 6.3 * par[:, 2:3]
    env = 0.5 + 0.5 * torch.sin(2 * torch.pi * (0.1 + 0.4 * par[:, 3:4]) * t)
    pcm = (0.1 * env * torch.sin(phase)).sum(0)
    pcm = pcm + 0.01 * torch.randn(n, generator=gen, device=device, dtype=torch.float64)
    return pcm.float().cpu()

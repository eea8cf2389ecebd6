#!/usr/bin/env python3
"""Convert a HuggingFace Whisper checkpoint to classic GGML format.

Counterpart of ``tools/convert_hf_to_ggml.py``, on the port's ``ggml``
writer and ``features.filters``; it writes the same bytes. The GGML file is
the framework's native checkpoint (same bytes the reference loads,
WhisperModel.cpp:434-492). Usage:

  python -m whisper_tpu_torch.tools.convert_hf_to_ggml --model openai/whisper-base.en --out ggml-base.en.bin

Requires the HF model to be available locally (offline cache works).
"""

from __future__ import annotations

import argparse
import os
from collections.abc import Sequence

import numpy as np

from whisper_tpu_torch.features.filters import mel_filter_bank
from whisper_tpu_torch.ggml import MelFilters, write_checkpoint_file
from whisper_tpu_torch.hparams import ModelDims


def hf_to_ggml_tensors(sd: dict, dims: ModelDims) -> dict[str, np.ndarray]:
    """Map transformers state-dict names to whisper.cpp GGML names
    (the inverse of tests/test_model_vs_torch.py's mapping)."""
    pairs = [
        ("self_attn_layer_norm", "attn_ln", True),
        ("self_attn.q_proj", "attn.query", True),
        ("self_attn.k_proj", "attn.key", False),
        ("self_attn.v_proj", "attn.value", True),
        ("self_attn.out_proj", "attn.out", True),
        ("final_layer_norm", "mlp_ln", True),
        ("fc1", "mlp.0", True),
        ("fc2", "mlp.2", True),
    ]
    xpairs = [
        ("encoder_attn_layer_norm", "cross_attn_ln", True),
        ("encoder_attn.q_proj", "cross_attn.query", True),
        ("encoder_attn.k_proj", "cross_attn.key", False),
        ("encoder_attn.v_proj", "cross_attn.value", True),
        ("encoder_attn.out_proj", "cross_attn.out", True),
    ]

    def g(name):
        return np.asarray(sd[name], np.float32)

    t: dict[str, np.ndarray] = {}
    t["encoder.positional_embedding"] = g("model.encoder.embed_positions.weight")
    for cv in ("conv1", "conv2"):
        t[f"encoder.{cv}.weight"] = g(f"model.encoder.{cv}.weight")
        t[f"encoder.{cv}.bias"] = g(f"model.encoder.{cv}.bias")
    t["encoder.ln_post.weight"] = g("model.encoder.layer_norm.weight")
    t["encoder.ln_post.bias"] = g("model.encoder.layer_norm.bias")
    for i in range(dims.n_audio_layer):
        for hf, gg, bias in pairs:
            t[f"encoder.blocks.{i}.{gg}.weight"] = g(f"model.encoder.layers.{i}.{hf}.weight")
            if bias:
                t[f"encoder.blocks.{i}.{gg}.bias"] = g(f"model.encoder.layers.{i}.{hf}.bias")
    for i in range(dims.n_text_layer):
        for hf, gg, bias in pairs + xpairs:
            t[f"decoder.blocks.{i}.{gg}.weight"] = g(f"model.decoder.layers.{i}.{hf}.weight")
            if bias:
                t[f"decoder.blocks.{i}.{gg}.bias"] = g(f"model.decoder.layers.{i}.{hf}.bias")
    t["decoder.token_embedding.weight"] = g("model.decoder.embed_tokens.weight")
    t["decoder.positional_embedding"] = g("model.decoder.embed_positions.weight")
    t["decoder.ln.weight"] = g("model.decoder.layer_norm.weight")
    t["decoder.ln.bias"] = g("model.decoder.layer_norm.bias")
    return t


def hf_vocab_words(tokenizer, n_vocab: int) -> list[bytes]:
    """Byte-level GPT-2 vocab -> raw UTF-8 byte strings (whisper.cpp vocab
    convention: stored tokens are the decoded bytes)."""
    # byte-level BPE: map unicode chars back to bytes
    from transformers.models.gpt2.tokenization_gpt2 import bytes_to_unicode

    byte_decoder = {v: k for k, v in bytes_to_unicode().items()}
    words = []
    vocab = tokenizer.get_vocab()
    id_to_tok = {i: s for s, i in vocab.items()}
    count = min(n_vocab, len(id_to_tok))
    for i in range(count):
        s = id_to_tok.get(i, "")
        try:
            b = bytes(byte_decoder[c] for c in s)
        except KeyError:
            b = s.encode("utf-8")
        words.append(b)
    return words


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", required=True, help="HF model id or local path")
    ap.add_argument("--out", required=True)
    ap.add_argument("--f32", action="store_true", help="store weights as f32")
    args = ap.parse_args(argv)

    import torch
    from transformers import WhisperForConditionalGeneration, WhisperTokenizer

    model = WhisperForConditionalGeneration.from_pretrained(args.model)
    tok = WhisperTokenizer.from_pretrained(args.model)
    c = model.config
    dims = ModelDims(
        n_vocab=c.vocab_size,
        n_audio_ctx=c.max_source_positions,
        n_audio_state=c.d_model,
        n_audio_head=c.encoder_attention_heads,
        n_audio_layer=c.encoder_layers,
        n_text_ctx=c.max_target_positions,
        n_text_state=c.d_model,
        n_text_head=c.decoder_attention_heads,
        n_text_layer=c.decoder_layers,
        n_mels=c.num_mel_bins,
        ftype=0 if args.f32 else 1,
    )
    with torch.no_grad():
        sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tensors = hf_to_ggml_tensors(sd, dims)
    filters = mel_filter_bank(dims.n_mels)
    words = hf_vocab_words(tok, dims.n_vocab)

    write_checkpoint_file(
        args.out, dims,
        MelFilters(filters.shape[0], filters.shape[1], filters),
        words, tensors, use_f16=not args.f32,
    )
    print(f"wrote {args.out} ({os.path.getsize(args.out)/1e6:.1f} MB)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

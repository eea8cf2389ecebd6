"""Synthetic (random-weight) parameters, built directly on the device.

Counterpart of ``whisper_tpu.tools.synthetic``. Benchmarks need
flagship-sized models without checkpoint files; drawing the weights on the
device from a ``torch.Generator`` there avoids pushing gigabytes from the
host. The numbers differ from the JAX package's (another generator); the
tree's keys, shapes and dtypes, the scales of the draws and the int8
quantization are the same.
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.hparams import KNOWN_MODELS, ModelDims
from whisper_tpu_torch.model.params import _QUANT_KEYS, DtypePolicy, WhisperParams, params_from_tensors

TIERS = {                # tier -> (dtype policy, int8 K/V caches)
    "serving": (DtypePolicy.serving(), True),
    "bf16": (DtypePolicy(), False),
    "f32": (DtypePolicy.f32(), False),
}


def quantize_int8(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one f32 scale per slice along axis -2 (the
    contraction axis of an [.., in, out] weight), on w's device: the JAX
    package's formula (``tools/synthetic.py``'s ``_q``) in f32, as XLA
    compiles it: the division by the constant 127 becomes a product with its
    f32 reciprocal, so the scales and codes match the JAX tree's bit for
    bit."""
    w = w.float()
    amax = w.abs().amax(dim=-2, keepdim=True)
    sc = amax.clamp_min(1e-8) * torch.tensor(1.0 / 127.0, dtype=torch.float32)
    return torch.clamp(torch.round(w / sc), -127, 127).to(torch.int8), sc


def make_synthetic_params(
    dims: ModelDims, param_dtype: torch.dtype = torch.bfloat16,
    norm_dtype: torch.dtype = torch.float32, seed: int = 0, weights_int8: bool = False,
    device: str | torch.device = "cuda",
) -> WhisperParams:
    """Random params with the structure of ``params_from_checkpoint``'s.
    ``weights_int8`` mirrors DtypePolicy.serving(): int8 decoder matmul
    weights and token table with per-output-column f32 scales, quantized on
    the device."""
    device = resolve_device(device)
    d = dims.n_audio_state
    gen = torch.Generator(device=device).manual_seed(seed)

    def nrm(shape, dtype, scale=None):
        s = scale if scale is not None else 1.0 / (shape[-1] ** 0.5)
        return (torch.randn(shape, generator=gen, device=device) * s).to(dtype)

    def ones(shape):
        return torch.ones(shape, dtype=norm_dtype, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=norm_dtype, device=device)

    def enc_blocks(n_layer):
        return {
            "attn_ln_w": ones((n_layer, d)), "attn_ln_b": zeros((n_layer, d)),
            "qkv_w": nrm((n_layer, d, 3 * d), param_dtype), "qkv_b": zeros((n_layer, 3 * d)),
            "o_w": nrm((n_layer, d, d), param_dtype), "o_b": zeros((n_layer, d)),
            "mlp_ln_w": ones((n_layer, d)), "mlp_ln_b": zeros((n_layer, d)),
            "fc1_w": nrm((n_layer, d, 4 * d), param_dtype), "fc1_b": zeros((n_layer, 4 * d)),
            "fc2_w": nrm((n_layer, 4 * d, d), param_dtype), "fc2_b": zeros((n_layer, d)),
        }

    def dec_blocks(n_layer):
        b = enc_blocks(n_layer)
        b.update(
            x_ln_w=ones((n_layer, d)), x_ln_b=zeros((n_layer, d)),
            xq_w=nrm((n_layer, d, d), param_dtype), xq_b=zeros((n_layer, d)),
            xk_w=nrm((n_layer, d, d), param_dtype),
            xv_w=nrm((n_layer, d, d), param_dtype), xv_b=zeros((n_layer, d)),
            xo_w=nrm((n_layer, d, d), param_dtype), xo_b=zeros((n_layer, d)),
        )
        return b

    tree = {
        "enc": {
            "pos": nrm((dims.n_audio_ctx, d), param_dtype, 0.02),
            "conv1_w": nrm((3, dims.n_mels, d), param_dtype),
            "conv1_b": zeros((d,)),
            "conv2_w": nrm((3, d, d), param_dtype),
            "conv2_b": zeros((d,)),
            "ln_post_w": ones((d,)), "ln_post_b": zeros((d,)),
            "blocks": enc_blocks(dims.n_audio_layer),
        },
        "dec": {
            "pos": nrm((dims.n_text_ctx, d), param_dtype, 0.02),
            "tok": nrm((dims.n_vocab, d), param_dtype, 0.02),
            "ln_w": ones((d,)), "ln_b": zeros((d,)),
            "blocks": dec_blocks(dims.n_text_layer),
        },
    }
    if weights_int8:
        blocks = tree["dec"]["blocks"]
        for key in sorted(_QUANT_KEYS & set(blocks)):
            blocks[key], blocks[key + "_s"] = quantize_int8(blocks[key])
        tok8, tok_s = quantize_int8(tree["dec"]["tok"].T)
        tree["dec"]["tok"], tree["dec"]["tok_s"] = tok8.T.contiguous(), tok_s.T.contiguous()
    return params_from_tensors(tree)


def dims_for(name: str) -> ModelDims:
    return KNOWN_MODELS[name]

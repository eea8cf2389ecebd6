"""Checkpoint -> torch parameter modules.

Counterpart of ``whisper_tpu.model.params``. The host-side assembly is the
same (and must stay so, because the tests hold the two packages against
each other):

  - matmul weights are stored [in, out] (x @ w) in the policy's param
    dtype (bf16 by default), layernorm weights and all biases stay f32
  - q/k/v fuse into one head-major QKV projection [d, 3d] with whisper's
    (d/h)^-0.25 scale folded into the q and k columns (``fuse_qkv``)
  - the cross-attention q/k weights carry the same folded scale
  - under ``DtypePolicy.serving()`` the decoder's matmul weights
    (``_QUANT_KEYS``) and the token embedding are int8 with one f32 scale
    per output column (``<key>_s``, ``tok_s``), quantized on the host in
    numpy exactly as the JAX package does

The JAX package stacks per-layer tensors on a leading [n_layer] axis for
``lax.scan``; PyTorch runs eagerly, so here each layer is a ``Block`` module
in an ``nn.ModuleList``, holding per-layer views of one stacked tensor per
key (one host->device copy per key, not per layer).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch import nn

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.ggml import Checkpoint, RawTensor, load_checkpoint
from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.parallel.group import SINGLE, AxisGroup


@dataclasses.dataclass(frozen=True)
class DtypePolicy:
    """bf16 storage + f32 accumulation (the bf16 tier); ``f32()`` for tests.

    ``weights_int8`` additionally stores the decoder's matmul weights and
    the token embedding as int8 with one f32 scale per output column
    (``serving()``, the JAX package's serving tier); the encoder stays in
    the param dtype."""

    param_dtype: torch.dtype = torch.bfloat16
    compute_dtype: torch.dtype = torch.bfloat16
    norm_dtype: torch.dtype = torch.float32
    weights_int8: bool = False

    @staticmethod
    def f32() -> "DtypePolicy":
        return DtypePolicy(torch.float32, torch.float32, torch.float32)

    @staticmethod
    def serving() -> "DtypePolicy":
        """Throughput tier: bf16 activations, int8 decoder weights."""
        return DtypePolicy(weights_int8=True)


def _get(tensors: dict[str, RawTensor], name: str, shape: tuple[int, ...]) -> np.ndarray:
    if name not in tensors:
        raise ValueError(f"missing tensor {name!r} in checkpoint")
    arr = tensors[name].data
    if int(np.prod(arr.shape)) != int(np.prod(shape)):
        raise ValueError(f"{name}: size mismatch {arr.shape} vs expected {shape}")
    return np.asarray(arr, np.float32).reshape(shape)


def fuse_qkv(
    q_w: np.ndarray, q_b: np.ndarray, k_w: np.ndarray,
    v_w: np.ndarray, v_b: np.ndarray, n_head: int, scale: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Build the fused QKV projection [d, 3d] in HEAD-MAJOR column order:
    column group h holds (q_h, k_h, v_h), each head_dim wide.

    The whisper (d/h)^-0.25 scaling of q AND k (WhisperContext.cpp:360-388)
    is folded into the weights/bias here, removing two multiplies per step.
    """
    d = q_w.shape[0]
    dh = d // n_head
    out = np.empty((d, n_head, 3, dh), np.float32)
    out[:, :, 0, :] = (q_w * scale).reshape(d, n_head, dh)
    out[:, :, 1, :] = (k_w * scale).reshape(d, n_head, dh)
    out[:, :, 2, :] = v_w.reshape(d, n_head, dh)
    bias = np.zeros((n_head, 3, dh), np.float32)
    bias[:, 0, :] = (q_b * scale).reshape(n_head, dh)
    bias[:, 2, :] = v_b.reshape(n_head, dh)  # k has no bias (GGML convention)
    return out.reshape(d, 3 * d), bias.reshape(3 * d)


def _stack_blocks(
    tensors: dict[str, RawTensor],
    prefix: str,
    n_layer: int,
    d: int,
    n_head: int,
    cross: bool,
) -> dict[str, np.ndarray]:
    """Collect per-layer tensors into stacked [n_layer, ...] arrays,
    transposing Linear weights from torch [out, in] to [in, out]."""

    scale = float(d // n_head) ** -0.25

    def gather(fmt: str, shape: tuple[int, ...], transpose: bool = False):
        arrs = []
        for i in range(n_layer):
            a = _get(tensors, fmt.format(prefix=prefix, i=i), shape)
            arrs.append(a.T if transpose else a)
        return np.stack(arrs)

    def gather_qkv(p_attn: str):
        ws, bs = [], []
        for i in range(n_layer):
            w, b = fuse_qkv(
                _get(tensors, f"{prefix}.blocks.{i}.{p_attn}.query.weight", (d, d)).T,
                _get(tensors, f"{prefix}.blocks.{i}.{p_attn}.query.bias", (d,)),
                _get(tensors, f"{prefix}.blocks.{i}.{p_attn}.key.weight", (d, d)).T,
                _get(tensors, f"{prefix}.blocks.{i}.{p_attn}.value.weight", (d, d)).T,
                _get(tensors, f"{prefix}.blocks.{i}.{p_attn}.value.bias", (d,)),
                n_head, scale,
            )
            ws.append(w)
            bs.append(b)
        return np.stack(ws), np.stack(bs)

    qkv_w, qkv_b = gather_qkv("attn")
    blocks = {
        "attn_ln_w": gather("{prefix}.blocks.{i}.attn_ln.weight", (d,)),
        "attn_ln_b": gather("{prefix}.blocks.{i}.attn_ln.bias", (d,)),
        "qkv_w": qkv_w,
        "qkv_b": qkv_b,
        "o_w": gather("{prefix}.blocks.{i}.attn.out.weight", (d, d), transpose=True),
        "o_b": gather("{prefix}.blocks.{i}.attn.out.bias", (d,)),
        "mlp_ln_w": gather("{prefix}.blocks.{i}.mlp_ln.weight", (d,)),
        "mlp_ln_b": gather("{prefix}.blocks.{i}.mlp_ln.bias", (d,)),
        "fc1_w": gather("{prefix}.blocks.{i}.mlp.0.weight", (4 * d, d), transpose=True),
        "fc1_b": gather("{prefix}.blocks.{i}.mlp.0.bias", (4 * d,)),
        "fc2_w": gather("{prefix}.blocks.{i}.mlp.2.weight", (d, 4 * d), transpose=True),
        "fc2_b": gather("{prefix}.blocks.{i}.mlp.2.bias", (d,)),
    }
    if cross:
        blocks.update(
            x_ln_w=gather("{prefix}.blocks.{i}.cross_attn_ln.weight", (d,)),
            x_ln_b=gather("{prefix}.blocks.{i}.cross_attn_ln.bias", (d,)),
            # scales folded like the self-attn path
            xq_w=gather("{prefix}.blocks.{i}.cross_attn.query.weight", (d, d), transpose=True) * scale,
            xq_b=gather("{prefix}.blocks.{i}.cross_attn.query.bias", (d,)) * scale,
            xk_w=gather("{prefix}.blocks.{i}.cross_attn.key.weight", (d, d), transpose=True) * scale,
            xv_w=gather("{prefix}.blocks.{i}.cross_attn.value.weight", (d, d), transpose=True),
            xv_b=gather("{prefix}.blocks.{i}.cross_attn.value.bias", (d,)),
            xo_w=gather("{prefix}.blocks.{i}.cross_attn.out.weight", (d, d), transpose=True),
            xo_b=gather("{prefix}.blocks.{i}.cross_attn.out.bias", (d,)),
        )
    return blocks


_NORM_KEYS = frozenset(
    "attn_ln_w attn_ln_b mlp_ln_w mlp_ln_b x_ln_w x_ln_b "
    "ln_post_w ln_post_b ln_w ln_b".split()
)
_BIAS_KEYS = frozenset(
    "qkv_b o_b fc1_b fc2_b xq_b xv_b xo_b conv1_b conv2_b".split()
)


# decoder matmul weights stored int8 under weights_int8 ([L, in, out]
# stacked); xk_w/xv_w stay in the param dtype: they run once per window, in
# the cross K/V precompute.
_QUANT_KEYS = frozenset("qkv_w o_w xq_w xo_w fc1_w fc2_w".split())


def quantize_weight(w: np.ndarray, axis: int) -> tuple[np.ndarray, np.ndarray]:
    """Symmetric per-output-column int8: one f32 scale per slice along
    ``axis`` (the contraction axis), kept as a size-1 dim so it broadcasts
    over the matmul output. Returns (int8 w, f32 scale)."""
    amax = np.abs(w).max(axis=axis, keepdims=True)
    scale = np.maximum(amax, 1e-8).astype(np.float32) / 127.0
    q = np.clip(np.round(w / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_decoder_weights(dec: dict) -> dict:
    """int8-quantize a host (f32 numpy) decoder subtree in place: each
    ``_QUANT_KEYS`` weight [L, in, out] becomes int8 plus ``<key>_s`` f32
    [L, 1, out]; the token embedding [V, d] gets per-row scales ``tok_s``
    [V, 1] (d is its contraction axis in the logits product)."""
    blocks = dec["blocks"]
    for key in sorted(_QUANT_KEYS & set(blocks)):
        blocks[key], blocks[key + "_s"] = quantize_weight(blocks[key], axis=1)
    dec["tok"], dec["tok_s"] = quantize_weight(dec["tok"], axis=1)
    return dec


class Block(nn.Module):
    """One transformer block's tensors, as buffers named like the JAX
    package's per-layer keys (``blk.qkv_w`` is ``blk["qkv_w"]`` there)."""

    def __init__(self, tensors: dict[str, torch.Tensor]):
        super().__init__()
        for key, t in tensors.items():
            self.register_buffer(key, t)


class Encoder(nn.Module):
    """Conv stem, positional table, ``ln_post`` and the encoder blocks."""

    def __init__(self, tensors: dict[str, torch.Tensor], blocks: list[Block]):
        super().__init__()
        for key, t in tensors.items():
            self.register_buffer(key, t)
        self.blocks = nn.ModuleList(blocks)


class Decoder(nn.Module):
    """Token and positional tables, final layernorm and the decoder blocks
    (whose ``xk_w``/``xv_w`` also feed the per-window cross K/V)."""

    def __init__(self, tensors: dict[str, torch.Tensor], blocks: list[Block]):
        super().__init__()
        for key, t in tensors.items():
            self.register_buffer(key, t)
        self.blocks = nn.ModuleList(blocks)


class WhisperParams(nn.Module):
    """The whole parameter set: ``enc`` and ``dec`` (the JAX pytree's
    ``params["enc"]`` and ``params["dec"]``). ``tp`` is the mesh's "model"
    axis the tensors are sharded over (``parallel.sharding.shard_params``);
    the model code derives its local head counts and widths from it and
    runs its collectives on it. Unsharded: size 1, no collective."""

    tp: AxisGroup = SINGLE

    def __init__(self, enc: Encoder, dec: Decoder):
        super().__init__()
        self.enc = enc
        self.dec = dec


def params_from_numpy(
    tree: dict, device: str | torch.device = "cuda", policy: DtypePolicy = DtypePolicy()
) -> WhisperParams:
    """Build the modules from a host tree in the JAX package's layout:
    ``{"enc": {..., "blocks": {key: [L, ...]}}, "dec": {...}}`` of numpy
    arrays (``host_tree_from_checkpoint``'s tree, or the JAX parameter
    pytree mapped through ``np.asarray``). Norms and biases take the
    policy's norm dtype, other float leaves its param dtype; int8 leaves
    and ``*_s`` scales pass through as they are. Under ``weights_int8`` a
    decoder that is not quantized yet (no ``tok_s``) is quantized here; a
    quantized one, such as the JAX serving tree, is carried across."""
    device = torch.device(device)
    if policy.weights_int8 and "tok_s" not in tree["dec"]:
        # quantize copies of the two dicts it writes, not the caller's tree
        dec = {**tree["dec"], "blocks": dict(tree["dec"]["blocks"])}
        tree = {**tree, "dec": quantize_decoder_weights(dec)}

    def cast(key: str, arr) -> torch.Tensor:
        if arr.dtype == np.int8 or key.endswith("_s"):
            return torch.from_numpy(np.require(arr, None, ["C", "W"])).to(device)
        dt = policy.norm_dtype if key in _NORM_KEYS or key in _BIAS_KEYS else policy.param_dtype
        t = torch.from_numpy(np.require(arr, np.float32, ["C", "W"]))
        return t.to(device=device, dtype=dt)

    def cast_sub(sub: dict) -> dict:
        out = {k: cast(k, v) for k, v in sub.items() if k != "blocks"}
        out["blocks"] = {k: cast(k, v) for k, v in sub["blocks"].items()}
        return out

    return params_from_tensors({"enc": cast_sub(tree["enc"]), "dec": cast_sub(tree["dec"])})


def params_from_tensors(tree: dict) -> WhisperParams:
    """The modules over a tree of tensors in the JAX layout, blocks stacked
    [n_layer, ...]: each ``Block`` holds per-layer views of the stacked
    tensors, which are neither copied nor cast."""

    def build(sub: dict, cls):
        tensors = {k: v for k, v in sub.items() if k != "blocks"}
        stacked = sub["blocks"]
        n_layer = next(iter(stacked.values())).shape[0]
        blocks = [Block({k: t[i] for k, t in stacked.items()}) for i in range(n_layer)]
        return cls(tensors, blocks)

    return WhisperParams(build(tree["enc"], Encoder), build(tree["dec"], Decoder))


def host_tree_from_checkpoint(cp: Checkpoint) -> dict:
    """The f32 numpy tree ``params_from_numpy`` takes, in the JAX layout."""
    dims = cp.dims
    d = dims.n_audio_state
    t = cp.tensors
    return {
        "enc": {
            "pos": _get(t, "encoder.positional_embedding", (dims.n_audio_ctx, d)),
            # torch Conv1d [out, in, k] -> [k, in, out], the unfold+GEMM layout
            "conv1_w": _get(t, "encoder.conv1.weight", (d, dims.n_mels, 3)).transpose(2, 1, 0),
            "conv1_b": _get(t, "encoder.conv1.bias", (d,)),
            "conv2_w": _get(t, "encoder.conv2.weight", (d, d, 3)).transpose(2, 1, 0),
            "conv2_b": _get(t, "encoder.conv2.bias", (d,)),
            "ln_post_w": _get(t, "encoder.ln_post.weight", (d,)),
            "ln_post_b": _get(t, "encoder.ln_post.bias", (d,)),
            "blocks": _stack_blocks(t, "encoder", dims.n_audio_layer, d, dims.n_audio_head, cross=False),
        },
        "dec": {
            "pos": _get(t, "decoder.positional_embedding", (dims.n_text_ctx, d)),
            "tok": _get(t, "decoder.token_embedding.weight", (dims.n_vocab, d)),
            "ln_w": _get(t, "decoder.ln.weight", (d,)),
            "ln_b": _get(t, "decoder.ln.bias", (d,)),
            "blocks": _stack_blocks(t, "decoder", dims.n_text_layer, d, dims.n_text_head, cross=True),
        },
    }


def params_from_checkpoint(
    cp: Checkpoint, policy: DtypePolicy = DtypePolicy(), device: str | torch.device = "cuda"
) -> WhisperParams:
    """Build the parameter modules from a loaded checkpoint (int8 decoder
    weights under ``policy.weights_int8``)."""
    return params_from_numpy(host_tree_from_checkpoint(cp), device, policy)


def load_params(
    path: str, policy: DtypePolicy = DtypePolicy(), progress=None,
    device: str | torch.device = "cuda",
) -> tuple[ModelDims, WhisperParams, Checkpoint]:
    """Read a GGML checkpoint and build its parameters on ``device``."""
    cp = load_checkpoint(path, progress=progress)
    return cp.dims, params_from_checkpoint(cp, policy, resolve_device(device)), cp

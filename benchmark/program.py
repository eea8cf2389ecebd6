"""The system under test, ``whisper_tpu_torch``, as a cell drives it.

Everything that imports the program is here: its parameters built from the
raw weights, its runtime (``WhisperRuntime``: ``encode_window`` and
``run_window`` with ``force_steps``, on replayed CUDA graphs), its mel
front end (``LogMelSpectrogram``) and its kernel build.

The program's checkpoint loader derives its layout in host numpy
(``model/params.py``: ``fuse_qkv``, the (d/h)^-0.25 folded into q and k,
``quantize_weight``). A loader pass over 1.5 billion weights on the host
would be most of a run's set-up, so ``build_params`` does the same
arrangement on the device: the head-major fused QKV with its folded scale,
[in, out] matmul weights, the conv stem as [3, in, out], and on the
serving tier the int8 codes and per-column scales from the program's own
device quantizer (``kernels/quant.py:quantize_cols``, the arithmetic of
``quantize_weight``).
"""

from __future__ import annotations

import torch

from whisper_tpu_torch.features.mel import LogMelSpectrogram
from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.kernels._build import build_all
from whisper_tpu_torch.kernels.quant import quantize_cols
from whisper_tpu_torch.model.params import _QUANT_KEYS, DtypePolicy, params_from_tensors
from whisper_tpu_torch.runtime.context import WhisperRuntime
from whisper_tpu_torch.runtime.sampler import SpecialIds

POLICIES = {"bf16": DtypePolicy(), "serving": DtypePolicy.serving()}


def model_dims(dims) -> ModelDims:
    if dims.ffn != 4 * dims.d:
        raise ValueError(f"the program's MLP is 4 x d_model wide; the configuration states {dims.ffn}")
    return ModelDims(dims.n_vocab, dims.n_audio_ctx, dims.d, dims.enc_heads, dims.enc_layers,
                     dims.n_text_ctx, dims.d, dims.dec_heads, dims.dec_layers, dims.n_mels, 1)


def _fused_qkv(b: dict, n_head: int, dtype: torch.dtype) -> tuple[torch.Tensor, torch.Tensor]:
    """[L, d, 3d] head-major (column group h holds q_h, k_h, v_h) with
    (d/h)^-0.25 folded into q and k, and its bias (k has none)."""
    n, d, _ = b["q_w"].shape
    dh = d // n_head
    s = dh ** -0.25
    w = torch.stack([b["q_w"].float() * s, b["k_w"].float() * s, b["v_w"].float()], dim=1)
    w = w.view(n, 3, n_head, dh, d).permute(0, 4, 2, 1, 3).reshape(n, d, 3 * d)
    bias = torch.stack([b["q_b"] * s, torch.zeros_like(b["q_b"]), b["v_b"]], dim=1)
    bias = bias.view(n, 3, n_head, dh).permute(0, 2, 1, 3).reshape(n, 3 * d)
    return w.to(dtype), bias


def build_params(raw: dict, dims, policy: DtypePolicy):
    """The program's parameter modules from the raw weights, on their device."""
    dtype = policy.param_dtype

    def _t(w: torch.Tensor, scale: float = 1.0) -> torch.Tensor:
        """[L, out, in] -> [L, in, out] in the param dtype, times ``scale`` (in float32)."""
        return (w.float() * scale).to(dtype).transpose(1, 2).contiguous()

    def blocks(b: dict, n_head: int, cross: bool) -> dict:
        qkv_w, qkv_b = _fused_qkv(b, n_head, dtype)
        out = {"attn_ln_w": b["attn_ln_w"], "attn_ln_b": b["attn_ln_b"], "qkv_w": qkv_w,
               "qkv_b": qkv_b, "o_w": _t(b["o_w"]), "o_b": b["o_b"], "mlp_ln_w": b["mlp_ln_w"],
               "mlp_ln_b": b["mlp_ln_b"], "fc1_w": _t(b["fc1_w"]), "fc1_b": b["fc1_b"],
               "fc2_w": _t(b["fc2_w"]), "fc2_b": b["fc2_b"]}
        if cross:
            s = (dims.d // n_head) ** -0.25
            out.update(x_ln_w=b["x_ln_w"], x_ln_b=b["x_ln_b"], xq_w=_t(b["xq_w"], s),
                       xq_b=b["xq_b"] * s, xk_w=_t(b["xk_w"], s), xv_w=_t(b["xv_w"]),
                       xv_b=b["xv_b"], xo_w=_t(b["xo_w"]), xo_b=b["xo_b"])
        return out

    e, d = raw["enc"], raw["dec"]
    dec = {"pos": d["pos"].to(dtype), "tok": d["tok"].to(dtype), "ln_w": d["ln_w"], "ln_b": d["ln_b"],
           "blocks": blocks(d["blocks"], dims.dec_heads, cross=True)}
    if policy.weights_int8:
        for key in sorted(_QUANT_KEYS & set(dec["blocks"])):
            dec["blocks"][key], dec["blocks"][key + "_s"] = quantize_cols(dec["blocks"][key], axis=-2)
        dec["tok"], dec["tok_s"] = quantize_cols(dec["tok"], axis=-1)
    tree = {
        "enc": {"pos": e["pos"].to(dtype), "conv1_w": e["conv1_w"].permute(2, 1, 0).to(dtype).contiguous(),
                "conv1_b": e["conv1_b"], "conv2_w": e["conv2_w"].permute(2, 1, 0).to(dtype).contiguous(),
                "conv2_b": e["conv2_b"], "ln_post_w": e["ln_post_w"], "ln_post_b": e["ln_post_b"],
                "blocks": blocks(e["blocks"], dims.enc_heads, cross=False)},
        "dec": dec,
    }
    return params_from_tensors(tree)


def special_ids(sp) -> SpecialIds:
    return SpecialIds(eot=sp.eot, sot=sp.sot, prev=sp.prev, solm=sp.solm, not_=sp.not_, beg=sp.beg,
                      translate=sp.translate, transcribe=sp.transcribe)


class Program:
    """The program's runtime and mel front end for one configuration."""

    def __init__(self, raw: dict, dims, sp, cfg: dict, filters, device: torch.device):
        policy = POLICIES[cfg["dtype_policy"]]
        if device.type == "cuda":
            build_all()
        self.runtime = WhisperRuntime(build_params(raw, dims, policy), model_dims(dims),
                                      special_ids(sp), compute_dtype=policy.compute_dtype,
                                      device=device, kv_int8=cfg["kv_int8"])
        self.mel = LogMelSpectrogram(filters, device=device)

    @property
    def prompt_capacity(self) -> int:
        return self.runtime.prompt_capacity

    def encode(self, mel: torch.Tensor):
        return self.runtime.encode_window(mel)[1]

    def decode(self, prompt, prompt_len, cross, seek, seek_end, steps: int) -> dict:
        """One window's decode; its result on the host."""
        res = self.runtime.run_window(prompt, prompt_len, cross, seek, seek_end, force_steps=steps)
        return {k: getattr(res, k).cpu().numpy() for k in ("tokens", "p", "result_len", "seek_delta", "failed")}

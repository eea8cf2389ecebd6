"""WhisperContext analogue: owns the encode/decode entry points of a model.

Counterpart of ``whisper_tpu.runtime.context``:

  encode_window : mel [B, n_mels, 2*T] -> (audio features, cross K/V for
                  all decoder layers)
  run_window    : padded prompt + cross K/V -> WindowResult (the token loop
                  of runtime/decode.py)

PyTorch runs eagerly, so there is nothing to compile; both run under
``torch.inference_mode`` on the runtime's device.

``kv_int8`` is the counterpart of ``KernelConfig.kv_int8``: int8 cross and
self K/V caches with per-column scales, read by the decode-attention kernel
(the serving tier, with ``DtypePolicy.serving()`` weights). KernelConfig's
other fields have no counterpart: the tensors' device selects kernel or
plain version.
"""

from __future__ import annotations

import numpy as np
import torch

from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.model.decoder import init_self_kv
from whisper_tpu_torch.model.encoder import CrossKV, encode, precompute_cross_kv
from whisper_tpu_torch.model.params import WhisperParams
from whisper_tpu_torch.runtime.decode import WindowResult, decode_window
from whisper_tpu_torch.runtime.sampler import SpecialIds


class WhisperRuntime:
    """Compute state for one model (shareable across Contexts)."""

    def __init__(
        self,
        params: WhisperParams,
        dims: ModelDims,
        special_ids: SpecialIds,
        compute_dtype: torch.dtype = torch.bfloat16,
        device: str | torch.device = "cuda",
        kv_int8: bool = False,
    ):
        self.device = resolve_device(device)
        self.params = params
        self.dims = dims
        self.ids = special_ids
        self.compute_dtype = compute_dtype
        self.kv_int8 = kv_int8

    # Prompt capacity: [_PREV_] + n_text_ctx/2 past tokens + SOT + lang + task
    # (reference prompt assembly, ContextImpl.cpp:562-576).
    @property
    def prompt_capacity(self) -> int:
        return self.dims.n_text_ctx // 2 + 4

    @property
    def n_max_steps(self) -> int:
        return self.dims.n_text_ctx // 2 - 4

    def _tensor(self, x, dtype: torch.dtype) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(x)
        return torch.as_tensor(x).to(device=self.device, dtype=dtype)

    @torch.inference_mode()
    def encode_window(self, mel) -> tuple[torch.Tensor, CrossKV]:
        """mel [B, n_mels, 2*T] -> (audio_features, cross_kv)."""
        mel = self._tensor(mel, torch.float32)
        feats = encode(self.params, self.dims, mel, compute_dtype=self.compute_dtype)
        cross = precompute_cross_kv(self.params, self.dims, feats, compute_dtype=self.compute_dtype,
                                    quant=self.kv_int8)
        return feats, cross

    @torch.inference_mode()
    def run_window(
        self,
        prompt,
        prompt_len,
        cross_kv: CrossKV,
        seek,
        seek_end,
        max_tokens: int = 0,
        single_segment: bool = False,
        force_steps: int = 0,
    ) -> WindowResult:
        prompt = self._tensor(prompt, torch.int32)
        kv = init_self_kv(self.dims, prompt.shape[0], dtype=self.compute_dtype, device=self.device,
                          quant=self.kv_int8)
        return decode_window(
            self.params, self.dims, self.ids, prompt,
            self._tensor(prompt_len, torch.int32), kv, cross_kv,
            self._tensor(seek, torch.int32), self._tensor(seek_end, torch.int32),
            max_tokens=max_tokens, single_segment=single_segment,
            compute_dtype=self.compute_dtype, force_steps=force_steps,
        )

"""Model object + factory (iModel / loadModel analogue).

Counterpart of ``whisper_tpu.api.model``: owns the checkpoint-derived
state (dims, vocabulary, mel front-end, parameters and runtime) on one
device, ``"cuda"`` unless the caller asks for the CPU.

With ``mesh=`` (``parallel.make_mesh``, after ``init_distributed``) every
rank builds the same Model: the parameters are quantized (serving tier)
and then sharded over the mesh's "model" axis, so each rank holds its
share of the heads and of the vocabulary, and every rank calls the same
Context entry points on the same input and gets the same result (SPMD).
As in the JAX package, the Model does not split lanes over "data"; that
is ``parallel.sharding.shard_batch`` at the runtime level.
``cuda_graphs=False`` runs the token steps eagerly: a gloo model group of
more than one rank on the card needs it (``runtime/context.py``).
"""

from __future__ import annotations

import copy
import time
from typing import Optional

import torch

from whisper_tpu_torch.api.context import Context
from whisper_tpu_torch.config import resolve_device
from whisper_tpu_torch.features.mel import LogMelSpectrogram
from whisper_tpu_torch.ggml import load_checkpoint
from whisper_tpu_torch.hparams import ModelDims
from whisper_tpu_torch.model.params import DtypePolicy, params_from_checkpoint
from whisper_tpu_torch.runtime.context import WhisperRuntime
from whisper_tpu_torch.runtime.sampler import SpecialIds
from whisper_tpu_torch.vocab import SpecialTokens, Vocabulary


class Model:
    def __init__(
        self,
        path: str,
        policy: Optional[DtypePolicy] = None,
        mel_mode: str = "openai",
        mesh=None,
        progress=None,
        device: str | torch.device = "cuda",
        cuda_graphs: bool = True,
    ):
        self.device = resolve_device(device)
        t0 = time.perf_counter()
        cp = load_checkpoint(path, progress=progress)
        self.dims: ModelDims = cp.dims
        self.vocab = Vocabulary(cp.vocab_words, cp.dims.n_vocab)
        policy = policy or DtypePolicy()
        params = params_from_checkpoint(cp, policy, self.device)
        self.load_time_cpu_s = time.perf_counter() - t0

        if mesh is not None:
            from whisper_tpu_torch.parallel.sharding import shard_params

            params = shard_params(params, mesh)
        self.mesh = mesh

        self.mel = LogMelSpectrogram(cp.filters.data, mode=mel_mode, device=self.device)
        self.runtime = WhisperRuntime(
            params, cp.dims, SpecialIds.from_vocab(self.vocab),
            compute_dtype=policy.compute_dtype, device=self.device, cuda_graphs=cuda_graphs,
        )
        self.load_time_total_s = time.perf_counter() - t0

    def create_context(self) -> Context:
        return Context(self)

    def tokenize(self, text: str) -> list[int]:
        return self.vocab.tokenize(text)

    @property
    def is_multilingual(self) -> bool:
        return self.vocab.multilingual

    @property
    def special_tokens(self) -> SpecialTokens:
        return self.vocab.special_tokens

    def string_from_token(self, token_id: int) -> Optional[str]:
        return self.vocab.string(token_id)

    def clone(self) -> "Model":
        """A second Model over the same weights and runtime: nothing is
        copied, on the host or on the device (the reference needed D3D
        shared-resource handles, ModelImpl.cpp:40-60)."""
        return copy.copy(self)


def load_model(
    path: str,
    policy: Optional[DtypePolicy] = None,
    mel_mode: str = "openai",
    mesh=None,
    progress=None,
    device: str | torch.device = "cuda",
    cuda_graphs: bool = True,
) -> Model:
    return Model(path, policy=policy, mel_mode=mel_mode, mesh=mesh, progress=progress, device=device,
                 cuda_graphs=cuda_graphs)

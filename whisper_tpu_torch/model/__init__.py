"""Parameters, layers, encoder and decoder of the PyTorch port, with the
JAX package's re-exports."""

from whisper_tpu_torch.model.decoder import decode_step, init_self_kv
from whisper_tpu_torch.model.encoder import encode, precompute_cross_kv
from whisper_tpu_torch.model.params import DtypePolicy, load_params, params_from_checkpoint

__all__ = ["DtypePolicy", "load_params", "params_from_checkpoint", "encode", "precompute_cross_kv",
           "decode_step", "init_self_kv"]

"""Device selection for the port's entry points.

Every entry point (``load_model``/``Model``, ``WhisperRuntime``, the CLI)
takes a ``device`` that defaults to ``"cuda"``. Asking for CUDA on a
machine without a card is an error, never a quiet move to the CPU: the
CUDA kernels are the path being run, and the CPU runs their plain PyTorch
versions instead.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev

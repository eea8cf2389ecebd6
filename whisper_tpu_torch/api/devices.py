"""Device enumeration (listGPUs analogue, Whisper/D3D/listGPUs.cpp; API
export iContext.h:66).

Counterpart of ``whisper_tpu.api.devices.list_devices``: the CUDA cards that
PyTorch sees (``torch.cuda.get_device_properties``), then the host CPU, in
the JAX package's ``DeviceInfo`` shape. ``init_distributed`` (multi-host
bring-up) belongs with the parallelism port and is not here yet.
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class DeviceInfo:
    name: str
    platform: str
    id: int
    process_index: int
    memory_gb: float


def list_devices() -> list[DeviceInfo]:
    """Every CUDA card (platform "gpu", JAX's name for it; its total
    memory), then the CPU (platform "cpu"; the host's physical memory)."""
    import torch

    out = []
    if torch.cuda.is_available():
        for i in range(torch.cuda.device_count()):
            props = torch.cuda.get_device_properties(i)
            out.append(DeviceInfo(name=props.name, platform="gpu", id=i, process_index=0,
                                  memory_gb=round(props.total_memory / 1e9, 1)))
    try:
        host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES") / 1e9
    except (ValueError, OSError, AttributeError):
        host = 0.0
    out.append(DeviceInfo(name="cpu", platform="cpu", id=0, process_index=0,
                          memory_gb=round(host, 1)))
    return out

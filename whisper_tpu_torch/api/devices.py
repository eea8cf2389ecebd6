"""Device enumeration (listGPUs analogue, Whisper/D3D/listGPUs.cpp; API
export iContext.h:66) and multi-process bring-up.

Counterpart of ``whisper_tpu.api.devices``: ``list_devices`` gives the CUDA
cards that PyTorch sees (``torch.cuda.get_device_properties``), then the
host CPU, in the JAX package's ``DeviceInfo`` shape; ``init_distributed``
joins this process to the process group that ``parallel.make_mesh``
builds its mesh over (``torch.distributed`` in place of
``jax.distributed``: one process per rank).
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


def init_distributed(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device: str = "cuda",
    backend: str | None = None,
) -> None:
    """Join the process group (``torch.distributed.init_process_group``).

    With no arguments the rank, world size and address come from the
    environment (``env://``: RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT, as
    ``torchrun`` sets them), as JAX reads them on TPU pods. Otherwise
    ``coordinator_address`` is ``host:port`` (``tcp://``), or a URL such as
    ``file:///path`` to rendezvous through a file, with ``num_processes``
    and ``process_id``.

    The backend is NCCL for ``device="cuda"`` and gloo for ``"cpu"``;
    ``backend="gloo"`` with ``"cuda"`` is how ranks share one card (NCCL
    refuses two ranks on one device). On the card the process takes device
    LOCAL_RANK (``torchrun``), else its rank modulo the cards; without a
    card, ``device="cuda"`` raises."""
    import torch
    import torch.distributed as dist

    from whisper_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if coordinator_address is None:
        init, kwargs = "env://", {}
        rank = int(os.environ.get("RANK", 0))
    else:
        init = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
        kwargs = dict(world_size=num_processes, rank=process_id)
        rank = process_id
    if dev.type == "cuda":      # before the group, so NCCL binds this card
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank % torch.cuda.device_count())))
    dist.init_process_group(backend, init_method=init, **kwargs)

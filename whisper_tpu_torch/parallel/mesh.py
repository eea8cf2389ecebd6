"""Device mesh construction.

Counterpart of ``whisper_tpu.parallel.mesh``: a 2-D ("data", "model") mesh
over the ranks of the process group (``api.devices.init_distributed``),
one process per rank, where

  - "data"  — utterances / 30 s windows / beams batch axis (DP): each data
              rank decodes its own lanes (``sharding.shard_batch``)
  - "model" — tensor parallelism: attention heads, the MLP hidden dim and
              the vocab-sharded token table, with the collectives written
              out in the model code (``parallel/group.py``)

The mesh is a ``torch.distributed.device_mesh.DeviceMesh``, used for its
process groups only (no DTensor).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
MODEL_AXIS = "model"


def make_mesh(n_model: int = 1, devices=None) -> DeviceMesh:
    """Mesh over all ranks of the group (or the given ranks) with a
    model-parallel minor axis: rank = d * n_model + m.

    ``n_model`` ranks cooperate on one model replica; the remaining factor
    is the data axis. Every rank of the group calls this (the mesh's
    process groups are made collectively). The mesh's device type is
    "cuda" on NCCL and "cpu" on gloo, which also carries CUDA tensors."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call init_distributed first")
    ranks = list(range(dist.get_world_size()) if devices is None else devices)
    n = len(ranks)
    if n % n_model:
        raise ValueError(f"{n} devices not divisible by n_model={n_model}")
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return DeviceMesh(device_type, torch.tensor(ranks).reshape(n // n_model, n_model),
                      mesh_dim_names=(DATA_AXIS, MODEL_AXIS))

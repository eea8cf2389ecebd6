"""The collectives of one mesh axis, as the model code calls them.

The JAX package is single-controller: GSPMD reads the parameters'
``NamedSharding``s and inserts the collectives itself. The port runs one
process per rank (SPMD), so Megatron-style tensor parallelism is written
out: the model code calls ``sum``, ``max`` and ``gather`` of its
parameters' ``AxisGroup`` (``WhisperParams.tp``, the mesh's "model" axis)
where GSPMD would have reduced or gathered. At size 1 (no mesh, or
``n_model = 1``) each of them returns its input and launches nothing, so
a model that is not sharded runs exactly the step it ran before.

The collectives are plain ``torch.distributed`` calls on the axis's process
group, on the tensors' own device: NCCL on the card, gloo on the CPU, or
gloo on CUDA tensors (how two ranks share one card: NCCL refuses two ranks
on one device), which gloo takes as they are. Every collective is on f32
tensors (``gather`` also takes the integer and bool fields of a window's
result). A collective that fails raises; nothing falls back.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


class AxisGroup:
    """This rank's place on one mesh axis: the axis's process group, its
    size and this rank's index along it."""

    def __init__(self, group=None, size: int = 1, rank: int = 0):
        self.group, self.size, self.rank = group, size, rank
        self.backend = dist.get_backend(group) if group is not None else None

    @classmethod
    def of(cls, mesh, axis: str) -> "AxisGroup":
        """The group of ``mesh``'s axis ``axis`` that holds this rank."""
        size = mesh.size(mesh.mesh_dim_names.index(axis))
        if size == 1:
            return cls()
        return cls(mesh.get_group(axis), size, mesh.get_local_rank(axis))

    @property
    def capturable(self) -> bool:
        """Whether a CUDA graph can capture this group's collectives: NCCL's
        can, gloo's cannot (they run on the host)."""
        return self.size == 1 or self.backend == "nccl"

    def part(self, n: int) -> int:
        """This rank's share of ``n`` (heads, or a width of whole heads):
        the one place the model code divides by the axis size."""
        if n % self.size:
            raise ValueError(f"{n} does not split over {self.size} ranks")
        return n // self.size

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (SUM) of an f32 tensor, in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=self.group)
        return t

    def max(self, t: torch.Tensor) -> torch.Tensor:
        """All-reduce (MAX), in place; returns it."""
        if self.size > 1:
            dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """Every rank's ``t`` concatenated along ``dim``, in rank order."""
        if self.size == 1:
            return t
        t = t.contiguous()
        out = torch.empty((self.size * t.shape[0], *t.shape[1:]), dtype=t.dtype, device=t.device)
        dist.all_gather_into_tensor(out, t, group=self.group)     # ranks' t along dim 0
        return torch.cat(out.chunk(self.size), dim=dim)


SINGLE = AxisGroup()

"""The port's device mesh: one process per device, SPMD over
`torch.distributed`.

The counterpart of the JAX package's `gps_sdr_tpu/parallel/mesh.py`.  JAX
runs one program over a `jax.sharding.Mesh` of devices; PyTorch's idiom
for several GPUs is one process per device, each running the same code on
its own shard, with collectives between them.  A `Mesh` is that world as
the sharded stages see it: the process group, this rank, the world's size,
this rank's device, and `AXIS` kept as the name of the one axis.

Two collectives carry every sharded stage:
- `all_gather_rows(t, n_real)`: every rank's `t`, tiled in rank order along
  one axis and cut to its first `n_real` rows, as
  `jax.lax.all_gather(t, AXIS, tiled=True)[:n_real]`;
- `reduce_sum(t)`: a gather, then a sum in rank order, so every rank gets
  the same bits at any world size.

The transport is the group's backend, and nothing chooses another behind
the caller's back.  With gloo a CUDA tensor goes through a host copy for
the collective only (gloo's support of CUDA tensors is partial, and these
payloads are a few hundred bytes to a few MB); with NCCL it stays on the
device.  Compute never leaves the rank's device.  The NCCL branch is the
same code without the host copy; it needs a card per rank and has not run
on one.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from gps_sdr_tpu_torch.utils.device import resolve_device

AXIS = "dev"


def rank_device(rank: int) -> torch.device:
    """The card of a rank: cuda:{local_rank % device_count}, the local rank
    taken from LOCAL_RANK (set by torchrun) or else the rank.  Raises where
    there is no card, as `resolve_device(None)` does."""
    resolve_device(None)
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A world of ranks, one device each, with the collectives of the
    sharded stages.  `group` None is the default (whole) world."""

    group: Optional[object]
    rank: int
    size: int
    device: torch.device
    backend: str
    axis: str = AXIS

    def rows(self, n: int) -> slice:
        """This rank's rows of an axis of `n`, a multiple of the size."""
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} ranks")
        per = n // self.size
        return slice(self.rank * per, (self.rank + 1) * per)

    def _gather(self, t: torch.Tensor) -> list:
        """Every rank's `t` (same shape on all), in rank order, on the
        transport's side: host tensors with gloo, device tensors with
        NCCL."""
        x = t.contiguous()
        if self.backend == "gloo" and x.device.type != "cpu":
            x = x.cpu()
        if x.dtype == torch.bool:
            x = x.to(torch.uint8)
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x, group=self.group)
        if t.dtype == torch.bool:
            parts = [p.to(torch.bool) for p in parts]
        return parts

    def all_gather_rows(self, t: torch.Tensor, n_real: Optional[int] = None,
                        dim: int = 0) -> torch.Tensor:
        """Every rank's `t` tiled in rank order along `dim`, cut to its
        first `n_real` rows there, on `t`'s device."""
        parts = self._gather(t.movedim(dim, 0))
        out = torch.cat(parts)[:n_real]
        return out.to(t.device).movedim(0, dim)

    def reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of every rank's `t`, added in rank order (the same bits
        on every rank), on `t`'s device."""
        parts = self._gather(t)
        acc = parts[0].clone()
        for p in parts[1:]:
            acc += p
        return acc.to(t.device)

    def gather_fault(self, fault: torch.Tensor, per: int) -> torch.Tensor:
        """The (1,) int32 fault flag of the whole world from each rank's,
        which is 1 + the last faulting channel of its `per` rows (0: none):
        1 + the last faulting channel in the world's numbering."""
        flags = self.all_gather_rows(fault).to(torch.int64)
        first = torch.arange(self.size, device=flags.device) * per
        world = torch.where(flags > 0, flags + first, 0).max()
        return world.reshape(1).to(torch.int32)

    def broadcast(self, obj):
        """Rank 0's `obj` (any picklable value) on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.group)


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The mesh of the initialised `torch.distributed` world: this rank on
    `device` (its card, `rank_device`, when None).  `n_devices`, where
    given, must be the world's size (the JAX package's first-n-devices
    mesh has no counterpart in a world of processes)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised torch.distributed "
                           "world (init_process_group)")
    size, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices}, but the world has {size} "
                         "ranks")
    device = rank_device(rank) if device is None else torch.device(device)
    backend = dist.get_backend()
    if backend == "nccl":
        torch.cuda.set_device(device)    # NCCL's object collectives use it
    return Mesh(group=None, rank=rank, size=size, device=device,
                backend=backend)


def resolve_mesh(mesh, device=None) -> Optional[Mesh]:
    """`mesh="auto"`: a mesh over the world when one of more than one rank
    is initialised, else None (the counterpart of gps_sdr_tpu/
    pipeline.py:76-78).  A Mesh or None is returned as it is."""
    if isinstance(mesh, str):
        if mesh != "auto":
            raise ValueError(f"mesh must be 'auto', a Mesh or None, not "
                             f"{mesh!r}")
        world = (dist.is_available() and dist.is_initialized()
                 and dist.get_world_size() > 1)
        return make_mesh(device=device) if world else None
    return mesh

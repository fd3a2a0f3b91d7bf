"""Data parallelism over torch.distributed (port of mtlx/parallel/mesh.py).

mtlx runs one SPMD program over a 1-D "data" mesh: the parameters are
replicated, the batch is sharded over the mesh, and `jit` inserts the
all-reduce of the gradients. Here every rank is a process with one
device, launched by `torch.distributed.run`:

  * `init_process_group` joins the group from the environment that the
    launcher sets (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT).
    The device is `cuda:LOCAL_RANK` and the backend NCCL; gloo only where
    the caller names the CPU or names gloo itself. Nothing falls back
    from NCCL to gloo or from the card to the CPU.
  * `Replicas.per_rank_batch` is `create_mesh_for_batch`: each rank takes
    batch_size // world_size rows of the global batch.
  * `Replicas.broadcast_` is `replicate`: the state comes from rank 0.
  * `Replicas.average_` is the psum that `jit` inserts for the sharded
    batch: one flat all-reduce of the gradients (and the step's metrics),
    divided by the world size.
  * `Replicas.sums` is the psum inside the live batch norm's statistics
    (`backbones/resnet.py` LiveBatchNorm): mtlx reduces a globally sharded
    batch, so its batch statistics are the global batch's.

mtlx's `create_hybrid_mesh` (a DCN x ICI mesh) has no counterpart yet:
NCCL picks its own hierarchy inside a node, and across nodes the port has
not been run (ROADMAP.md queue 1 item 20).
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from mtlx_torch.device import DeviceLike, resolve_device

# how long a collective waits for the other ranks before it raises: longer
# than any rank's pause (a checkpoint write, the profiler's export)
_TIMEOUT = datetime.timedelta(minutes=30)


@dataclasses.dataclass(frozen=True)
class Replicas:
    """The ranks of one data-parallel group, seen from one of them."""

    rank: int
    world_size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    def per_rank_batch(self, batch_size: int) -> int:
        """The rows of a global batch of `batch_size` that each rank takes.
        Raises when the ranks do not divide it: mtlx's
        `create_mesh_for_batch` shrinks its mesh with a warning instead,
        but a rank of a process group cannot sit a step out."""
        if batch_size % self.world_size:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"{self.world_size} ranks; pick a multiple of the world size")
        return batch_size // self.world_size

    def rows(self, x: Tensor) -> Tensor:
        """This rank's rows of a tensor that holds the whole global batch
        (rank 0's rows first, as the global batch lays them out)."""
        b = self.per_rank_batch(x.shape[0])
        return x[self.rank * b:(self.rank + 1) * b]

    def broadcast_(self, tensors: Sequence[Tensor]) -> None:
        """Overwrite every tensor with rank 0's (in place)."""
        for t in tensors:
            dist.broadcast(t, src=0)

    def average_(self, tensors: Sequence[Tensor]) -> None:
        """Replace every tensor by its mean over the ranks (in place), with
        one all-reduce of one flat float32 buffer."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        dist.all_reduce(flat)
        flat.div_(self.world_size)
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])

    def sums(self, tensors: Sequence[Tensor]) -> List[Tensor]:
        """Each float32 tensor's sum over the ranks (new tensors), with one
        all-reduce of one flat buffer. The live batch norm's paired sums
        go through it, forward and backward."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        dist.all_reduce(flat)
        return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def sum(self, t: Tensor) -> Tensor:
        """The sum of `t` over the ranks (a new tensor)."""
        out = t.detach().clone()
        dist.all_reduce(out)
        return out

    def min_int(self, value: int) -> int:
        """The least of an integer over the ranks."""
        t = torch.tensor([value], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MIN)
        return int(t.item())

    def barrier(self) -> None:
        if self.backend == "nccl":
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()


def init_process_group(device: DeviceLike = None, backend: Optional[str] = None
                       ) -> Tuple[torch.device, Replicas]:
    """Join the process group that `torch.distributed.run` describes in
    the environment; returns (this rank's device, its Replicas).

    `device` None or 'cuda' is `cuda:LOCAL_RANK` (a missing card raises);
    'cuda:N' names the card itself (two ranks on one card, as a gloo
    check does); 'cpu' is the CPU. `backend` None is NCCL on the card and
    gloo on the CPU."""
    for var in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT"):
        if var not in os.environ:
            raise RuntimeError(f"{var} is not set: launch with python -m torch.distributed.run "
                               "(or set RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT)")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if device is None or str(device) == "cuda":
        device = f"cuda:{local_rank}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    kwargs = {"device_id": device} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                            timeout=_TIMEOUT, **kwargs)
    return device, Replicas(rank, world, device)


def destroy_process_group() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()

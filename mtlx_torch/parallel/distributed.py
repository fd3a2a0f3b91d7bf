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
  * `create_hybrid_mesh` is mtlx's (DCN, ICI) data mesh: a 2-D grid
    ("data_dcn", "data") whose rows are slices (the launcher's nodes, or
    `num_slices` blocks of consecutive ranks). The batch still splits over
    every rank; each reduction runs inside a slice first, then across the
    slices between ranks of the same place in their slice, so the heavy
    traffic stays on the links inside a node. The step is the flat one's
    but for the order of the additions.

parallel/spatial.py builds the (data, spatial) grid on the same Replicas.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from mtlx_torch.device import DeviceLike, resolve_device

# how long a collective waits for the other ranks before it raises: longer
# than any rank's pause (a checkpoint write, the profiler's export)
_TIMEOUT = datetime.timedelta(minutes=30)

DATA_AXIS = "data"
DCN_AXIS = "data_dcn"


@dataclasses.dataclass(frozen=True)
class Replicas:
    """The ranks of one data-parallel group, seen from one of them."""

    rank: int
    world_size: int
    device: torch.device

    @property
    def backend(self) -> str:
        return dist.get_backend()

    @property
    def batch_ranks(self) -> int:
        """How many parts the global batch splits into: every rank's."""
        return self.world_size

    @property
    def batch_index(self) -> int:
        """Which part of the global batch this rank takes."""
        return self.rank

    def per_rank_batch(self, batch_size: int) -> int:
        """The rows of a global batch of `batch_size` that each rank takes.
        Raises when the ranks do not divide it: mtlx's
        `create_mesh_for_batch` shrinks its mesh with a warning instead,
        but a rank of a process group cannot sit a step out."""
        if batch_size % self.batch_ranks:
            raise ValueError(f"batch_size {batch_size} does not divide over "
                             f"{self.batch_ranks} ranks; pick a multiple of the world size")
        return batch_size // self.batch_ranks

    def rows(self, x: Tensor) -> Tensor:
        """This rank's rows of a tensor that holds the whole global batch
        (rank 0's rows first, as the global batch lays them out)."""
        b = self.per_rank_batch(x.shape[0])
        return x[self.batch_index * b:(self.batch_index + 1) * b]

    def _all_reduce(self, t: Tensor) -> None:
        dist.all_reduce(t)

    def broadcast_(self, tensors: Sequence[Tensor]) -> None:
        """Overwrite every tensor with rank 0's (in place)."""
        for t in tensors:
            dist.broadcast(t, src=0)

    def average_(self, tensors: Sequence[Tensor]) -> None:
        """Replace every tensor by its mean over the ranks (in place), with
        one all-reduce of one flat float32 buffer."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1).float() for t in tensors])
        self._all_reduce(flat)
        flat.div_(self.world_size)
        parts = flat.split([t.numel() for t in tensors])
        torch._foreach_copy_(tensors, [p.view_as(t) for p, t in zip(parts, tensors)])

    def sums(self, tensors: Sequence[Tensor]) -> List[Tensor]:
        """Each float32 tensor's sum over the ranks (new tensors), with one
        all-reduce of one flat buffer. The live batch norm's paired sums
        go through it, forward and backward."""
        tensors = list(tensors)
        flat = torch.cat([t.reshape(-1) for t in tensors])
        self._all_reduce(flat)
        return [p.view_as(t) for p, t in zip(flat.split([t.numel() for t in tensors]), tensors)]

    def sum(self, t: Tensor) -> Tensor:
        """The sum of `t` over the ranks (a new tensor)."""
        out = t.detach().clone()
        self._all_reduce(out)
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


@dataclasses.dataclass(frozen=True)
class HybridReplicas(Replicas):
    """The ranks of a (data_dcn, data) grid: rank r sits in slice
    r // slice_size at place r % slice_size. The batch splits over every
    rank as in Replicas; each all-reduce runs over the slice's ranks, then
    over the ranks at the same place of every slice."""

    num_slices: int
    slice_group: Any  # the ranks of this rank's slice
    cross_group: Any  # the ranks at this rank's place in every slice

    axis_names = (DCN_AXIS, DATA_AXIS)

    @property
    def shape(self) -> Tuple[int, int]:
        return self.num_slices, self.world_size // self.num_slices

    def _all_reduce(self, t: Tensor) -> None:
        dist.all_reduce(t, group=self.slice_group)
        dist.all_reduce(t, group=self.cross_group)


def grid_groups(rows: int, cols: int) -> Tuple[List[Any], List[Any]]:
    """Process groups of a rows x cols grid of the ranks (rank r at row
    r // cols, column r % cols): one a row, then one a column. Every rank
    creates every group, in the same order, as `new_group` requires."""
    row_groups = [dist.new_group(list(range(r * cols, (r + 1) * cols))) for r in range(rows)]
    col_groups = [dist.new_group(list(range(c, rows * cols, cols))) for c in range(cols)]
    return row_groups, col_groups


def create_hybrid_mesh(num_slices: Optional[int] = None,
                       replicas: Optional[Replicas] = None) -> HybridReplicas:
    """mtlx's `create_hybrid_mesh` over the process group's ranks: a
    (data_dcn, data) grid of `num_slices` slices. Without num_slices the
    slices are the launcher's nodes (WORLD_SIZE // LOCAL_WORLD_SIZE, the
    counterpart of a TPU device's slice_index). Raises, as mtlx's does,
    when the launcher names no nodes, the nodes are uneven, or the ranks do
    not split into num_slices slices."""
    replicas = replicas or current_replicas()
    world = replicas.world_size
    if num_slices is None:
        local = os.environ.get("LOCAL_WORLD_SIZE")
        if local is None:
            raise ValueError("the launcher names no nodes (LOCAL_WORLD_SIZE is not set); "
                             "pass num_slices explicitly")
        if world % int(local):
            raise ValueError(f"uneven slices: {world} ranks over nodes of {local}")
        num_slices = world // int(local)
    if world % num_slices:
        raise ValueError(f"{world} ranks do not split into {num_slices} slices")
    per_slice = world // num_slices
    slice_groups, cross_groups = grid_groups(num_slices, per_slice)
    return HybridReplicas(replicas.rank, world, replicas.device, num_slices,
                          slice_groups[replicas.rank // per_slice],
                          cross_groups[replicas.rank % per_slice])


# the Replicas of this process's group, once init_process_group has run
_current: Optional[Replicas] = None


def current_replicas() -> Replicas:
    """The Replicas that init_process_group returned in this process."""
    if _current is None:
        raise RuntimeError("no process group: call parallel.distributed.init_process_group first")
    return _current


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
    global _current
    _current = Replicas(rank, world, device)
    return device, _current


def destroy_process_group() -> None:
    global _current
    _current = None
    if dist.is_initialized():
        dist.destroy_process_group()

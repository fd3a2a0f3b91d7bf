"""Spatial partitioning: the image H axis split over a (data, spatial)
grid of ranks (port of mtlx/parallel/spatial.py).

mtlx annotates the images as sharded over a 2-D mesh and lets GSPMD
insert the halo exchanges its convolutions need and the gathers where the
program needs whole maps. The port writes both:

  * `create_spatial_mesh(n_data, n_spatial)` lays the process group's
    ranks out as a grid: rank r is data row r // n_spatial and slab
    r % n_spatial, and the ranks of one data row form its spatial group.
  * `shard_batch_spatial` gives each rank its data row's rows of the
    batch and its own H-slab of the images.
  * Inside `slab_context` every padding of a trunk (mtlx_torch/layers.py)
    takes the rows its windows read beyond the slab from the neighbouring
    slabs: the slabs' edge rows are all-gathered over the spatial group,
    and the backward returns each halo row's gradient to the slab that
    owns it. Only the image's own top and bottom are padded. The rows a
    layer needs follow from its (top, bottom) padding, kernel and stride:
    `top` above, `kernel - stride - top` below.
  * Only the trunk's output, the stride-16 map, is gathered over the
    spatial group (`gather_slabs`): the RPN's top-k and NMS, the crops and
    the aux heads read whole maps, and run replicated on the ranks of a
    data row. No rank gathers the image or any earlier map.
  * Gradients: the gather's backward returns each rank its slab's rows of
    the map's gradient times n_spatial, and the train step averages every
    gradient over all ranks of the grid (Replicas.average_), so the trunk
    gets the sum over the slabs and the heads the mean over the data rows:
    mtlx's gradient of the global batch. Live batch norm sums its
    statistics over the grid (the slabs are equal), so they are the global
    batch's; the loss normalisers count over the grid as well.

Slab boundaries fall on the trunk's total stride: a bucket's height must
split into n_spatial slabs of a multiple of the stride (16). mtlx accepts
any split (GSPMD pads the uneven shards); the port raises.

It is for images whose activations one card cannot hold (aerial or
medical imagery); at detection sizes plain data parallelism is better.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import Tensor

from mtlx_torch import layers
from mtlx_torch.parallel.distributed import DATA_AXIS, Replicas, current_replicas, grid_groups

SPATIAL_AXIS = "spatial"


def check_slabs(height: int, n_spatial: int, stride: int) -> None:
    """Raise unless `height` rows split into n_spatial slabs of a multiple
    of `stride` rows."""
    if height % (n_spatial * stride):
        raise ValueError(
            f"a bucket of {height} rows does not split into {n_spatial} slabs on the trunk's "
            f"stride {stride}: its height must be a multiple of {n_spatial * stride} (mtlx "
            "accepts any split; the port's slab boundaries fall on the stride)")


@dataclasses.dataclass(frozen=True)
class SpatialMesh(Replicas):
    """A (data, spatial) grid of ranks, seen from one of them. As the train
    step's Replicas, the global batch splits over the n_data data rows,
    and the gradients, metrics and live batch norm sums reduce over every
    rank of the grid."""

    n_data: int
    n_spatial: int
    spatial_group: Any  # the ranks of this rank's data row

    axis_names = (DATA_AXIS, SPATIAL_AXIS)

    @property
    def data_index(self) -> int:
        return self.rank // self.n_spatial

    @property
    def spatial_index(self) -> int:
        return self.rank % self.n_spatial

    @property
    def batch_ranks(self) -> int:
        return self.n_data

    @property
    def batch_index(self) -> int:
        return self.data_index

    def slab(self, images: Tensor, stride: int = 16) -> Tensor:
        """This rank's H-slab of [B, H, W, ...] images."""
        h = images.shape[1]
        check_slabs(h, self.n_spatial, stride)
        rows = h // self.n_spatial
        return images[:, self.spatial_index * rows:(self.spatial_index + 1) * rows]


def create_spatial_mesh(n_data: int, n_spatial: int,
                        replicas: Optional[Replicas] = None) -> SpatialMesh:
    """The (data, spatial) grid of the process group's ranks (by default
    those of parallel.distributed.init_process_group). Raises as mtlx's
    does when the group has too few ranks, and when it has more: a rank of
    a process group cannot sit a step out."""
    replicas = replicas or current_replicas()
    need = n_data * n_spatial
    if replicas.world_size < need:
        raise ValueError(f"need {need} ranks, have {replicas.world_size}")
    if replicas.world_size > need:
        raise ValueError(f"a {n_data} x {n_spatial} grid takes {need} ranks, the group has "
                         f"{replicas.world_size}: every rank takes part in a step")
    rows, _ = grid_groups(n_data, n_spatial)
    return SpatialMesh(replicas.rank, replicas.world_size, replicas.device, n_data, n_spatial,
                       rows[replicas.rank // n_spatial])


def shard_batch_spatial(mesh: SpatialMesh, batch: Dict[str, Tensor],
                        stride: int = 16) -> Dict[str, Tensor]:
    """This rank's part of a global batch: its data row's rows of every
    leaf, and of the images [B, H, W, 3] its own H-slab."""
    out = {k: mesh.rows(v) for k, v in batch.items()}
    out["image"] = mesh.slab(out["image"], stride)
    return out


def _all_gather(x: Tensor, mesh: SpatialMesh) -> List[Tensor]:
    """x of every slab of this rank's data row, in slab order."""
    out = [torch.empty_like(x) for _ in range(mesh.n_spatial)]
    dist.all_gather(out, x.contiguous(), group=mesh.spatial_group)
    return out


class _Halo(torch.autograd.Function):
    """An NCHW slab with `top` rows of the slab above it and `bottom` rows
    of the slab below it joined on (`value` rows at the image's own top
    and bottom); the backward adds each halo row's gradient into the slab
    that owns the row."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: SpatialMesh, top: int, bottom: int, value: float):
        s, n, h = mesh.spatial_index, mesh.n_spatial, x.shape[2]
        parts = _all_gather(torch.cat([x[:, :, :bottom], x[:, :, h - top:]], dim=2), mesh)
        b, c, _, w = x.shape
        above = parts[s - 1][:, :, bottom:] if s > 0 else x.new_full((b, c, top, w), value)
        below = parts[s + 1][:, :, :bottom] if s < n - 1 else x.new_full((b, c, bottom, w), value)
        ctx.mesh, ctx.top, ctx.bottom = mesh, top, bottom
        return torch.cat([above, x, below], dim=2)

    @staticmethod
    def backward(ctx, g: Tensor):
        mesh, top, bottom = ctx.mesh, ctx.top, ctx.bottom
        s, n = mesh.spatial_index, mesh.n_spatial
        h = g.shape[2] - top - bottom
        parts = _all_gather(torch.cat([g[:, :, :top], g[:, :, top + h:]], dim=2), mesh)
        gx = g[:, :, top:top + h].contiguous()
        if s < n - 1 and top:  # the slab below read my last rows as its top halo
            gx[:, :, h - top:] += parts[s + 1][:, :, :top]
        if s > 0 and bottom:  # the slab above read my first rows as its bottom halo
            gx[:, :, :bottom] += parts[s - 1][:, :, top:]
        return gx, None, None, None, None


def _halo(mesh: SpatialMesh):
    """layers._halo for `mesh`: the rows a window of `kernel` rows at
    `stride`, padded `top` rows above the image, reads beyond a slab."""

    def halo(x: Tensor, top: int, bottom: int, kernel: int, stride: int, value: float) -> Tensor:
        h = x.shape[2]
        below = max(kernel - stride - top, 0)
        if h % stride or below > bottom:
            raise ValueError(f"a slab of {h} rows cannot take a {kernel}-row window at stride "
                             f"{stride} padded ({top}, {bottom}): its halo is not the padding")
        if mesh.n_spatial == 1:
            return F.pad(x, (0, 0, top, below), value=value)
        if max(top, below) > h:
            raise ValueError(f"a halo of {max(top, below)} rows exceeds the slab's {h} rows: "
                             "split the image into fewer slabs")
        return _Halo.apply(x, mesh, top, below, value)

    return halo


@contextlib.contextmanager
def slab_context(mesh: SpatialMesh):
    """Inside it, the trunks' paddings exchange halos over `mesh`."""
    before = layers._halo
    layers._halo = _halo(mesh)
    try:
        yield
    finally:
        layers._halo = before


class _GatherSlabs(torch.autograd.Function):
    """The [B, h, W, C] slabs of a data row's ranks joined along H; the
    backward returns this slab's rows of the gradient times n_spatial (the
    heads after it run replicated on every rank of the row)."""

    @staticmethod
    def forward(ctx, x: Tensor, mesh: SpatialMesh):
        ctx.mesh, ctx.rows = mesh, x.shape[1]
        return torch.cat(_all_gather(x, mesh), dim=1)

    @staticmethod
    def backward(ctx, g: Tensor):
        s, h = ctx.mesh.spatial_index, ctx.rows
        return g[:, s * h:(s + 1) * h] * ctx.mesh.n_spatial, None


def gather_slabs(x: Tensor, mesh: SpatialMesh) -> Tensor:
    """The whole NHWC map of a data row from each rank's H-slab of it."""
    return x if mesh.n_spatial == 1 else _GatherSlabs.apply(x, mesh)


def trunk_slab(trunk, images: Tensor, mesh: SpatialMesh, stride: int) -> Tensor:
    """The trunk's output on this rank's H-slab of the images [B, h, W, 3]:
    its slab of the stride-`stride` map."""
    check_slabs(images.shape[1] * mesh.n_spatial, mesh.n_spatial, stride)
    with slab_context(mesh):
        return trunk(images)


def canvas_hw(images: Tensor, mesh: Optional[SpatialMesh]) -> Tuple[int, int]:
    """The compute canvas (h, w) of a batch's images or of their slabs."""
    h, w = int(images.shape[1]), int(images.shape[2])
    return (h * mesh.n_spatial, w) if mesh is not None else (h, w)


def make_spatial_train_step(model, mesh: SpatialMesh, **train_step_kwargs):
    """The whole train step with H-sharded images: `make_train_step` over
    the grid's ranks, the model's trunk on each rank's slab with halo
    exchanges, its output gathered for the rest of the step. The step
    takes `shard_batch_spatial(mesh, batch)` and the draws of its data
    row (or a generator, as make_train_step)."""
    from mtlx_torch.train.train_step import make_train_step

    model.spatial = mesh
    return make_train_step(model, replicas=mesh, **train_step_kwargs)


def spatially_sharded_features(model, images: Tensor, mesh: SpatialMesh) -> Tensor:
    """The detector's trunk (its proposal features, batch norm in eval
    mode) on H-sharded images: `images` is the whole batch [B, H, W, 3],
    of which this rank computes its data row's rows and its own H-slab,
    exchanging halos with the other slabs. Returns this rank's slab of the
    stride-16 map [B / n_data, H / 16 / n_spatial, W / 16, C]."""
    stride = model.cfg.feature_stride
    model.modules.eval()
    with torch.no_grad():
        return trunk_slab(model.modules.backbone, mesh.slab(mesh.rows(images), stride), mesh,
                          stride)

"""BoxList, a tensor-backed box container with named per-box fields
(port of mtlx/geometry/box_list.py, the reference's core/box_list.py).

The detectors work on plain tensors (geometry/box_ops.py); this container
is for code that carries boxes together with their scores, classes or
masks. Gathers index every field alike.
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import Tensor

from mtlx_torch.geometry import box_ops


class BoxList:
    """[N, 4] boxes ([ymin, xmin, ymax, xmax]) and named extra fields, each
    with N rows."""

    def __init__(self, boxes, **fields):
        boxes = torch.as_tensor(boxes)
        if boxes.dim() != 2 or boxes.shape[-1] != 4:
            raise ValueError(f"boxes must be [N, 4], got {tuple(boxes.shape)}")
        self._data: Dict[str, Tensor] = {"boxes": boxes, **fields}

    def num_boxes(self) -> int:
        return self._data["boxes"].shape[0]

    def get(self) -> Tensor:
        return self._data["boxes"]

    def set(self, boxes: Tensor) -> None:
        self._data["boxes"] = boxes

    def get_field(self, name: str) -> Tensor:
        return self._data[name]

    def add_field(self, name: str, value) -> None:
        value = torch.as_tensor(value)
        n = self.num_boxes()
        if value.dim() == 0 or value.shape[0] != n:
            raise ValueError(f"field {name!r} has leading dim "
                             f"{value.shape[0] if value.dim() else None}, expected {n}")
        self._data[name] = value

    def has_field(self, name: str) -> bool:
        return name in self._data

    def get_extra_fields(self) -> List[str]:
        return [k for k in self._data if k != "boxes"]

    def area(self) -> Tensor:
        return box_ops.area(self.get())

    def gather(self, indices) -> "BoxList":
        indices = torch.as_tensor(indices, device=self.get().device)
        return BoxList(self.get()[indices],
                       **{k: v[indices] for k, v in self._data.items() if k != "boxes"})

    def clip_to_window(self, window) -> "BoxList":
        out = self.copy()
        out.set(box_ops.clip_to_window(self.get(), torch.as_tensor(window)))
        return out

    def scale(self, y_scale, x_scale) -> "BoxList":
        out = self.copy()
        out.set(box_ops.scale(self.get(), y_scale, x_scale))
        return out

    def copy(self) -> "BoxList":
        return BoxList(self.get(), **{k: v for k, v in self._data.items() if k != "boxes"})


def concatenate(boxlists: List[BoxList]) -> BoxList:
    """The boxes of every list, with the fields they all share."""
    fields = set(boxlists[0].get_extra_fields())
    for b in boxlists[1:]:
        fields &= set(b.get_extra_fields())
    return BoxList(torch.cat([b.get() for b in boxlists]),
                   **{f: torch.cat([b.get_field(f) for b in boxlists]) for f in fields})


def sort_by_field(boxlist: BoxList, field: str, descending: bool = True) -> BoxList:
    """The boxes ordered by a field (stably, as jnp.argsort)."""
    values = boxlist.get_field(field)
    order = torch.argsort(-values if descending else values, stable=True)
    return boxlist.gather(order)

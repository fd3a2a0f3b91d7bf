"""A numpy BoxList and its ops (port of mtlx/geometry/np_box_list.py, the
reference's utils/np_box_list.py and np_box_list_ops.py): the container
evaluation tooling works on, and a test oracle."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

from mtlx_torch.geometry import np_box_ops


class BoxList:
    """[N, 4] float32 boxes with named per-box fields; boxes must not be
    inverted."""

    def __init__(self, boxes: np.ndarray):
        boxes = np.asarray(boxes, np.float32)
        if boxes.ndim != 2 or boxes.shape[1] != 4:
            raise ValueError(f"boxes must be [N, 4], got {boxes.shape}")
        if len(boxes) and not ((boxes[:, 2] >= boxes[:, 0]).all()
                               and (boxes[:, 3] >= boxes[:, 1]).all()):
            raise ValueError("invalid box data (ymax < ymin or xmax < xmin)")
        self.data: Dict[str, np.ndarray] = {"boxes": boxes}

    def num_boxes(self) -> int:
        return len(self.data["boxes"])

    def get(self) -> np.ndarray:
        return self.data["boxes"]

    def get_field(self, name: str) -> np.ndarray:
        return self.data[name]

    def add_field(self, name: str, value) -> None:
        value = np.asarray(value)
        if len(value) != self.num_boxes():
            raise ValueError("field length must match num_boxes")
        self.data[name] = value

    def has_field(self, name: str) -> bool:
        return name in self.data

    def get_extra_fields(self) -> List[str]:
        return [k for k in self.data if k != "boxes"]


def area(boxlist: BoxList) -> np.ndarray:
    return np_box_ops.area(boxlist.get())


def iou(a: BoxList, b: BoxList) -> np.ndarray:
    return np_box_ops.iou(a.get(), b.get())


def ioa(a: BoxList, b: BoxList) -> np.ndarray:
    return np_box_ops.ioa(a.get(), b.get())


def gather(boxlist: BoxList, indices) -> BoxList:
    out = BoxList(boxlist.get()[indices])
    for f in boxlist.get_extra_fields():
        out.add_field(f, boxlist.get_field(f)[indices])
    return out


def sort_by_field(boxlist: BoxList, field: str, descending: bool = True) -> BoxList:
    values = boxlist.get_field(field)
    return gather(boxlist, np.argsort(-values if descending else values, kind="stable"))


def clip_to_window(boxlist: BoxList, window) -> BoxList:
    out = BoxList(np_box_ops.clip_to_window(boxlist.get(), np.asarray(window)))
    for f in boxlist.get_extra_fields():
        out.add_field(f, boxlist.get_field(f))
    return out


def non_max_suppression(boxlist: BoxList, max_output_size: int,
                        iou_threshold: float = 0.5) -> BoxList:
    """Greedy NMS of a BoxList with a "scores" field: the highest score
    first (ties in order), dropping boxes of IoU above the threshold with
    a kept one, at most max_output_size (0: none)."""
    order = np.argsort(-boxlist.get_field("scores"), kind="stable")
    boxes = boxlist.get()
    keep: List[int] = []
    suppressed = np.zeros(len(boxes), bool)
    for i in order:
        if suppressed[i]:
            continue
        if len(keep) >= max_output_size:
            break
        keep.append(int(i))
        if len(keep) == max_output_size:
            break
        suppressed |= np_box_ops.iou(boxes[i:i + 1], boxes)[0] > iou_threshold
    return gather(boxlist, np.asarray(keep, np.int64))

"""Non-max suppression (port of mtlx/ops/nms.py), greedy contract only.

`mtlx` carries four TPU-shaped formulations (fixed point, class-chunked,
priority-chunked, multiclass-chunked) that its tests prove equal to
greedy; the port implements greedy once, in
mtlx_torch/kernels/nms_cuda.py: the CUDA kernel on the card, its plain
version on the CPU. Every problem of a call goes into one launch: the
RPN's one problem per image, the postprocess's `B x num_classes`.

Where `mtlx` calls `jax.lax.top_k` (lower index first on ties) the port
takes a stable descending sort and slices it: `torch.topk` promises no
order among ties.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import torch
from torch import Tensor

from mtlx_torch.geometry import box_ops
from mtlx_torch.kernels import nms_cuda

_NEG = -1e10


def top_k(values: Tensor, k: int):
    """`jax.lax.top_k` over the last axis: the k largest values, ties to
    the lower index. Returns (values, indices)."""
    vals, idx = torch.sort(values, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def batched_non_max_suppression(
    boxes: Tensor,
    scores: Tensor,
    max_output_size: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
    valid_mask: Optional[Tensor] = None,
):
    """Greedy single-class NMS over a leading problem axis, one launch.
    boxes [P, N, 4], scores [P, N], valid_mask [P, N] bool ->
    (indices [P, max_output_size] int32 0-padded, keep [P, max_output_size] bool)."""
    if valid_mask is None:
        valid_mask = torch.ones(scores.shape, dtype=torch.bool, device=scores.device)
    return nms_cuda.non_max_suppression(
        boxes.contiguous(), scores.contiguous(), valid_mask.contiguous(),
        max_output_size, iou_threshold, score_threshold,
    )


def non_max_suppression_padded(
    boxes: Tensor,
    scores: Tensor,
    max_output_size: int,
    iou_threshold: float = 0.5,
    score_threshold: float = float("-inf"),
    valid_mask: Optional[Tensor] = None,
):
    """Greedy single-class NMS with padded output.
    boxes [N, 4], scores [N], valid_mask [N] ->
    (indices [max_output_size] int32 0-padded, keep [max_output_size] bool)."""
    idx, keep = batched_non_max_suppression(
        boxes[None], scores[None], max_output_size, iou_threshold,
        score_threshold, None if valid_mask is None else valid_mask[None],
    )
    return idx[0], keep[0]


class NMSResult(NamedTuple):
    boxes: Tensor  # [..., max_total, 4]
    scores: Tensor  # [..., max_total]
    classes: Tensor  # [..., max_total] int32 (0-based class ids, background removed)
    valid_mask: Tensor  # [..., max_total] bool
    num_valid: Tensor  # [...] int32
    extra_fields: Dict[str, Tensor] = {}  # gathered per-box fields [..., max_total, ...]


def batch_multiclass_non_max_suppression(
    boxes: Tensor,
    scores: Tensor,
    score_threshold: float,
    iou_threshold: float,
    max_size_per_class: int,
    max_total_size: int,
    clip_window: Optional[Tensor] = None,
    change_coordinate_frame: bool = False,
    valid_mask: Optional[Tensor] = None,
    extra_fields: Optional[Dict[str, Tensor]] = None,
) -> NMSResult:
    """Per-class score threshold + NMS + total cap for a batch of images,
    all `B x K` class problems in one launch.

    Args:
      boxes: [B, N, Q, 4] with Q == K (per-class boxes) or Q == 1 (shared).
      scores: [B, N, K] per-class scores WITHOUT the background column.
      clip_window: optional [4] or [B, 4]; boxes are clipped to it and
        zero-area clipped boxes dropped.
      change_coordinate_frame: re-express outputs relative to clip_window.
      valid_mask: [B, N] validity of input rows.
      extra_fields: optional dict of [B, N, ...] tensors gathered with the
        kept boxes (their source rows), zero where an output is padding.
    """
    b, n, num_classes = scores.shape
    extra_fields = extra_fields or {}
    for key, val in extra_fields.items():
        if tuple(val.shape[:2]) != (b, n):
            raise ValueError(f"extra_fields[{key!r}] must be [B, N, ...]; got "
                             f"{tuple(val.shape)} for boxes {tuple(boxes.shape)}")
    q = boxes.shape[2]
    dev = scores.device
    if valid_mask is None:
        valid_mask = torch.ones((b, n), dtype=torch.bool, device=dev)
    per_class = boxes.expand(b, n, num_classes, 4) if q == 1 else boxes
    window = None
    if clip_window is not None:
        window = torch.as_tensor(clip_window, dtype=boxes.dtype, device=dev)
        if window.dim() == 1:
            window = window.expand(b, 4)
        elif window.shape[0] != b:
            raise ValueError(f"clip_window batch {window.shape[0]} != boxes batch {b}")
        per_class = box_ops.clip_to_window(per_class, window[:, None, :])

    k = min(max_size_per_class, n)
    boxes_kn = per_class.transpose(1, 2).contiguous()  # [B, K, N, 4]
    scores_kn = scores.transpose(1, 2).contiguous()  # [B, K, N]
    live = valid_mask[:, None, :] & (box_ops.area(boxes_kn) > 0)
    idx, keep = nms_cuda.non_max_suppression(
        boxes_kn.reshape(b * num_classes, n, 4),
        scores_kn.reshape(b * num_classes, n),
        live.reshape(b * num_classes, n),
        k, iou_threshold, score_threshold,
    )
    idx = idx.reshape(b, num_classes, k).long()
    keep = keep.reshape(b, num_classes, k)
    cls_boxes = torch.gather(boxes_kn, 2, idx[..., None].expand(b, num_classes, k, 4))
    cls_scores = torch.where(keep, torch.gather(scores_kn, 2, idx), _NEG)
    class_ids = torch.arange(num_classes, dtype=torch.int32, device=dev)[:, None].expand(
        num_classes, k
    )

    flat_boxes = cls_boxes.reshape(b, -1, 4)
    flat_scores = cls_scores.reshape(b, -1)
    flat_keep = keep.reshape(b, -1)
    flat_classes = class_ids.reshape(-1).expand(b, -1)
    flat_src = idx.reshape(b, -1)

    total = min(max_total_size, flat_scores.shape[1])
    top_scores, top_i = top_k(flat_scores, total)
    out_boxes = torch.gather(flat_boxes, 1, top_i[..., None].expand(b, total, 4))
    out_classes = torch.gather(flat_classes, 1, top_i)
    out_keep = torch.gather(flat_keep, 1, top_i)
    out_src = torch.gather(flat_src, 1, top_i)
    if max_total_size > total:  # pad up if fewer candidates than requested
        pad = max_total_size - total
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=_NEG)
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        out_keep = torch.nn.functional.pad(out_keep, (0, pad))
        out_src = torch.nn.functional.pad(out_src, (0, pad))

    if change_coordinate_frame and window is not None:
        out_boxes = box_ops.change_coordinate_frame(out_boxes, window)

    extras = {}
    for key, val in extra_fields.items():
        rows = out_src.reshape(b, -1, *(1,) * (val.dim() - 2)).expand(
            b, out_src.shape[1], *val.shape[2:])
        keep_rows = out_keep.reshape(b, -1, *(1,) * (val.dim() - 2))
        extras[key] = torch.where(keep_rows, torch.gather(val, 1, rows),
                                  torch.zeros((), dtype=val.dtype, device=val.device))
    return NMSResult(
        boxes=torch.where(out_keep[..., None], out_boxes, 0.0),
        scores=torch.where(out_keep, top_scores, 0.0),
        classes=out_classes,
        valid_mask=out_keep,
        num_valid=out_keep.sum(-1).to(torch.int32),
        extra_fields=extras,
    )


def multiclass_non_max_suppression(
    boxes: Tensor,
    scores: Tensor,
    score_threshold: float,
    iou_threshold: float,
    max_size_per_class: int,
    max_total_size: int,
    clip_window: Optional[Tensor] = None,
    change_coordinate_frame: bool = False,
    valid_mask: Optional[Tensor] = None,
    extra_fields: Optional[Dict[str, Tensor]] = None,
) -> NMSResult:
    """One image: boxes [N, Q, 4], scores [N, K], clip_window [4],
    valid_mask [N], extra_fields of [N, ...] -> NMSResult with
    [max_total_size] fields."""
    res = batch_multiclass_non_max_suppression(
        boxes[None], scores[None], score_threshold, iou_threshold,
        max_size_per_class, max_total_size,
        clip_window=clip_window, change_coordinate_frame=change_coordinate_frame,
        valid_mask=None if valid_mask is None else valid_mask[None],
        extra_fields={k: v[None] for k, v in (extra_fields or {}).items()},
    )
    return NMSResult(*(t[0] for t in res[:5]),
                     extra_fields={k: v[0] for k, v in res.extra_fields.items()})

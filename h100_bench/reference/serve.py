"""The serving path's host front and postprocess, in plain PyTorch /
NumPy / PIL: frozen copies of mtlx_torch/export/exporter.py's
`InferenceModel._predict_decoded` (keep-aspect PIL resize, padding onto the
bucket of the batch's largest extent) and of FasterRCNN.postprocess with
ops/nms.py's `batch_multiclass_non_max_suppression` (softmax scores,
per-class decode, clip to the true image, per-class NMS, the total cap,
boxes re-expressed in the true image's frame), on the plain NMS."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import Tensor

from . import box_ops, nms as nms_lib
from . import kernels_plain
from .detector import Detector, softmax


def keep_aspect_target(h: int, w: int, min_dimension: int, max_dimension: int) -> Tuple[int, int]:
    scale = min(min_dimension / min(h, w), max_dimension / max(h, w))
    return int(round(h * scale)), int(round(w * scale))


def resize_and_pad(arrays: List[np.ndarray], resizer: Dict, canvas: Tuple[int, int],
                   multiple: int) -> Tuple[np.ndarray, np.ndarray]:
    """[H, W, 3] uint8 images -> ([B, bh, bw, 3] uint8 on the bucket of the
    largest true extent, [B, 2] int32 true shapes)."""
    from PIL import Image

    resized, shapes = [], []
    for a in arrays:
        th, tw = keep_aspect_target(a.shape[0], a.shape[1], resizer["min_dimension"],
                                    resizer["max_dimension"])
        if a.shape[:2] != (th, tw):
            a = np.asarray(Image.fromarray(a).resize((tw, th), Image.BILINEAR), dtype=a.dtype)
        resized.append(a[: canvas[0], : canvas[1]])
        shapes.append([min(th, canvas[0]), min(tw, canvas[1])])
    shapes = np.asarray(shapes, np.int32)
    bh, bw = (min(int(c), -(-int(e) // multiple) * multiple)
              for e, c in zip(shapes.max(0), canvas))
    images = np.zeros((len(resized), bh, bw, 3), np.uint8)
    for i, a in enumerate(resized):
        images[i, : a.shape[0], : a.shape[1]] = a
    return images, shapes


@torch.no_grad()
def postprocess(net: Detector, proposals: Tensor, proposal_mask: Tensor, class_logits: Tensor,
                box_refine: Tensor, true_shapes: Tensor) -> Dict[str, Tensor]:
    """Final detections: boxes normalized to each true image, scores,
    classes (1-based), num_detections."""
    c = net.cfg
    b, p = proposals.shape[:2]
    k = c.num_classes
    window = torch.cat([torch.zeros(b, 2, device=proposals.device), true_shapes.float()], dim=1)
    scores = softmax(class_logits)[..., 1:]
    anchors = proposals[:, :, None, :].expand(b, p, k, 4)
    boxes = net.coder.decode(box_refine.expand(anchors.shape), anchors)
    boxes = box_ops.clip_to_window(boxes, window[:, None, :])
    n = p
    per = min(c.second_stage_max_detections_per_class, n)
    boxes_kn = boxes.transpose(1, 2).contiguous()
    scores_kn = scores.transpose(1, 2).contiguous()
    live = proposal_mask[:, None, :] & (box_ops.area(boxes_kn) > 0)
    idx, keep = kernels_plain.non_max_suppression(
        boxes_kn.reshape(b * k, n, 4), scores_kn.reshape(b * k, n), live.reshape(b * k, n),
        per, c.second_stage_nms_iou_threshold, c.second_stage_nms_score_threshold)
    idx = idx.reshape(b, k, per).long()
    keep = keep.reshape(b, k, per)
    cls_boxes = torch.gather(boxes_kn, 2, idx[..., None].expand(b, k, per, 4))
    cls_scores = torch.where(keep, torch.gather(scores_kn, 2, idx), nms_lib._NEG)
    class_ids = torch.arange(k, dtype=torch.int32, device=proposals.device)[:, None].expand(k, per)
    total = min(c.second_stage_max_total_detections, k * per)
    top_scores, top_i = nms_lib.top_k(cls_scores.reshape(b, -1), total)
    out_boxes = torch.gather(cls_boxes.reshape(b, -1, 4), 1, top_i[..., None].expand(b, total, 4))
    out_classes = torch.gather(class_ids.reshape(-1).expand(b, -1), 1, top_i)
    out_keep = torch.gather(keep.reshape(b, -1), 1, top_i)
    pad = c.second_stage_max_total_detections - total
    if pad > 0:
        out_boxes = torch.nn.functional.pad(out_boxes, (0, 0, 0, pad))
        top_scores = torch.nn.functional.pad(top_scores, (0, pad), value=nms_lib._NEG)
        out_classes = torch.nn.functional.pad(out_classes, (0, pad))
        out_keep = torch.nn.functional.pad(out_keep, (0, pad))
    out_boxes = box_ops.change_coordinate_frame(out_boxes, window)
    return {"detection_boxes": torch.where(out_keep[..., None], out_boxes, 0.0),
            "detection_scores": torch.where(out_keep, top_scores, 0.0),
            "detection_classes": out_classes + 1,
            "num_detections": out_keep.sum(-1).to(torch.int32)}

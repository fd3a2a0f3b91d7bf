"""Target assignment (a frozen copy of mtlx_torch/assign/target_assigner.py): per-anchor
classification and regression targets and weights from padded ground
truth. Batched over leading dims of the ground truth (mtlx vmaps
`assign`); the anchors are one set `[A, 4]` or one per problem.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch import Tensor

from . import matcher as matcher_lib
from . import similarity as sim_lib
from . import box_coders


class AssignResult(NamedTuple):
    cls_targets: Tensor  # [..., A, K]
    cls_weights: Tensor  # [..., A]
    reg_targets: Tensor  # [..., A, 4]
    reg_weights: Tensor  # [..., A]
    match: Tensor  # [..., A] int32


class TargetAssigner(NamedTuple):
    similarity_fn: Callable[[Tensor, Tensor], Tensor]
    matcher_fn: Callable[..., Tensor]
    box_coder: box_coders.BoxCoder
    negative_class_weight: float = 1.0

    def assign(
        self,
        anchors: Tensor,
        gt_boxes: Tensor,
        gt_labels: Optional[Tensor] = None,
        gt_mask: Optional[Tensor] = None,
        unmatched_cls_target: Optional[Tensor] = None,
        gt_weights: Optional[Tensor] = None,
    ) -> AssignResult:
        """anchors [..., A, 4] (or [A, 4]); gt_boxes [..., G, 4] padded;
        gt_labels [..., G, K] (None: objectness targets of 1); gt_mask
        [..., G] bool; unmatched_cls_target [K] (None: zeros);
        gt_weights [..., G] (None: ones)."""
        lead, num_gt = gt_boxes.shape[:-2], gt_boxes.shape[-2]
        dev = gt_boxes.device
        if gt_mask is None:
            gt_mask = torch.ones((*lead, num_gt), dtype=torch.bool, device=dev)
        if gt_labels is None:
            gt_labels = torch.ones((*lead, num_gt, 1), dtype=torch.float32, device=dev)
        if unmatched_cls_target is None:
            unmatched_cls_target = torch.zeros(gt_labels.shape[-1:], dtype=gt_labels.dtype,
                                               device=dev)
        if gt_weights is None:
            gt_weights = torch.ones((*lead, num_gt), dtype=torch.float32, device=dev)

        similarity = self.similarity_fn(gt_boxes, anchors)  # [..., G, A]
        match = self.matcher_fn(similarity, row_mask=gt_mask)  # [..., A]
        matched = match >= 0
        safe = torch.clamp(match, 0, num_gt - 1)

        # unmatched and ignored anchors regress to themselves (zero code)
        matched_gt_boxes = torch.where(
            matched[..., None], matcher_lib.take_rows(gt_boxes, safe), anchors
        )
        reg_targets = self.box_coder.encode(matched_gt_boxes, anchors)
        reg_targets = torch.where(matched[..., None], reg_targets, 0.0)
        cls_targets = matcher_lib.gather_based_on_match(
            match, gt_labels, unmatched_value=unmatched_cls_target
        )
        matched_w = matcher_lib.take_rows(gt_weights, safe)
        reg_weights = torch.where(matched, matched_w, 0.0)
        cls_weights = torch.where(
            matched,
            matched_w,
            torch.where(match == matcher_lib.UNMATCHED, self.negative_class_weight, 0.0),
        )
        return AssignResult(cls_targets, cls_weights, reg_targets, reg_weights, match)


def create_target_assigner(reference: str, stage: Optional[str] = None,
                           negative_class_weight: float = 1.0) -> TargetAssigner:
    """Faster R-CNN's presets: ('FasterRCNN', 'proposal') IoU argmax
    0.7/0.3 with force-match; ('FasterRCNN', 'detection') 0.5/0.5."""
    if reference == "FasterRCNN" and stage == "proposal":
        matcher_fn = matcher_lib.make_argmax_matcher(0.7, 0.3, force_match_for_each_row=True)
    elif reference == "FasterRCNN" and stage == "detection":
        matcher_fn = matcher_lib.make_argmax_matcher(0.5, 0.5)
    else:
        raise ValueError(f"unknown target assigner preset {reference}/{stage}")
    return TargetAssigner(
        similarity_fn=sim_lib.iou_similarity,
        matcher_fn=matcher_fn,
        box_coder=box_coders.make_faster_rcnn_coder(),
        negative_class_weight=negative_class_weight,
    )

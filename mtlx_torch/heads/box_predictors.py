"""Faster R-CNN and R-FCN box predictor heads (port of
mtlx/heads/box_predictors.py).

The heads hold float32 parameters, compute in the module dtype (bfloat16
on the card) and emit float32 outputs, so the softmax and the decode run
in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.resnet import same_pad
from mtlx_torch.layers import Conv2d, Linear
from mtlx_torch.ops import roi as roi_ops


class RPNHead(nn.Module):
    """kxk conv trunk + 1x1 objectness/box heads over the stride-16 map.

    NHWC features [B, H, W, C] -> ([B, H*W*A, 2] objectness logits,
    [B, H*W*A, 4] box encodings) with the anchor index fastest, matching
    the GridAnchorGenerator layout."""

    def __init__(self, in_channels: int, num_anchors_per_location: int,
                 depth: int = 512, kernel_size: int = 3, atrous_rate: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_anchors = num_anchors_per_location
        self.kernel_size = kernel_size
        self.atrous_rate = atrous_rate
        self.dtype = dtype
        a = num_anchors_per_location
        self.conv = Conv2d(in_channels, depth, kernel_size, dilation=atrous_rate,
                           compute_dtype=dtype)
        self.objectness = Conv2d(depth, 2 * a, 1, compute_dtype=dtype)
        self.box_encodings = Conv2d(depth, 4 * a, 1, compute_dtype=dtype)

    def forward(self, features: Tensor):
        b = features.shape[0]
        x = features.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv(same_pad(x, self.kernel_size, 1, self.atrous_rate)))
        # NCHW -> NHWC before flattening, so (y, x, anchor) order holds
        obj = self.objectness(x).permute(0, 2, 3, 1)
        box = self.box_encodings(x).permute(0, 2, 3, 1)
        return (
            obj.float().reshape(b, -1, 2),
            box.float().reshape(b, -1, 4),
        )


class MaskRCNNBoxPredictor(nn.Module):
    """FC heads on pooled ROI features: [N, D] -> ([N, num_classes + 1]
    class logits, [N, num_classes, 4] per-class box refinements)."""

    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.class_logits = Linear(in_features, num_classes + 1, compute_dtype=dtype)
        self.box_refinement = Linear(in_features, num_classes * 4, compute_dtype=dtype)

    def forward(self, pooled: Tensor):
        x = pooled.to(self.dtype)
        cls = self.class_logits(x)
        box = self.box_refinement(x)
        return (
            cls.float(),
            box.float().reshape(*pooled.shape[:-1], self.num_classes, 4),
        )


class RfcnBoxPredictor(nn.Module):
    """R-FCN's position-sensitive score and box maps (mtlx.heads
    .box_predictors.RfcnBoxPredictor): a 1x1 `reduce` conv + ReLU, then
    1x1 `class_maps` (bins * (K + 1)) and `box_maps` (bins * K * 4) in
    the compute type, cast to float32 and cropped per proposal by the
    position-sensitive crop with the bins averaged.

    (NHWC features [B, H, W, C], canvas-normalized proposals [B, N, 4])
    -> (class logits [B, N, K + 1], box refinements [B, N, K, 4]),
    float32."""

    def __init__(self, in_channels: int, num_classes: int,
                 num_spatial_bins=(3, 3), depth: int = 1024, crop_size=(12, 12),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        bins = num_spatial_bins[0] * num_spatial_bins[1]
        self.num_classes = num_classes
        self.num_spatial_bins = tuple(num_spatial_bins)
        self.crop_size = tuple(crop_size)
        self.dtype = dtype
        self.reduce = Conv2d(in_channels, depth, 1, compute_dtype=dtype)
        self.class_maps = Conv2d(depth, bins * (num_classes + 1), 1, compute_dtype=dtype)
        self.box_maps = Conv2d(depth, bins * num_classes * 4, 1, compute_dtype=dtype)

    def forward(self, features: Tensor, proposal_boxes: Tensor):
        b, n = proposal_boxes.shape[:2]
        x = F.relu(self.reduce(features.to(self.dtype).permute(0, 3, 1, 2)))
        crop = lambda maps: roi_ops.position_sensitive_crop_regions(
            maps.permute(0, 2, 3, 1).float(), proposal_boxes, self.crop_size,
            self.num_spatial_bins, global_pool=True)
        cls = crop(self.class_maps(x))
        box = crop(self.box_maps(x))
        return cls, box.reshape(b, n, self.num_classes, 4)

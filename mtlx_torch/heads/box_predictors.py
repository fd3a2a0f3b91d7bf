"""Faster R-CNN box predictor heads (port of mtlx/heads/box_predictors.py).

Both heads compute in the module dtype (bfloat16 on the card) and emit
float32 outputs, so the softmax and the decode run in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.resnet import same_pad


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
        self.conv = nn.Conv2d(in_channels, depth, kernel_size,
                              dilation=atrous_rate, dtype=dtype)
        self.objectness = nn.Conv2d(depth, 2 * a, 1, dtype=dtype)
        self.box_encodings = nn.Conv2d(depth, 4 * a, 1, dtype=dtype)

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
        self.class_logits = nn.Linear(in_features, num_classes + 1, dtype=dtype)
        self.box_refinement = nn.Linear(in_features, num_classes * 4, dtype=dtype)

    def forward(self, pooled: Tensor):
        x = pooled.to(self.dtype)
        cls = self.class_logits(x)
        box = self.box_refinement(x)
        return (
            cls.float(),
            box.float().reshape(*pooled.shape[:-1], self.num_classes, 4),
        )

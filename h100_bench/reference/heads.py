"""The RPN head, the second stage's box predictor and the MTL-SSL
auxiliary heads, frozen copies of mtlx_torch/heads/box_predictors.py
(`RPNHead`, `MaskRCNNBoxPredictor` without dropout) and
mtlx_torch/heads/aux_heads.py, under the port's parameter names."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .layers import Conv2d, LayerNorm, Linear
from .resnet import same_pad

# the pooled heads' hidden width
HIDDEN = 1024


class RPNHead(nn.Module):
    """kxk conv trunk + 1x1 objectness / box heads over the stride-16 map:
    NHWC [B, H, W, C] -> ([B, H*W*A, 2] logits, [B, H*W*A, 4] encodings),
    the anchor index fastest."""

    def __init__(self, in_channels: int, num_anchors_per_location: int,
                 depth: int = 512, kernel_size: int = 3, atrous_rate: int = 1,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
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
        obj = self.objectness(x).permute(0, 2, 3, 1)
        box = self.box_encodings(x).permute(0, 2, 3, 1)
        return obj.float().reshape(b, -1, 2), box.float().reshape(b, -1, 4)


class MaskRCNNBoxPredictor(nn.Module):
    """FC heads on pooled ROI features: [N, D] -> ([N, K + 1] class logits,
    [N, K, 4] per-class box refinements)."""

    def __init__(self, in_features: int, num_classes: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_classes = num_classes
        self.dtype = dtype
        self.class_logits = Linear(in_features, num_classes + 1, compute_dtype=dtype)
        self.box_refinement = Linear(in_features, num_classes * 4, compute_dtype=dtype)

    def forward(self, pooled: Tensor):
        x = pooled.to(self.dtype)
        cls = self.class_logits(x)
        box = self.box_refinement(x)
        return cls.float(), box.float().reshape(*pooled.shape[:-1], self.num_classes, 4)


class ForegroundHead(nn.Module):
    """3x3 conv (256) + ReLU + 1x1 conv on the stride-16 map -> per-pixel
    foreground logits [B, H, W]."""

    def __init__(self, in_channels: int, depth: int = 256, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(in_channels, depth, 3, compute_dtype=dtype)
        self.logits = Conv2d(depth, 1, 1, compute_dtype=dtype)

    def forward(self, features: Tensor) -> Tensor:
        x = features.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv(same_pad(x, 3, 1)))
        return self.logits(x).float()[:, 0]


class PooledHead(nn.Module):
    """LayerNorm on pooled window features -> Dense(1024) + ReLU ->
    Dense(num_classes): the multi-object and the closeness heads."""

    def __init__(self, in_features: int, num_classes: int, hidden: int = HIDDEN,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.ln = LayerNorm(in_features)
        self.fc = Linear(in_features, hidden, compute_dtype=dtype)
        self.logits = Linear(hidden, num_classes, compute_dtype=dtype)

    def forward(self, pooled: Tensor) -> Tensor:
        x = F.relu(self.fc(self.ln(pooled.float()).to(self.dtype)))
        return self.logits(x).float()

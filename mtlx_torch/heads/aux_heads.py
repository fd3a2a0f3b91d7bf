"""The MTL-SSL auxiliary task heads (port of mtlx/heads/aux_heads.py), under
flax's names so the weight bridge maps them path to path:

  * ForegroundHead: 3x3 conv (256) + ReLU + 1x1 conv on the stride-16 map
    -> per-pixel foreground logits [B, H, W]
  * MultiObjectHead / ClosenessHead: LayerNorm (flax's, in float32) on
    pooled window features -> Dense(1024) + ReLU -> Dense(num_classes);
    return (logits float32, hidden activations)

Parameters are float32; the convs and dense layers compute in `dtype`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.resnet import same_pad
from mtlx_torch.layers import Conv2d, LayerNorm, Linear


class ForegroundHead(nn.Module):
    def __init__(self, in_channels: int, depth: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv = Conv2d(in_channels, depth, 3, compute_dtype=dtype)
        self.logits = Conv2d(depth, 1, 1, compute_dtype=dtype)

    def forward(self, features: Tensor) -> Tensor:  # NHWC -> [B, H, W]
        x = features.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv(same_pad(x, 3, 1)))
        return self.logits(x).float()[:, 0]


class _PooledHead(nn.Module):
    def __init__(self, in_features: int, num_classes: int, hidden: int = 1024,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.ln = LayerNorm(in_features)
        self.fc = Linear(in_features, hidden, compute_dtype=dtype)
        self.logits = Linear(hidden, num_classes, compute_dtype=dtype)

    def forward(self, pooled: Tensor):
        x = F.relu(self.fc(self.ln(pooled.float()).to(self.dtype)))
        return self.logits(x).float(), x


class MultiObjectHead(_PooledHead):
    """Soft multi-label class distribution of a window."""


class ClosenessHead(_PooledHead):
    """Proximity-weighted class distribution of an object's neighbours."""

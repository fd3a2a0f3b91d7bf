"""Inception v1 / GoogLeNet (port of mtlx/backbones/inception_v1.py):
frozen batch norm, bfloat16 compute by default.

NHWC in and out; inside, NCHW views of the same memory. Module names
repeat the flax names (`mixed_4f.b2b.conv`), so the weight bridge maps
path to path. Pools are flax's `max_pool(..., padding="SAME")`
(`max_pool_same`: -inf padding, the odd pixel after at stride 2). No
detector builds this trunk; the classifier pretraining path does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor, nn

from mtlx_torch.backbones.inception_resnet_v2 import ConvBN, max_pool_same
from mtlx_torch.backbones.resnet import _nchw, _nhwc
from mtlx_torch.layers import Linear


class InceptionModule(nn.Module):
    """Classic GoogLeNet module: 1x1 | 1x1-3x3 | 1x1-5x5 | pool-1x1."""

    def __init__(self, in_channels: int, b0: int, b1: Tuple[int, int], b2: Tuple[int, int],
                 pool_proj: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.b0 = ConvBN(in_channels, b0, 1, dtype=dtype)
        self.b1a = ConvBN(in_channels, b1[0], 1, dtype=dtype)
        self.b1b = ConvBN(b1[0], b1[1], 3, dtype=dtype)
        self.b2a = ConvBN(in_channels, b2[0], 1, dtype=dtype)
        self.b2b = ConvBN(b2[0], b2[1], 5, dtype=dtype)
        self.pool = ConvBN(in_channels, pool_proj, 1, dtype=dtype)
        self.out_channels = b0 + b1[1] + b2[1] + pool_proj

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        return torch.cat([self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
                          self.pool(max_pool_same(x, 1))], dim=1)


# (name, b0, b1, b2, pool_proj) in order; a stride-2 pool comes before
# mixed_4b and mixed_5b
_MODULES = (
    ("mixed_3b", 64, (96, 128), (16, 32), 32),
    ("mixed_3c", 128, (128, 192), (32, 96), 64),
    ("mixed_4b", 192, (96, 208), (16, 48), 64),
    ("mixed_4c", 160, (112, 224), (24, 64), 64),
    ("mixed_4d", 128, (128, 256), (24, 64), 64),
    ("mixed_4e", 112, (144, 288), (32, 64), 64),
    ("mixed_4f", 256, (160, 320), (32, 128), 128),
    ("mixed_5b", 256, (160, 320), (32, 128), 128),
    ("mixed_5c", 384, (192, 384), (48, 128), 128),
)


class InceptionV1Features(nn.Module):
    """Stem through Mixed_5c: [B, H, W, 3] -> (the Mixed_4f stride-16
    endpoint [832 channels], the stride-32 map [1024 channels])."""

    out_channels = (832, 1024)

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = ConvBN(3, 64, 7, 2, dtype=dtype)
        self.conv2a = ConvBN(64, 64, 1, dtype=dtype)
        self.conv2b = ConvBN(64, 192, 3, dtype=dtype)
        c = 192
        for name, *widths in _MODULES:
            module = InceptionModule(c, *widths, dtype=dtype)
            self.add_module(name, module)
            c = module.out_channels

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        x = _nchw(images.to(self.dtype))
        x = max_pool_same(self.conv1(x), 2)
        x = max_pool_same(self.conv2b(self.conv2a(x)), 2)  # /8
        x = self.mixed_3c(self.mixed_3b(x))
        x = max_pool_same(x, 2)  # /16
        for name in ("mixed_4b", "mixed_4c", "mixed_4d", "mixed_4e", "mixed_4f"):
            x = getattr(self, name)(x)
        endpoint_16 = x
        x = max_pool_same(x, 2, window=2)  # /32
        x = self.mixed_5c(self.mixed_5b(x))
        return _nhwc(endpoint_16), _nhwc(x)


class InceptionV1Classifier(nn.Module):
    """The trunk, a spatial mean and float32 logits."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.body = InceptionV1Features(dtype)
        self.logits = Linear(self.body.out_channels[1], num_classes)

    def forward(self, images: Tensor) -> Tensor:
        _, x = self.body(images)
        return self.logits(x.mean(dim=(1, 2)).float())

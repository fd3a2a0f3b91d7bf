"""Inception v3 (port of mtlx/backbones/inception_v3.py): the
classification network and its stride-16 feature endpoint (Mixed_6e),
frozen batch norm, bfloat16 compute by default.

NHWC in and out; inside, NCHW views of the same memory. Module names
repeat the flax names (`mixed_6b.b1b.conv`, `m7a_b1d.bn`), so the weight
bridge maps path to path. Every pool is flax's SAME pool: the max pools
pad with -inf (the odd pixel after at stride 2), the 3x3 average pools
count the zero padding in their mean. No detector builds this trunk;
the classifier pretraining path does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor, nn

from mtlx_torch.backbones.inception_resnet_v2 import ConvBN, avg_pool_same, max_pool_same
from mtlx_torch.backbones.resnet import _nchw, _nhwc
from mtlx_torch.layers import Linear


def _chain(module: nn.Module, names, x: Tensor) -> Tensor:
    for name in names:
        x = getattr(module, name)(x)
    return x


class MixedA(nn.Module):
    """35x35 block: 1x1 | 5x5 | double-3x3 | pool branches."""

    def __init__(self, in_channels: int, pool_features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype)
        self.b0 = cb(in_channels, 64, 1)
        self.b1a = cb(in_channels, 48, 1)
        self.b1b = cb(48, 64, 5)
        self.b2a = cb(in_channels, 64, 1)
        self.b2b = cb(64, 96, 3)
        self.b2c = cb(96, 96, 3)
        self.pool = cb(in_channels, pool_features, 1)
        self.out_channels = 64 + 64 + 96 + pool_features

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        return torch.cat([self.b0(x), _chain(self, ("b1a", "b1b"), x),
                          _chain(self, ("b2a", "b2b", "b2c"), x),
                          self.pool(avg_pool_same(x))], dim=1)


class MixedB(nn.Module):
    """17x17 block with 1x7 / 7x1 factorized convs."""

    def __init__(self, c7: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype)
        self.b0 = cb(768, 192, 1)
        self.b1a = cb(768, c7, 1)
        self.b1b = cb(c7, c7, (1, 7))
        self.b1c = cb(c7, 192, (7, 1))
        self.b2a = cb(768, c7, 1)
        self.b2b = cb(c7, c7, (7, 1))
        self.b2c = cb(c7, c7, (1, 7))
        self.b2d = cb(c7, c7, (7, 1))
        self.b2e = cb(c7, 192, (1, 7))
        self.pool = cb(768, 192, 1)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        return torch.cat([self.b0(x), _chain(self, ("b1a", "b1b", "b1c"), x),
                          _chain(self, ("b2a", "b2b", "b2c", "b2d", "b2e"), x),
                          self.pool(avg_pool_same(x))], dim=1)  # 768


class MixedC(nn.Module):
    """8x8 block with expanded 1x3 / 3x1 branches."""

    def __init__(self, in_channels: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype)
        self.b0 = cb(in_channels, 320, 1)
        self.b1a = cb(in_channels, 384, 1)
        self.b1b = cb(384, 384, (1, 3))
        self.b1c = cb(384, 384, (3, 1))
        self.b2a = cb(in_channels, 448, 1)
        self.b2b = cb(448, 384, 3)
        self.b2c = cb(384, 384, (1, 3))
        self.b2d = cb(384, 384, (3, 1))
        self.pool = cb(in_channels, 192, 1)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        b1 = self.b1a(x)
        b2 = self.b2b(self.b2a(x))
        return torch.cat([self.b0(x), self.b1b(b1), self.b1c(b1), self.b2c(b2), self.b2d(b2),
                          self.pool(avg_pool_same(x))], dim=1)  # 2048


class InceptionV3Features(nn.Module):
    """Stem through Mixed_7c: [B, H, W, 3] -> (the Mixed_6e stride-16
    endpoint [768 channels], the stride-32 map [2048 channels])."""

    out_channels = (768, 2048)

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cb = lambda i, o, k, s=1: ConvBN(i, o, k, s, dtype=dtype)
        self.conv1a = cb(3, 32, 3, 2)
        self.conv2a = cb(32, 32, 3)
        self.conv2b = cb(32, 64, 3)
        self.conv3b = cb(64, 80, 1)
        self.conv4a = cb(80, 192, 3)
        self.mixed_5b = MixedA(192, 32, dtype)
        self.mixed_5c = MixedA(256, 64, dtype)
        self.mixed_5d = MixedA(288, 64, dtype)
        # mixed_6a: the reduction to /16
        self.m6a_b0 = cb(288, 384, 3, 2)
        self.m6a_b1a = cb(288, 64, 1)
        self.m6a_b1b = cb(64, 96, 3)
        self.m6a_b1c = cb(96, 96, 3, 2)
        self.mixed_6b = MixedB(128, dtype)
        self.mixed_6c = MixedB(160, dtype)
        self.mixed_6d = MixedB(160, dtype)
        self.mixed_6e = MixedB(192, dtype)
        # mixed_7a: the reduction to /32
        self.m7a_b0a = cb(768, 192, 1)
        self.m7a_b0b = cb(192, 320, 3, 2)
        self.m7a_b1a = cb(768, 192, 1)
        self.m7a_b1b = cb(192, 192, (1, 7))
        self.m7a_b1c = cb(192, 192, (7, 1))
        self.m7a_b1d = cb(192, 192, 3, 2)
        self.mixed_7b = MixedC(1280, dtype)
        self.mixed_7c = MixedC(2048, dtype)

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        x = _nchw(images.to(self.dtype))
        x = max_pool_same(_chain(self, ("conv1a", "conv2a", "conv2b"), x), 2)
        x = max_pool_same(self.conv4a(self.conv3b(x)), 2)  # /8
        x = _chain(self, ("mixed_5b", "mixed_5c", "mixed_5d"), x)
        x = torch.cat([self.m6a_b0(x), _chain(self, ("m6a_b1a", "m6a_b1b", "m6a_b1c"), x),
                       max_pool_same(x, 2)], dim=1)  # 768
        x = _chain(self, ("mixed_6b", "mixed_6c", "mixed_6d", "mixed_6e"), x)
        endpoint_16 = x
        x = torch.cat([_chain(self, ("m7a_b0a", "m7a_b0b"), x),
                       _chain(self, ("m7a_b1a", "m7a_b1b", "m7a_b1c", "m7a_b1d"), x),
                       max_pool_same(x, 2)], dim=1)  # 1280
        x = self.mixed_7c(self.mixed_7b(x))
        return _nhwc(endpoint_16), _nhwc(x)


class InceptionV3Classifier(nn.Module):
    """The trunk, a spatial mean and float32 logits."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.body = InceptionV3Features(dtype)
        self.logits = Linear(self.body.out_channels[1], num_classes)

    def forward(self, images: Tensor) -> Tensor:
        _, x = self.body(images)
        return self.logits(x.mean(dim=(1, 2)).float())

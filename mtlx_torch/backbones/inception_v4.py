"""Inception v4 (port of mtlx/backbones/inception_v4.py): the stem, the
A / B / C blocks with their reductions, frozen batch norm, bfloat16
compute by default.

NHWC in and out; inside, NCHW views of the same memory. Module names
repeat the flax names (`mixed_6h.b2e.conv`, `rb_b1d.bn`), so the weight
bridge maps path to path. Pools are flax's SAME pools, as in
inception_v3. No detector builds this trunk; the classifier pretraining
path does.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor, nn

from mtlx_torch.backbones.inception_resnet_v2 import ConvBN, avg_pool_same, max_pool_same
from mtlx_torch.backbones.inception_v3 import _chain
from mtlx_torch.backbones.resnet import _nchw, _nhwc
from mtlx_torch.layers import Linear


class BlockA(nn.Module):
    """35x35: 384 -> 384 channels."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype)
        self.b0 = cb(384, 96, 1)
        self.b1a = cb(384, 64, 1)
        self.b1b = cb(64, 96, 3)
        self.b2a = cb(384, 64, 1)
        self.b2b = cb(64, 96, 3)
        self.b2c = cb(96, 96, 3)
        self.pool = cb(384, 96, 1)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        return torch.cat([self.b0(x), _chain(self, ("b1a", "b1b"), x),
                          _chain(self, ("b2a", "b2b", "b2c"), x),
                          self.pool(avg_pool_same(x))], dim=1)


class BlockB(nn.Module):
    """17x17: 1024 -> 1024 channels."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype)
        self.b0 = cb(1024, 384, 1)
        self.b1a = cb(1024, 192, 1)
        self.b1b = cb(192, 224, (1, 7))
        self.b1c = cb(224, 256, (7, 1))
        self.b2a = cb(1024, 192, 1)
        self.b2b = cb(192, 192, (7, 1))
        self.b2c = cb(192, 224, (1, 7))
        self.b2d = cb(224, 224, (7, 1))
        self.b2e = cb(224, 256, (1, 7))
        self.pool = cb(1024, 128, 1)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        return torch.cat([self.b0(x), _chain(self, ("b1a", "b1b", "b1c"), x),
                          _chain(self, ("b2a", "b2b", "b2c", "b2d", "b2e"), x),
                          self.pool(avg_pool_same(x))], dim=1)


class BlockC(nn.Module):
    """8x8: 1536 -> 1536 channels."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype)
        self.b0 = cb(1536, 256, 1)
        self.b1a = cb(1536, 384, 1)
        self.b1b = cb(384, 256, (1, 3))
        self.b1c = cb(384, 256, (3, 1))
        self.b2a = cb(1536, 384, 1)
        self.b2b = cb(384, 448, (3, 1))
        self.b2c = cb(448, 512, (1, 3))
        self.b2d = cb(512, 256, (1, 3))
        self.b2e = cb(512, 256, (3, 1))
        self.pool = cb(1536, 256, 1)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        b1 = self.b1a(x)
        b2 = _chain(self, ("b2a", "b2b", "b2c"), x)
        return torch.cat([self.b0(x), self.b1b(b1), self.b1c(b1), self.b2d(b2), self.b2e(b2),
                          self.pool(avg_pool_same(x))], dim=1)


class InceptionV4Features(nn.Module):
    """[B, H, W, 3] -> (the Mixed_6h stride-16 endpoint [1024 channels],
    the Mixed_7d stride-32 map [1536 channels])."""

    out_channels = (1024, 1536)

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        cb = lambda i, o, k, s=1: ConvBN(i, o, k, s, dtype=dtype)
        # the stem
        self.conv1 = cb(3, 32, 3, 2)
        self.conv2 = cb(32, 32, 3)
        self.conv3 = cb(32, 64, 3)
        self.stem_conv = cb(64, 96, 3, 2)
        self.s1a = cb(160, 64, 1)
        self.s1b = cb(64, 96, 3)
        self.s2a = cb(160, 64, 1)
        self.s2b = cb(64, 64, (1, 7))
        self.s2c = cb(64, 64, (7, 1))
        self.s2d = cb(64, 96, 3)
        self.s3 = cb(192, 192, 3, 2)
        for i in range(4):
            self.add_module(f"mixed_5{chr(98 + i)}", BlockA(dtype))
        # reduction A -> /16
        self.ra_b0 = cb(384, 384, 3, 2)
        self.ra_b1a = cb(384, 192, 1)
        self.ra_b1b = cb(192, 224, 3)
        self.ra_b1c = cb(224, 256, 3, 2)
        for i in range(7):
            self.add_module(f"mixed_6{chr(98 + i)}", BlockB(dtype))
        # reduction B -> /32
        self.rb_b0a = cb(1024, 192, 1)
        self.rb_b0b = cb(192, 192, 3, 2)
        self.rb_b1a = cb(1024, 256, 1)
        self.rb_b1b = cb(256, 256, (1, 7))
        self.rb_b1c = cb(256, 320, (7, 1))
        self.rb_b1d = cb(320, 320, 3, 2)
        for i in range(3):
            self.add_module(f"mixed_7{chr(98 + i)}", BlockC(dtype))

    def forward(self, images: Tensor) -> Tuple[Tensor, Tensor]:
        x = _nchw(images.to(self.dtype))
        x = _chain(self, ("conv1", "conv2", "conv3"), x)
        x = torch.cat([max_pool_same(x, 2), self.stem_conv(x)], dim=1)  # /4, 160
        x = torch.cat([_chain(self, ("s1a", "s1b"), x),
                       _chain(self, ("s2a", "s2b", "s2c", "s2d"), x)], dim=1)  # 192
        x = torch.cat([self.s3(x), max_pool_same(x, 2)], dim=1)  # /8, 384
        x = _chain(self, [f"mixed_5{chr(98 + i)}" for i in range(4)], x)
        x = torch.cat([self.ra_b0(x), _chain(self, ("ra_b1a", "ra_b1b", "ra_b1c"), x),
                       max_pool_same(x, 2)], dim=1)  # 1024
        x = _chain(self, [f"mixed_6{chr(98 + i)}" for i in range(7)], x)
        endpoint_16 = x
        x = torch.cat([_chain(self, ("rb_b0a", "rb_b0b"), x),
                       _chain(self, ("rb_b1a", "rb_b1b", "rb_b1c", "rb_b1d"), x),
                       max_pool_same(x, 2)], dim=1)  # 1536
        x = _chain(self, [f"mixed_7{chr(98 + i)}" for i in range(3)], x)
        return _nhwc(endpoint_16), _nhwc(x)


class InceptionV4Classifier(nn.Module):
    """The trunk, a spatial mean and float32 logits."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.body = InceptionV4Features(dtype)
        self.logits = Linear(self.body.out_channels[1], num_classes)

    def forward(self, images: Tensor) -> Tensor:
        _, x = self.body(images)
        return self.logits(x.mean(dim=(1, 2)).float())

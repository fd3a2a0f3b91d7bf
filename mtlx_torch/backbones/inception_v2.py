"""Inception v2 (port of mtlx/backbones/inception_v2.py): the trunk with
its two endpoints, Mixed_4e (stride 16, 576 channels) and Mixed_5c
(stride 32, 1024 channels), and the Faster R-CNN split of it.

  * proposal features: the stem through Mixed_4e;
  * box classifier features: Mixed_5a (stride 2) through Mixed_5c on the
    ROI crops; the caller pools.

The stem is slim's separable Conv2d_1a_7x7: a depthwise 7x7/2 with
channel multiplier min(64 // 3, 8) = 8, which is a grouped conv with
groups = 3 and 24 outputs (flax's HWIO kernel [7, 7, 1, 24] is the
OIHW weight [24, 1, 7, 7]), then a 1x1 ConvBN to 64.

mtlx's InceptionV2ProposalFeatures runs the whole trunk and keeps
Mixed_4e; XLA drops the dead Mixed_5a-5c. The port keeps those
parameters, so mtlx's variable tree loads path for path, and does not
compute them.

Every width is d(c) = max(int(c * depth_multiplier), min_depth), as in
mtlx (ssd_inception_v2's feature_extractor.depth_multiplier; the stem's
channel multiplier follows d(64)).

NHWC in and out; names, SAME padding, pools and batch norm as in
inception_resnet_v2.py, whose ConvBN and BNKnobs this trunk shares.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import torch
from torch import Tensor, nn

from mtlx_torch.backbones.inception_resnet_v2 import (
    BNKnobs,
    ConvBN,
    avg_pool_same,
    max_pool_same,
)
from mtlx_torch.backbones.resnet import _nchw, _nhwc, same_pad
from mtlx_torch.layers import Conv2d


class InceptionBlock(nn.Module):
    """1x1 | 1x1-3x3 | 1x1-3x3-3x3 | pool-1x1, concatenated."""

    def __init__(self, in_channels: int, b0: int, b1: Tuple[int, int], b2: Tuple[int, int],
                 pool_proj: int, use_max_pool: bool = False,
                 dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs()):
        super().__init__()
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype, bn=bn)
        self.use_max_pool = use_max_pool
        if b0:
            self.b0 = cb(in_channels, b0, 1)
        self.b1a = cb(in_channels, b1[0], 1)
        self.b1b = cb(b1[0], b1[1], 3)
        self.b2a = cb(in_channels, b2[0], 1)
        self.b2b = cb(b2[0], b2[1], 3)
        self.b2c = cb(b2[1], b2[1], 3)
        if pool_proj:
            self.pool_proj = cb(in_channels, pool_proj, 1)
        self.out_channels = b0 + b1[1] + b2[1] + (pool_proj or in_channels)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        outs = [self.b0(x)] if hasattr(self, "b0") else []
        outs.append(self.b1b(self.b1a(x)))
        outs.append(self.b2c(self.b2b(self.b2a(x))))
        p = max_pool_same(x, 1) if self.use_max_pool else avg_pool_same(x)
        outs.append(self.pool_proj(p) if hasattr(self, "pool_proj") else p)
        return torch.cat(outs, dim=1)


class ReductionBlock(nn.Module):
    """Stride-2 reduction: 1x1-3x3/2 | 1x1-3x3-3x3/2 | max pool 3x3/2."""

    def __init__(self, in_channels: int, b1: Tuple[int, int], b2: Tuple[int, int],
                 dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs()):
        super().__init__()
        cb = lambda i, o, k, s=1: ConvBN(i, o, k, s, dtype=dtype, bn=bn)
        self.b1a = cb(in_channels, b1[0], 1)
        self.b1b = cb(b1[0], b1[1], 3, 2)
        self.b2a = cb(in_channels, b2[0], 1)
        self.b2b = cb(b2[0], b2[1], 3)
        self.b2c = cb(b2[1], b2[1], 3, 2)
        self.out_channels = b1[1] + b2[1] + in_channels

    def forward(self, x: Tensor) -> Tensor:
        return torch.cat([self.b1b(self.b1a(x)), self.b2c(self.b2b(self.b2a(x))),
                          max_pool_same(x, 2)], dim=1)


class SeparableStem(nn.Module):
    """slim's Conv2d_1a_7x7: depthwise 7x7/2 (channel multiplier
    min(features // in, 8)) -> 1x1 ConvBN to `features`; batch norm and
    ReLU once, after the pointwise conv."""

    def __init__(self, in_channels: int = 3, features: int = 64,
                 dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs()):
        super().__init__()
        mult = max(1, min(features // in_channels, 8))
        self.depthwise = Conv2d(in_channels, in_channels * mult, 7, stride=2,
                                groups=in_channels, bias=False, compute_dtype=dtype)
        self.pointwise = ConvBN(in_channels * mult, features, 1, dtype=dtype, bn=bn)

    def forward(self, x: Tensor) -> Tensor:
        return self.pointwise(self.depthwise(same_pad(x, 7, 2)))


def _widths(depth_multiplier: float, min_depth: int) -> Callable[[int], int]:
    return lambda c: max(int(c * depth_multiplier), min_depth)


def mixed_4e_channels(depth_multiplier: float = 1.0, min_depth: int = 16) -> int:
    """Mixed_4e's width (576 at depth multiplier 1): the proposal features'
    channels and the input of the box classifier's Mixed_5a."""
    d = _widths(depth_multiplier, min_depth)
    return d(96) + d(192) + d(192) + d(96)


def _mixed_5(in_channels: int, d, kw) -> List[Tuple[str, nn.Module]]:
    """Mixed_5a (stride 2) through Mixed_5c."""
    a = ReductionBlock(in_channels, (d(128), d(192)), (d(192), d(256)), **kw)
    b = InceptionBlock(a.out_channels, d(352), (d(192), d(320)), (d(160), d(224)), d(128), **kw)
    c = InceptionBlock(b.out_channels, d(352), (d(192), d(320)), (d(192), d(224)), d(128), True,
                       **kw)
    return [("mixed_5a", a), ("mixed_5b", b), ("mixed_5c", c)]


class InceptionV2(nn.Module):
    """[B, H, W, 3] -> [Mixed_4e (stride 16), Mixed_5c (stride 32)], NHWC;
    `stride16_only` stops after Mixed_4e."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs(),
                 depth_multiplier: float = 1.0, min_depth: int = 16):
        super().__init__()
        self.dtype = dtype
        kw = dict(dtype=dtype, bn=bn)
        d = _widths(depth_multiplier, min_depth)
        self.conv1 = SeparableStem(3, d(64), **kw)
        self.conv2a = ConvBN(d(64), d(64), 1, **kw)
        self.conv2b = ConvBN(d(64), d(192), 3, **kw)
        c = d(192)
        for name, make in (
            ("mixed_3b", lambda c: InceptionBlock(c, d(64), (d(64), d(64)), (d(64), d(96)),
                                                  d(32), **kw)),
            ("mixed_3c", lambda c: InceptionBlock(c, d(64), (d(64), d(96)), (d(64), d(96)),
                                                  d(64), **kw)),
            ("mixed_4a", lambda c: ReductionBlock(c, (d(128), d(160)), (d(64), d(96)), **kw)),
            ("mixed_4b", lambda c: InceptionBlock(c, d(224), (d(64), d(96)), (d(96), d(128)),
                                                  d(128), **kw)),
            ("mixed_4c", lambda c: InceptionBlock(c, d(192), (d(96), d(128)), (d(96), d(128)),
                                                  d(128), **kw)),
            ("mixed_4d", lambda c: InceptionBlock(c, d(160), (d(128), d(160)),
                                                  (d(128), d(160)), d(96), **kw)),
            ("mixed_4e", lambda c: InceptionBlock(c, d(96), (d(128), d(192)), (d(160), d(192)),
                                                  d(96), **kw)),
        ):
            block = make(c)
            self.add_module(name, block)
            c = block.out_channels
        self.channels_16 = c
        for name, block in _mixed_5(c, d, kw):
            self.add_module(name, block)
        self.channels_32 = self.mixed_5c.out_channels

    def forward(self, images: Tensor, stride16_only: bool = False) -> List[Tensor]:
        x = _nchw(images.to(self.dtype))
        x = max_pool_same(self.conv1(x), 2)
        x = max_pool_same(self.conv2b(self.conv2a(x)), 2)  # /8
        for name in ("mixed_3b", "mixed_3c", "mixed_4a", "mixed_4b", "mixed_4c", "mixed_4d",
                     "mixed_4e"):
            x = getattr(self, name)(x)
        endpoint_16 = _nhwc(x)
        if stride16_only:
            return [endpoint_16]
        for name in ("mixed_5a", "mixed_5b", "mixed_5c"):
            x = getattr(self, name)(x)
        return [endpoint_16, _nhwc(x)]


class InceptionV2ProposalFeatures(nn.Module):
    """The stem through Mixed_4e: [B, H, W, 3] -> [B, H/16, W/16, 576]."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs(),
                 depth_multiplier: float = 1.0, min_depth: int = 16):
        super().__init__()
        self.body = InceptionV2(dtype, bn, depth_multiplier, min_depth)
        self.out_channels = self.body.channels_16

    def forward(self, images: Tensor) -> Tensor:
        return self.body(images, stride16_only=True)[0]


class InceptionV2BoxClassifierFeatures(nn.Module):
    """Mixed_5a (stride 2, as in mtlx) through Mixed_5c on ROI crops:
    [N, 7, 7, 576] -> [N, 4, 4, 1024]."""

    def __init__(self, dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs(),
                 depth_multiplier: float = 1.0, min_depth: int = 16):
        super().__init__()
        self.dtype = dtype
        d = _widths(depth_multiplier, min_depth)
        for name, block in _mixed_5(mixed_4e_channels(depth_multiplier, min_depth), d,
                                    dict(dtype=dtype, bn=bn)):
            self.add_module(name, block)
        self.out_channels = self.mixed_5c.out_channels

    def forward(self, x: Tensor) -> Tensor:
        x = _nchw(x.to(self.dtype))
        return _nhwc(self.mixed_5c(self.mixed_5b(self.mixed_5a(x))))

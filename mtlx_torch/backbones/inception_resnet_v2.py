"""Inception-ResNet-v2 with the Faster R-CNN split (port of
mtlx/backbones/inception_resnet_v2.py).

  * proposal features: the stem, mixed_5b, 10 x block35, mixed_6a and
    20 x block17 (stride 16, 1088 channels);
  * box classifier features: mixed_7a at stride 1, 9 x block8, the last
    block8 without its ReLU and conv7b (1536 channels) on the ROI crops;
    the caller pools.

NHWC in and out, as the ResNet trunk (mtlx_torch/backbones/resnet.py);
inside, NCHW views of the same memory. Submodule names repeat the flax
names (`block35_1.b2c.conv`, `m6a_b0.bn`), so the weight bridge maps
path to path. Every `padding="SAME"` of mtlx is flax's: a stride-1 conv
or pool pads (k - 1) / 2 on each side, a stride-2 one pads as
`resnet.same_pad` (the odd pixel after), with -inf before a max pool.
Flax's `avg_pool` counts the zero padding in its mean
(`count_include_pad`), and so does the port.

Batch norm is frozen (the three configs that use these trunks freeze
it) with slim's inception defaults, epsilon 1e-3 and decay 0.9997
(`INCEPTION_BN`), unless the config's feature_extractor.batch_norm
overrides them.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.resnet import BNSpec, _nchw, _nhwc, make_norm, same_pad
from mtlx_torch import layers
from mtlx_torch.layers import Conv2d

# slim's inception arg_scope batch norm (inception v2 / v3 / v4 and
# inception_resnet_v2): decay 0.9997, epsilon 1e-3
INCEPTION_BN = BNSpec(momentum=0.9997, epsilon=1e-3)


class BNKnobs(NamedTuple):
    """The feature extractor's batch-norm knobs that every ConvBN of a
    trunk takes: batch_norm_trainable and the batch-norm parameters."""

    trainable: bool = False
    spec: BNSpec = INCEPTION_BN


def _pair(k: Union[int, Tuple[int, int]]) -> Tuple[int, int]:
    return (k, k) if isinstance(k, int) else tuple(k)


def max_pool_same(x: Tensor, stride: int, window: int = 3) -> Tensor:
    """flax `max_pool(x, (k, k), strides=(s, s), padding="SAME")` on NCHW
    (k = window)."""
    if stride == 1 and window % 2:
        return layers.max_pool2d(x, window, 1, padding=window // 2)  # pads with -inf
    return F.max_pool2d(same_pad(x, window, stride, value=float("-inf")), window, stride)


def avg_pool_same(x: Tensor) -> Tensor:
    """flax `avg_pool(x, (3, 3), strides=(1, 1), padding="SAME")` on NCHW:
    the zero padding counts in the mean."""
    return layers.avg_pool2d(x, 3, 1, padding=1)


class ConvBN(nn.Module):
    """Conv (no bias, SAME) -> frozen batch norm -> ReLU (optional)."""

    def __init__(self, in_channels: int, features: int, kernel=(3, 3), stride: int = 1,
                 relu: bool = True, dtype: torch.dtype = torch.bfloat16,
                 bn: BNKnobs = BNKnobs()):
        super().__init__()
        kh, kw = _pair(kernel)
        if stride > 1 and kh != kw:
            raise ValueError(f"a strided SAME conv needs a square kernel, got {kernel}")
        self.stride, self.kernel, self.relu = stride, kh, relu
        pad = 0 if stride > 1 else ((kh - 1) // 2, (kw - 1) // 2)
        self.conv = Conv2d(in_channels, features, (kh, kw), stride=stride, padding=pad,
                           bias=False, compute_dtype=dtype)
        self.bn = make_norm(features, bn.trainable, bn.spec)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        if self.stride > 1:
            x = same_pad(x, self.kernel, self.stride)
        x = self.bn(self.conv(x))
        return F.relu(x) if self.relu else x


class _ResidualBlock(nn.Module):
    """x + scale * up(concat(branches)), then ReLU (optional); `up` is a
    1x1 conv with a bias back to x's width. Each branch is a sequence of
    ConvBN names."""

    def __init__(self, channels: int, branches, scale: float, relu: bool,
                 dtype: torch.dtype, bn: BNKnobs):
        super().__init__()
        self.scale, self.relu = scale, relu
        self.branches = []
        mixed = 0
        for branch in branches:
            names, c = [], channels
            for name, features, kernel in branch:
                self.add_module(name, ConvBN(c, features, kernel, dtype=dtype, bn=bn))
                names.append(name)
                c = features
            self.branches.append(names)
            mixed += c
        self.up = Conv2d(mixed, channels, 1, compute_dtype=dtype)

    def forward(self, x: Tensor) -> Tensor:
        outs = []
        for names in self.branches:
            y = x
            for name in names:
                y = getattr(self, name)(y)
            outs.append(y)
        out = x + self.scale * self.up(torch.cat(outs, dim=1))
        return F.relu(out) if self.relu else out


class Block35(_ResidualBlock):
    """35x35 inception-resnet block, scale 0.17."""

    def __init__(self, channels: int = 320, dtype: torch.dtype = torch.bfloat16,
                 bn: BNKnobs = BNKnobs()):
        super().__init__(channels, (
            (("b0", 32, 1),),
            (("b1a", 32, 1), ("b1b", 32, 3)),
            (("b2a", 32, 1), ("b2b", 48, 3), ("b2c", 64, 3)),
        ), 0.17, True, dtype, bn)


class Block17(_ResidualBlock):
    """17x17 block, scale 0.10."""

    def __init__(self, channels: int = 1088, dtype: torch.dtype = torch.bfloat16,
                 bn: BNKnobs = BNKnobs()):
        super().__init__(channels, (
            (("b0", 192, 1),),
            (("b1a", 128, 1), ("b1b", 160, (1, 7)), ("b1c", 192, (7, 1))),
        ), 0.10, True, dtype, bn)


class Block8(_ResidualBlock):
    """8x8 block, scale 0.20; the last of the trunk has no ReLU."""

    def __init__(self, channels: int = 2080, relu: bool = True,
                 dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs()):
        super().__init__(channels, (
            (("b0", 192, 1),),
            (("b1a", 192, 1), ("b1b", 224, (1, 3)), ("b1c", 256, (3, 1))),
        ), 0.20, relu, dtype, bn)


class InceptionResnetV2ProposalFeatures(nn.Module):
    """Stem through the block17 repeats: [B, H, W, 3] -> [B, H/16, W/16,
    1088] (ceil division at each SAME stride)."""

    out_channels = 1088

    def __init__(self, dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs()):
        super().__init__()
        self.dtype = dtype
        cb = lambda i, o, k, s=1: ConvBN(i, o, k, s, dtype=dtype, bn=bn)
        self.conv1 = cb(3, 32, 3, 2)
        self.conv2 = cb(32, 32, 3)
        self.conv3 = cb(32, 64, 3)
        self.conv4 = cb(64, 80, 1)
        self.conv5 = cb(80, 192, 3)
        # mixed_5b
        self.m5b_b0 = cb(192, 96, 1)
        self.m5b_b1a = cb(192, 48, 1)
        self.m5b_b1b = cb(48, 64, 5)
        self.m5b_b2a = cb(192, 64, 1)
        self.m5b_b2b = cb(64, 96, 3)
        self.m5b_b2c = cb(96, 96, 3)
        self.m5b_b3 = cb(192, 64, 1)
        for i in range(10):
            self.add_module(f"block35_{i + 1}", Block35(320, dtype, bn))
        # mixed_6a (stride 2 -> /16)
        self.m6a_b0 = cb(320, 384, 3, 2)
        self.m6a_b1a = cb(320, 256, 1)
        self.m6a_b1b = cb(256, 256, 3)
        self.m6a_b1c = cb(256, 384, 3, 2)
        for i in range(20):
            self.add_module(f"block17_{i + 1}", Block17(1088, dtype, bn))

    def forward(self, images: Tensor) -> Tensor:
        x = _nchw(images.to(self.dtype))
        x = self.conv3(self.conv2(self.conv1(x)))
        x = max_pool_same(x, 2)
        x = self.conv5(self.conv4(x))
        x = max_pool_same(x, 2)
        x = torch.cat([
            self.m5b_b0(x),
            self.m5b_b1b(self.m5b_b1a(x)),
            self.m5b_b2c(self.m5b_b2b(self.m5b_b2a(x))),
            self.m5b_b3(avg_pool_same(x)),
        ], dim=1)  # 320
        for i in range(10):
            x = getattr(self, f"block35_{i + 1}")(x)
        x = torch.cat([
            self.m6a_b0(x),
            self.m6a_b1c(self.m6a_b1b(self.m6a_b1a(x))),
            max_pool_same(x, 2),
        ], dim=1)  # 1088
        for i in range(20):
            x = getattr(self, f"block17_{i + 1}")(x)
        return _nhwc(x)


class InceptionResnetV2BoxClassifierFeatures(nn.Module):
    """mixed_7a at stride 1, the block8 repeats and conv7b on ROI crops:
    [N, h, w, 1088] -> [N, h, w, 1536]. mixed_7a's fourth branch is its
    max pool at stride 1 (3x3, SAME), as in mtlx."""

    out_channels = 1536

    def __init__(self, dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs()):
        super().__init__()
        self.dtype = dtype
        cb = lambda i, o, k: ConvBN(i, o, k, dtype=dtype, bn=bn)
        self.m7a_b0a = cb(1088, 256, 1)
        self.m7a_b0b = cb(256, 384, 3)
        self.m7a_b1a = cb(1088, 256, 1)
        self.m7a_b1b = cb(256, 288, 3)
        self.m7a_b2a = cb(1088, 256, 1)
        self.m7a_b2b = cb(256, 288, 3)
        self.m7a_b2c = cb(288, 320, 3)
        for i in range(9):
            self.add_module(f"block8_{i + 1}", Block8(2080, True, dtype, bn))
        self.block8_10 = Block8(2080, False, dtype, bn)
        self.conv7b = cb(2080, 1536, 1)

    def forward(self, x: Tensor) -> Tensor:
        x = _nchw(x.to(self.dtype))
        x = torch.cat([
            self.m7a_b0b(self.m7a_b0a(x)),
            self.m7a_b1b(self.m7a_b1a(x)),
            self.m7a_b2c(self.m7a_b2b(self.m7a_b2a(x))),
            max_pool_same(x, 1),
        ], dim=1)  # 2080
        for i in range(10):
            x = getattr(self, f"block8_{i + 1}")(x)
        return _nhwc(self.conv7b(x))

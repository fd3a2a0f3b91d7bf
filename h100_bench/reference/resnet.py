"""ResNet v1 with Faster R-CNN's two-part split and frozen batch norm, a
frozen copy of mtlx_torch/backbones/resnet.py's path for the frozen-batch-
norm trunks (no live batch norm, remat, space-to-depth stem or slim stride
order):

  * proposal features: conv1 (7x7/2) -> maxpool/2 -> block1 -> block2/2 ->
    block3/2 (stride 16, 1024 channels)
  * box classifier features: block4 at stride 1 on the pooled ROI crops
    (2048 channels)

NHWC in and out, NCHW inside; padding as flax's "SAME"; parameters
float32, cast to the compute type at use."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from .layers import Conv2d

BLOCK_SIZES = {10: (1, 1, 1, 1), 50: (3, 4, 6, 3), 101: (3, 4, 23, 3), 152: (3, 8, 36, 3)}
EPSILON = 1e-5  # slim resnet_arg_scope's
RGB_MEANS = (123.68, 116.779, 103.939)


def same_pad(x: Tensor, kernel: int, stride: int, dilation: int = 1,
             value: float = 0.0) -> Tensor:
    """Pad an NCHW tensor as flax / TF `padding="SAME"` does: total padding
    max((ceil(n / s) - 1) * s + k_eff - n, 0) per axis, the odd pixel
    after."""
    k_eff = (kernel - 1) * dilation + 1
    pads = []
    for n in (x.shape[2], x.shape[3]):
        total = max((-(-n // stride) - 1) * stride + k_eff - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    top, bottom, left, right = pads
    return F.pad(x, (left, right, top, bottom), value=value)


class FrozenBatchNorm(nn.Module):
    """gamma * (x - mean) / sqrt(var + eps) + beta with fixed statistics,
    folded in float32 into one multiply-add and cast back to x's type."""

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        inv = self.scale * torch.reciprocal(torch.sqrt(self.var + EPSILON))
        shift = self.bias - self.mean * inv
        y = x.float() * inv[:, None, None] + shift[:, None, None]
        return y.to(x.dtype)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 (stride) -> 1x1, post-activation; a 1x1 conv shortcut
    where the depth changes, a subsample where only the stride does."""

    def __init__(self, in_depth: int, depth: int, depth_bottleneck: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        self.stride = stride
        conv = lambda i, o, k, s: Conv2d(i, o, k, stride=s, bias=False, compute_dtype=dtype)
        self.conv1 = conv(in_depth, depth_bottleneck, 1, 1)
        self.bn1 = FrozenBatchNorm(depth_bottleneck)
        self.conv2 = conv(depth_bottleneck, depth_bottleneck, 3, stride)
        self.bn2 = FrozenBatchNorm(depth_bottleneck)
        self.conv3 = conv(depth_bottleneck, depth, 1, 1)
        self.bn3 = FrozenBatchNorm(depth)
        if in_depth != depth:
            self.conv_shortcut = conv(in_depth, depth, 1, stride)
            self.bn_shortcut = FrozenBatchNorm(depth)

    def forward(self, x: Tensor) -> Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        y = same_pad(y, 3, self.stride)
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if hasattr(self, "conv_shortcut"):
            residual = self.bn_shortcut(self.conv_shortcut(x))
        elif self.stride != 1:
            residual = x[:, :, :: self.stride, :: self.stride]
        else:
            residual = x
        return F.relu(residual + y)


class ResNetStage(nn.Sequential):
    """Bottleneck units `unit1..unitN`, the stride on the first."""

    def __init__(self, num_units: int, in_depth: int, depth: int, stride: int,
                 dtype: torch.dtype):
        super().__init__()
        for i in range(num_units):
            self.add_module(f"unit{i + 1}", Bottleneck(
                in_depth if i == 0 else depth, depth, depth // 4,
                stride if i == 0 else 1, dtype))


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


class ResNetProposalFeatures(nn.Module):
    """conv1 + block1..block3 -> the stride-16 map."""

    out_channels = 1024

    def __init__(self, depth: int, dtype: torch.dtype):
        super().__init__()
        sizes = BLOCK_SIZES[depth]
        self.dtype = dtype
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dtype)
        self.bn1 = FrozenBatchNorm(64)
        self.block1 = ResNetStage(sizes[0], 64, 256, 1, dtype)
        self.block2 = ResNetStage(sizes[1], 256, 512, 2, dtype)
        self.block3 = ResNetStage(sizes[2], 512, 1024, 2, dtype)

    def forward(self, images: Tensor) -> Tensor:
        x = _nchw(images.to(self.dtype))
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.max_pool2d(x, 3, 2, padding=1)  # symmetric, padded with -inf
        return _nhwc(self.block3(self.block2(self.block1(x))))


class ResNetBoxClassifierFeatures(nn.Module):
    """block4 at stride 1: [N, h, w, 1024] -> [N, h, w, 2048]."""

    out_channels = 2048

    def __init__(self, depth: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.block4 = ResNetStage(BLOCK_SIZES[depth][3], 1024, 2048, 1, dtype)

    def forward(self, x: Tensor) -> Tensor:
        return _nhwc(self.block4(_nchw(x.to(self.dtype))))


def preprocess_images(images: Tensor) -> Tensor:
    """Subtract the ImageNet channel means from 0-255 RGB."""
    return images - torch.tensor(RGB_MEANS, dtype=images.dtype, device=images.device)

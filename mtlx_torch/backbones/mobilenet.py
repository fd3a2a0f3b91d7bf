"""MobileNet v1 (port of mtlx/backbones/mobilenet.py): the depthwise-
separable stack with SSD's two endpoints, conv11 (stride 16) and conv13
(stride 32), ReLU6 after every batch norm.

The depthwise 3x3 convolutions are grouped convolutions with one group a
channel (flax's HWIO kernel [3, 3, 1, C] is the OIHW weight [C, 1, 3,
3]). A stride-2 SAME convolution pads as flax does, the odd pixel after
(`same_pad`), so 300 -> 150 -> 75 -> 38 -> 19 -> 10 as in mtlx. Batch
norm is frozen, or live with `bn.trainable` (feature_extractor
batch_norm train). NHWC in and out; names as in mtlx (`conv0`,
`conv{i}_dw`, `conv{i}_pw_bn`, ...).

`MobileNetV1Classifier` (classifier training) is not ported: ROADMAP.md
queue 1 item 19.
"""

from __future__ import annotations

from typing import List

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.inception_resnet_v2 import BNKnobs
from mtlx_torch.backbones.resnet import BNSpec, _nchw, _nhwc, make_norm, same_pad
from mtlx_torch.layers import Conv2d

# (stride, out_channels) per depthwise-separable block, after the conv0 stem
_MOBILENET_V1_DEFS = [
    (1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
    (2, 512), (1, 512), (1, 512), (1, 512), (1, 512), (1, 512),  # conv11
    (2, 1024), (1, 1024),  # conv13
]
_ENDPOINTS = (10, 12)  # conv11, conv13

# slim's mobilenet_v1 arg_scope batch norm: epsilon 1e-3, decay 0.9997
MOBILENET_BN = BNSpec(momentum=0.9997, epsilon=1e-3)


def _depth(channels: int, multiplier: float, min_depth: int) -> int:
    return max(int(channels * multiplier), min_depth)


class SameConv2d(Conv2d):
    """Conv2d with flax's `padding="SAME"`: symmetric (k - 1) / 2 at
    stride 1, explicit pads (the odd pixel after) when strided."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=0 if stride > 1 else (kernel - 1) // 2, groups=groups,
                         bias=bias, compute_dtype=compute_dtype)

    def forward(self, x: Tensor) -> Tensor:
        if self.stride[0] > 1:
            x = same_pad(x, self.kernel_size[0], self.stride[0])
        return super().forward(x)


class MobileNetV1(nn.Module):
    """[B, H, W, 3] -> [conv11 (stride 16), conv13 (stride 32)], NHWC."""

    def __init__(self, depth_multiplier: float = 1.0, min_depth: int = 8,
                 dtype: torch.dtype = torch.bfloat16, bn: BNKnobs = BNKnobs(spec=MOBILENET_BN)):
        super().__init__()
        self.dtype = dtype
        norm = lambda c: make_norm(c, bn.trainable, bn.spec)
        c = _depth(32, depth_multiplier, min_depth)
        self.conv0 = SameConv2d(3, c, 3, 2, bias=False, compute_dtype=dtype)
        self.conv0_bn = norm(c)
        for i, (stride, channels) in enumerate(_MOBILENET_V1_DEFS):
            out = _depth(channels, depth_multiplier, min_depth)
            self.add_module(f"conv{i + 1}_dw", SameConv2d(c, c, 3, stride, groups=c, bias=False,
                                                          compute_dtype=dtype))
            self.add_module(f"conv{i + 1}_dw_bn", norm(c))
            self.add_module(f"conv{i + 1}_pw", Conv2d(c, out, 1, bias=False,
                                                      compute_dtype=dtype))
            self.add_module(f"conv{i + 1}_pw_bn", norm(out))
            c = out
        self.out_channels = [_depth(_MOBILENET_V1_DEFS[i][1], depth_multiplier, min_depth)
                             for i in _ENDPOINTS]

    def forward(self, images: Tensor) -> List[Tensor]:
        x = _nchw(images.to(self.dtype))
        x = F.relu6(self.conv0_bn(self.conv0(x)))
        endpoints = []
        for i in range(len(_MOBILENET_V1_DEFS)):
            name = f"conv{i + 1}"
            x = F.relu6(getattr(self, f"{name}_dw_bn")(getattr(self, f"{name}_dw")(x)))
            x = F.relu6(getattr(self, f"{name}_pw_bn")(getattr(self, f"{name}_pw")(x)))
            if i in _ENDPOINTS:
                endpoints.append(_nhwc(x))
        return endpoints

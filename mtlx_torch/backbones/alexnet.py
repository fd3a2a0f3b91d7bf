"""AlexNet (port of mtlx/backbones/alexnet.py): five convolutions with
biases and ReLUs, bfloat16 compute by default, and the classifier's
three dense layers in float32.

NHWC in and out; inside, NCHW views of the same memory. Module names
repeat the flax names (`conv1`, `fc6`). conv1 is 11x11 / 4 VALID, the
others pad as flax's stride-1 SAME; the 3x3 / 2 max pools are flax's
default VALID ones. The classifier flattens the NHWC map in flax's (H,
W, C) order. Its two dropouts (rate 0.5) are off by default, as flax's
`deterministic=True`; with `deterministic=False` they take their draws
as tensors (`flax_dropout`: an element stays, doubled, where its uniform
is below 0.5). No detector builds this trunk; the classifier
pretraining path does.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.resnet import _nchw, _nhwc
from mtlx_torch.heads.box_predictors import flax_dropout
from mtlx_torch.layers import Conv2d, Linear

DROPOUT_KEEP_PROB = 0.5


class AlexNetFeatures(nn.Module):
    """[B, H, W, 3] -> the pool5 map [B, h, w, 256] (h = 5 at 224)."""

    out_channels = 256

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        conv = lambda i, o, k, **kw: Conv2d(i, o, k, compute_dtype=dtype, **kw)
        self.conv1 = conv(3, 64, 11, stride=4)
        self.conv2 = conv(64, 192, 5, padding=2)
        self.conv3 = conv(192, 384, 3, padding=1)
        self.conv4 = conv(384, 384, 3, padding=1)
        self.conv5 = conv(384, 256, 3, padding=1)

    def forward(self, images: Tensor) -> Tensor:
        x = _nchw(images.to(self.dtype))
        x = F.max_pool2d(F.relu(self.conv1(x)), 3, 2)
        x = F.max_pool2d(F.relu(self.conv2(x)), 3, 2)
        x = F.relu(self.conv5(F.relu(self.conv4(F.relu(self.conv3(x))))))
        return _nhwc(F.max_pool2d(x, 3, 2))


def _pooled_side(n: int) -> int:
    """The side of AlexNetFeatures' map for an n x n image."""
    n = (n - 11) // 4 + 1
    for _ in range(3):
        n = (n - 3) // 2 + 1
    return n


class AlexNetClassifier(nn.Module):
    """The features, then fc6 / fc7 (ReLU, dropout) / fc8 in float32."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224):
        super().__init__()
        self.features = AlexNetFeatures(dtype)
        side = _pooled_side(image_size)
        self.fc6 = Linear(side * side * 256, 4096)
        self.fc7 = Linear(4096, 4096)
        self.fc8 = Linear(4096, num_classes)

    @staticmethod
    def dropout_shapes(batch_size: int) -> Tuple[Tuple[int, int], ...]:
        """The shapes of the two dropouts' draws."""
        return ((batch_size, 4096), (batch_size, 4096))

    def forward(self, images: Tensor, deterministic: bool = True,
                dropout_uniforms: Optional[Sequence[Tensor]] = None) -> Tensor:
        """dropout_uniforms: the two dropouts' draws (`dropout_shapes`),
        needed when not deterministic."""
        x = self.features(images)
        x = x.reshape(x.shape[0], -1).float()
        drops = dropout_uniforms or (None, None)
        x = F.relu(self.fc6(x))
        if not deterministic:
            x = flax_dropout(x, drops[0], DROPOUT_KEEP_PROB)
        x = F.relu(self.fc7(x))
        if not deterministic:
            x = flax_dropout(x, drops[1], DROPOUT_KEEP_PROB)
        return self.fc8(x)

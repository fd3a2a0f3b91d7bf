"""VGG-16 (port of mtlx/backbones/vgg.py): conv1_1 .. conv5_3 with biases
and ReLUs, bfloat16 compute by default.

NHWC in and out; inside, NCHW views of the same memory. Module names
repeat the flax names (`conv3_2`, `fc6`). The 3x3 convolutions pad
(1, 1) as flax's stride-1 SAME; the 2x2 / 2 max pools are flax's
default VALID ones (an odd row or column is dropped). The classifier
flattens the NHWC map in flax's (H, W, C) order. No detector builds this
trunk; the classifier pretraining path does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.resnet import _nchw, _nhwc
from mtlx_torch.layers import Conv2d, Linear

_CFG16 = [(2, 64), (2, 128), (3, 256), (3, 512), (3, 512)]


class VGG16Features(nn.Module):
    """conv1_1 .. conv5_3, stride 16 at conv5 (the detector variant pools
    after blocks 1-4 only): [B, H, W, 3] -> the conv5_3 map [B, H / 16,
    W / 16, 512]."""

    out_channels = 512

    def __init__(self, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.blocks = []  # the conv names of each block
        c = 3
        for block, (reps, ch) in enumerate(_CFG16, start=1):
            names = []
            for unit in range(1, reps + 1):
                names.append(f"conv{block}_{unit}")
                self.add_module(names[-1], Conv2d(c, ch, 3, padding=1, compute_dtype=dtype))
                c = ch
            self.blocks.append(names)

    def forward(self, images: Tensor) -> Tensor:
        x = _nchw(images.to(self.dtype))
        for block, names in enumerate(self.blocks, start=1):
            for name in names:
                x = F.relu(getattr(self, name)(x))
            if block < 5:  # the detector variant keeps conv5 at stride 16
                x = F.max_pool2d(x, 2, 2)
        return _nhwc(x)


class VGG16Classifier(nn.Module):
    """The features, one more 2x2 pool, and fc6 / fc7 (ReLU) / fc8 in
    float32; the flattened map must be 7x7 (224x224 images) for fc6."""

    def __init__(self, num_classes: int = 1000, dtype: torch.dtype = torch.bfloat16,
                 image_size: int = 224):
        super().__init__()
        self.features = VGG16Features(dtype)
        side = image_size // 32
        self.fc6 = Linear(side * side * 512, 4096)
        self.fc7 = Linear(4096, 4096)
        self.fc8 = Linear(4096, num_classes)

    def forward(self, images: Tensor) -> Tensor:
        x = _nhwc(F.max_pool2d(_nchw(self.features(images)), 2, 2))
        x = x.reshape(x.shape[0], -1).float()
        return self.fc8(F.relu(self.fc7(F.relu(self.fc6(x)))))

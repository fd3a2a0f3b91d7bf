"""Faster R-CNN, R-FCN and SSD box predictor heads, and Mask R-CNN's mask
head (port of mtlx/heads/box_predictors.py).

The heads hold float32 parameters, compute in the module dtype (bfloat16
on the card) and emit float32 outputs, so the softmax and the decode run
in float32.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.backbones.mobilenet import SameConv2d
from mtlx_torch.backbones.resnet import same_pad
from mtlx_torch.layers import Conv2d, ConvTranspose2d, Linear
from mtlx_torch.ops import roi as roi_ops


def flax_dropout(x: Tensor, uniforms: Tensor, keep_prob: float) -> Tensor:
    """flax's training nn.Dropout(rate=1 - keep_prob) with its draws given:
    an element stays, divided by keep_prob in x's type, where its uniform
    is below keep_prob (jax.random.bernoulli's rule), and is 0 elsewhere;
    the identity at keep_prob 1 and zeros at keep_prob 0, as flax's edge
    cases. uniforms has x's shape."""
    if keep_prob == 1.0:
        return x
    if keep_prob == 0.0:
        return torch.zeros_like(x)
    if uniforms is None:
        raise ValueError("training with use_dropout needs the dropout draws")
    keep = uniforms < keep_prob
    return torch.where(keep, x / torch.tensor(keep_prob, dtype=x.dtype, device=x.device),
                       torch.zeros_like(x))


class RPNHead(nn.Module):
    """kxk conv trunk + 1x1 objectness/box heads over the stride-16 map.

    NHWC features [B, H, W, C] -> ([B, H*W*A, 2] objectness logits,
    [B, H*W*A, 4] box encodings) with the anchor index fastest, matching
    the GridAnchorGenerator layout."""

    def __init__(self, in_channels: int, num_anchors_per_location: int,
                 depth: int = 512, kernel_size: int = 3, atrous_rate: int = 1,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_anchors = num_anchors_per_location
        self.kernel_size = kernel_size
        self.atrous_rate = atrous_rate
        self.dtype = dtype
        a = num_anchors_per_location
        self.conv = Conv2d(in_channels, depth, kernel_size, dilation=atrous_rate,
                           compute_dtype=dtype)
        self.objectness = Conv2d(depth, 2 * a, 1, compute_dtype=dtype)
        self.box_encodings = Conv2d(depth, 4 * a, 1, compute_dtype=dtype)

    def forward(self, features: Tensor):
        b = features.shape[0]
        x = features.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv(same_pad(x, self.kernel_size, 1, self.atrous_rate)))
        # NCHW -> NHWC before flattening, so (y, x, anchor) order holds
        obj = self.objectness(x).permute(0, 2, 3, 1)
        box = self.box_encodings(x).permute(0, 2, 3, 1)
        return (
            obj.float().reshape(b, -1, 2),
            box.float().reshape(b, -1, 4),
        )


class MaskRCNNBoxPredictor(nn.Module):
    """FC heads on pooled ROI features: [N, D] -> ([N, num_classes + 1]
    class logits, [N, num_classes, 4] per-class box refinements). D is the
    box classifier's width, plus the aux heads' hidden widths on the MTL
    refine path. With use_dropout, training drops the input as flax's
    nn.Dropout does (`flax_dropout`)."""

    def __init__(self, in_features: int, num_classes: int,
                 dtype: torch.dtype = torch.bfloat16, use_dropout: bool = False,
                 dropout_keep_prob: float = 0.5):
        super().__init__()
        self.num_classes = num_classes
        self.in_features = in_features
        self.dtype = dtype
        self.use_dropout = use_dropout
        # flax's nn.Dropout(rate=1 - keep) keeps with probability 1 - rate
        self.dropout_keep_prob = 1.0 - (1.0 - dropout_keep_prob)
        self.class_logits = Linear(in_features, num_classes + 1, compute_dtype=dtype)
        self.box_refinement = Linear(in_features, num_classes * 4, compute_dtype=dtype)

    def forward(self, pooled: Tensor, dropout_uniforms: Tensor = None):
        """dropout_uniforms: [N, D] draws, needed in training with
        use_dropout."""
        x = pooled.to(self.dtype)
        if self.use_dropout and self.training:
            x = flax_dropout(x, dropout_uniforms, self.dropout_keep_prob)
        cls = self.class_logits(x)
        box = self.box_refinement(x)
        return (
            cls.float(),
            box.float().reshape(*pooled.shape[:-1], self.num_classes, 4),
        )


class MaskHead(nn.Module):
    """The instance-mask branch on the unpooled ROI features (mtlx's
    MaskHead, the reference MaskRCNNBoxPredictor's predict_instance_masks):
    a 3x3 conv + ReLU, a 2x2 stride-2 transpose conv + ReLU (the 2x
    upsample) and 1x1 per-class logits, in the compute type.

    NHWC [N, h, w, C] -> [N, 2h, 2w, num_classes] float32 mask logits.
    The transpose conv's weight is flax's kernel flipped in both spatial
    axes (bridge.py): flax's nn.ConvTranspose computes y[2i + a] =
    x[i] K[1 - a], PyTorch's y[2i + a] = x[i] W[a]."""

    def __init__(self, in_channels: int, num_classes: int, conv_depth: int = 256,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.dtype = dtype
        self.conv1 = Conv2d(in_channels, conv_depth, 3, padding=1, compute_dtype=dtype)
        self.upsample = ConvTranspose2d(conv_depth, conv_depth, 2, stride=2, compute_dtype=dtype)
        self.logits = Conv2d(conv_depth, num_classes, 1, compute_dtype=dtype)

    def forward(self, roi_features: Tensor) -> Tensor:
        x = roi_features.to(self.dtype).permute(0, 3, 1, 2)
        x = F.relu(self.conv1(x))
        x = F.relu(self.upsample(x))
        return self.logits(x).permute(0, 2, 3, 1).float()


class RfcnBoxPredictor(nn.Module):
    """R-FCN's position-sensitive score and box maps (mtlx.heads
    .box_predictors.RfcnBoxPredictor): a 1x1 `reduce` conv + ReLU, then
    1x1 `class_maps` (bins * (K + 1)) and `box_maps` (bins * K * 4) in
    the compute type, cast to float32 and cropped per proposal by the
    position-sensitive crop with the bins averaged.

    (NHWC features [B, H, W, C], canvas-normalized proposals [B, N, 4])
    -> (class logits [B, N, K + 1], box refinements [B, N, K, 4]),
    float32."""

    def __init__(self, in_channels: int, num_classes: int,
                 num_spatial_bins=(3, 3), depth: int = 1024, crop_size=(12, 12),
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        bins = num_spatial_bins[0] * num_spatial_bins[1]
        self.num_classes = num_classes
        self.num_spatial_bins = tuple(num_spatial_bins)
        self.crop_size = tuple(crop_size)
        self.dtype = dtype
        self.reduce = Conv2d(in_channels, depth, 1, compute_dtype=dtype)
        self.class_maps = Conv2d(depth, bins * (num_classes + 1), 1, compute_dtype=dtype)
        self.box_maps = Conv2d(depth, bins * num_classes * 4, 1, compute_dtype=dtype)

    def forward(self, features: Tensor, proposal_boxes: Tensor):
        b, n = proposal_boxes.shape[:2]
        x = F.relu(self.reduce(features.to(self.dtype).permute(0, 3, 1, 2)))
        crop = lambda maps: roi_ops.position_sensitive_crop_regions(
            maps.permute(0, 2, 3, 1).float(), proposal_boxes, self.crop_size,
            self.num_spatial_bins, global_pool=True)
        cls = crop(self.class_maps(x))
        box = crop(self.box_maps(x))
        return cls, box.reshape(b, n, self.num_classes, 4)


class ConvolutionalBoxPredictor(nn.Module):
    """SSD's head for one feature map (mtlx's ConvolutionalBoxPredictor):
    optional 1x1 ReLU convs at depth max(min(features' depth, max_depth),
    min_depth), then a kxk SAME class conv and box conv.

    NHWC features [B, H, W, C] -> ([B, H*W*A, num_classes + 1],
    [B, H*W*A, box_code_size]), float32. The NCHW outputs are permuted to
    NHWC before the reshape, so the anchors come in (y, x, anchor) order as
    the multi-grid anchors lay them out. With use_dropout, training drops
    the class branch's input as flax's nn.Dropout does: an element stays,
    divided by keep_prob, where its uniform draw is below keep_prob
    (jax.random.bernoulli's rule); outside training dropout is the
    identity."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors_per_location: int,
                 box_code_size: int = 4, kernel_size: int = 3, min_depth: int = 0,
                 max_depth: int = 0, num_layers_before_predictor: int = 0,
                 use_dropout: bool = False, dropout_keep_prob: float = 0.8,
                 apply_sigmoid_to_scores: bool = False, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.num_classes = num_classes
        self.box_code_size = box_code_size
        self.use_dropout = use_dropout
        # flax's nn.Dropout(rate=1 - keep) keeps with probability 1 - rate
        self.dropout_keep_prob = 1.0 - (1.0 - dropout_keep_prob)
        self.apply_sigmoid_to_scores = apply_sigmoid_to_scores
        self.dtype = dtype
        a = num_anchors_per_location
        depth = max(min(in_channels, max_depth), min_depth)
        self.hidden = []
        self.depth = c = in_channels
        if depth > 0 and num_layers_before_predictor > 0:
            for i in range(num_layers_before_predictor):
                name = f"conv_{i}_1x1_{depth}"
                self.add_module(name, Conv2d(c, depth, 1, compute_dtype=dtype))
                self.hidden.append(name)
                self.depth = c = depth
        self.class_predictor = SameConv2d(c, a * (num_classes + 1), kernel_size,
                                          compute_dtype=dtype)
        self.box_encoder = SameConv2d(c, a * box_code_size, kernel_size, compute_dtype=dtype)

    def forward(self, features: Tensor, dropout_uniforms: Tensor = None):
        """dropout_uniforms: [B, H, W, depth] draws, needed in training
        with use_dropout."""
        b = features.shape[0]
        x = features.to(self.dtype).permute(0, 3, 1, 2)
        for name in self.hidden:
            x = F.relu(getattr(self, name)(x))
        cls_in = x
        if self.use_dropout and self.training:
            cls_in = flax_dropout(
                x, None if dropout_uniforms is None else dropout_uniforms.permute(0, 3, 1, 2),
                self.dropout_keep_prob)
        cls = self.class_predictor(cls_in).permute(0, 2, 3, 1).float()
        cls = cls.reshape(b, -1, self.num_classes + 1)
        if self.apply_sigmoid_to_scores:
            cls = torch.sigmoid(cls)
        box = self.box_encoder(x).permute(0, 2, 3, 1).float()
        return cls, box.reshape(b, -1, self.box_code_size)

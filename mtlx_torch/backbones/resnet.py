"""ResNet v1 backbones with the Faster R-CNN two-part split (port of
mtlx/backbones/resnet.py).

  * proposal features: conv1 (7x7/2) -> maxpool/2 -> block1 -> block2/2 ->
    block3/2 (total stride 16, 1024 channels)
  * box classifier features: block4 at stride 1 on the 14x14 -> 7x7
    max-pooled ROI crops (2048 channels); the caller pools.

`ResNetClassifier` is the classification network the classifier
pretraining path trains: the proposal features, block4 at stride 2, a
spatial mean and the logits.

The public modules take and return NHWC tensors, as in `mtlx`; inside,
the convolutions run on NCHW views of the same memory (an NHWC tensor
permuted to NCHW is `channels_last`, the layout cuDNN prefers).
Submodule names repeat the flax names (`block1.unit1.conv1`, `bn1`), so
the weight bridge is a path-to-path map.

Parameters are float32 and cast to the compute type at use, as flax's
`param_dtype=float32` (mtlx_torch/layers.py).

Padding follows flax exactly: `padding="SAME"` on a strided conv pads
(0, 1) on even inputs and (1, 1) on odd ones, which a symmetric
`nn.Conv2d(padding=1)` cannot express, so `same_pad` pads explicitly
before a `padding=0` conv. Every padding goes through mtlx_torch/layers.py,
so a trunk runs on an H-slab of the image under a spatial context
(parallel/spatial.py) unchanged.

`remat` (the config's backbone_remat) recomputes each bottleneck in the
backward pass instead of keeping its activations, as mtlx's `nn.remat`
does: the same gradients and statistics with less activation memory.
`SpaceToDepthConv1` (conv0_space_to_depth) is the stem as a 4x4/1 conv
over a 2x2 space-to-depth input, owning the plain stem's weight.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn
from torch.utils.checkpoint import checkpoint

from mtlx_torch import layers
from mtlx_torch.layers import Conv2d, Linear

BLOCK_SIZES = {
    # depth 10 is a wiring-validation size (1 bottleneck per stage)
    10: (1, 1, 1, 1),
    50: (3, 4, 6, 3),
    101: (3, 4, 23, 3),
    152: (3, 8, 36, 3),
}


class BNSpec(NamedTuple):
    """Batch-norm hyperparameters (slim resnet_arg_scope defaults:
    decay 0.997, epsilon 1e-5, center + scale affine)."""

    momentum: float = 0.997
    epsilon: float = 1e-5
    center: bool = True
    scale: bool = True


def same_pad(x: Tensor, kernel: int, stride: int, dilation: int = 1,
             value: float = 0.0) -> Tensor:
    """Pad an NCHW tensor as flax/TF `padding="SAME"` does: total padding
    max((ceil(n / s) - 1) * s + k_eff - n, 0) per spatial axis, the odd
    pixel after."""
    k_eff = (kernel - 1) * dilation + 1
    pads = []
    for n in (x.shape[2], x.shape[3]):
        total = max((-(-n // stride) - 1) * stride + k_eff - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return layers.pad_hw(x, *pads, k_eff, stride, value)


class SpaceToDepthConv1(Conv2d):
    """The 7x7/2 stem conv (no bias) computed as a 4x4/1 VALID conv over
    the 2x2 space-to-depth of the input padded (4, 2), with the kernel
    padded in front to 8x8 and folded the same way (mtlx's
    SpaceToDepthConv1: equal to the plain stem but for the order of the
    sums). Its parameter is the plain stem's `weight` [64, 3, 7, 7], so
    checkpoints load into either form. An odd canvas takes the plain form,
    as in mtlx."""

    def __init__(self, features: int = 64, compute_dtype: torch.dtype = torch.bfloat16):
        super().__init__(3, features, 7, stride=2, padding=3, bias=False,
                         compute_dtype=compute_dtype)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        b, c, h, w = x.shape
        if h % 2 or w % 2:
            return super().forward(x)
        dt, f = self.compute_dtype, self.out_channels
        xq = layers.pad_hw(x.to(dt), 4, 2, 4, 2, 8, 2)
        hq, wq = xq.shape[2] // 2, xq.shape[3] // 2
        s = (xq.reshape(b, c, hq, 2, wq, 2).permute(0, 3, 5, 1, 2, 4)
             .reshape(b, 4 * c, hq, wq))  # channel (dy, dx, c), as mtlx's
        k8 = F.pad(self.weight, (1, 0, 1, 0))
        k12 = k8.reshape(f, c, 4, 2, 4, 2).permute(0, 3, 5, 1, 2, 4).reshape(f, 4 * c, 4, 4)
        return F.conv2d(s, k12.to(dt))


class FrozenBatchNorm(nn.Module):
    """y = gamma * (x - mean) / sqrt(var + eps) + beta with fixed moving
    statistics, folded in float32 into one multiply-add and cast back to
    the compute type (as mtlx's FrozenBatchNorm). gamma (`scale`) and
    beta (`bias`) are float32 parameters and train, as in flax's `params`;
    the statistics `mean` and `var` are buffers and never change. Absent
    center/scale parameters act as 0/1 and do not exist, as in flax."""

    def __init__(self, features: int, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True):
        super().__init__()
        self.epsilon = epsilon
        if scale:
            self.scale = nn.Parameter(torch.ones(features))
        if center:
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        gamma = self.scale if hasattr(self, "scale") else torch.ones_like(self.mean)
        beta = self.bias if hasattr(self, "bias") else torch.zeros_like(self.mean)
        inv = gamma * torch.reciprocal(torch.sqrt(self.var + self.epsilon))
        shift = beta - self.mean * inv
        y = x.float() * inv[:, None, None] + shift[:, None, None]
        return y.to(x.dtype)


def _paired_sums(a: Tensor, b: Tensor):
    """sum(a) and sum(a * b) per channel of NCHW tensors, accumulated in
    float32 (mtlx's `_paired_sums`; float64 tensors in float64)."""
    dt = torch.promote_types(a.dtype, torch.float32)
    af = a.to(dt)
    return af.sum((0, 2, 3)), (af * b.to(dt)).sum((0, 2, 3))


class _BatchNormTrain(torch.autograd.Function):
    """Train-mode batch norm as one folded affine with mtlx's hand-written
    backward (`_bn_train`, `_bn_train_fwd`, `_bn_train_bwd`).

    Forward: the statistics E[x] and E[x^2] - E[x]^2 (clamped at 0) in
    float32, inv = gamma * rsqrt(var + eps), y = x * inv + (beta - mean *
    inv) in the compute type. Backward: dx = dy * a_c + x * b_c + c_c with
    per-channel constants from the paired sums of dy and dy * x.

    With `replicas` the paired sums are summed over the ranks, in the
    forward and in the backward, so every rank normalizes by the
    statistics of the global batch, as mtlx's step on the global batch
    does. The gradients of gamma and beta come from this rank's sums: the
    train step averages them over the ranks with every other gradient."""

    @staticmethod
    def forward(ctx, x, gamma, beta, epsilon, replicas):
        n = x.numel() // x.shape[1]
        s1, s2 = _paired_sums(x, x)
        if replicas is not None:
            s1, s2 = replicas.sums([s1, s2])
            n *= replicas.world_size
        mean = s1 / n
        var = torch.clamp_min(s2 / n - mean * mean, 0.0)
        inv = gamma * torch.rsqrt(var + epsilon)
        dt = x.dtype
        y = x * inv.to(dt)[:, None, None] + (beta - mean * inv).to(dt)[:, None, None]
        ctx.save_for_backward(x, gamma, mean, var, inv)
        ctx.epsilon, ctx.n, ctx.replicas = epsilon, n, replicas
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, gamma, mean, var, inv = ctx.saved_tensors
        gmean = torch.zeros_like(mean) if gmean is None else gmean
        gvar = torch.zeros_like(var) if gvar is None else gvar
        s1, sx = _paired_sums(gy, x)
        rsig = torch.rsqrt(var + ctx.epsilon)  # inv / gamma, but gamma may be 0
        dgamma = rsig * (sx - mean * s1)
        dbeta = s1
        if ctx.replicas is not None:
            s1, sx = ctx.replicas.sums([s1, sx])
        stot = sx - mean * s1
        gv = gvar - 0.5 * rsig * rsig * rsig * gamma * stot
        gmu = gmean - inv * s1 - 2.0 * mean * gv
        dt, n = x.dtype, ctx.n
        a_c = inv.to(dt)[:, None, None]
        b_c = (2.0 * gv / n).to(dt)[:, None, None]
        c_c = (gmu / n).to(dt)[:, None, None]
        dx = gy.to(dt) * a_c + x * b_c + c_c
        return dx, dgamma, dbeta, None, None


# set while a rematerialized unit recomputes its forward in the backward
# pass: its live batch norms keep the first forward's statistics
_recomputing = False


@contextlib.contextmanager
def _recompute(halo):
    global _recomputing
    before = _recomputing, layers._halo
    _recomputing, layers._halo = True, halo
    try:
        yield
    finally:
        _recomputing, layers._halo = before


def rematerialized(module: nn.Module, x: Tensor) -> Tensor:
    """module(x) with its activations recomputed in the backward pass
    (mtlx's `nn.remat`): autograd keeps only x. With grad off it is the
    plain call. The recomputation runs under the forward's spatial context
    (its halo exchanges) and does not record live batch norm statistics
    again, so the step commits them once, as flax's functional remat
    updates them once."""
    if not torch.is_grad_enabled():
        return module(x)
    calls, halo = [], layers._halo

    def run(t: Tensor) -> Tensor:
        calls.append(None)
        if len(calls) == 1:
            return module(t)
        with _recompute(halo):
            return module(t)

    return checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)


class LiveBatchNorm(nn.Module):
    """Trainable batch norm (port of mtlx's LiveBatchNorm): the folded
    affine in the compute type, with batch statistics in training and the
    moving statistics in eval.

    In training (`self.training`) the forward normalizes by the batch's
    statistics through `_BatchNormTrain` and keeps them in `batch_stats`;
    the train step folds them into the moving statistics after the update
    (`commit_batch_stats`: ra = momentum * ra + (1 - momentum) * stat,
    with the biased variance), as mtlx's step writes its
    `updated_batch_stats`. An eval forward reads the moving statistics and
    changes nothing. The names `scale`, `bias`, `mean` and `var` are
    FrozenBatchNorm's, so a checkpoint moves between the two modes.
    `replicas` (set by the data-parallel train step) makes the statistics
    those of the global batch."""

    def __init__(self, features: int, momentum: float = 0.99, epsilon: float = 1e-5,
                 center: bool = True, scale: bool = True):
        super().__init__()
        self.momentum = momentum
        self.epsilon = epsilon
        if scale:
            self.scale = nn.Parameter(torch.ones(features))
        if center:
            self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))
        self.batch_stats = None
        self.replicas = None

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        gamma = self.scale if hasattr(self, "scale") else torch.ones_like(self.mean)
        beta = self.bias if hasattr(self, "bias") else torch.zeros_like(self.mean)
        if not self.training:
            inv = gamma * torch.rsqrt(self.var + self.epsilon)
            shift = beta - self.mean * inv
            dt = x.dtype
            return x * inv.to(dt)[:, None, None] + shift.to(dt)[:, None, None]
        y, mean, var = _BatchNormTrain.apply(x, gamma, beta, self.epsilon, self.replicas)
        if not _recomputing:
            self.batch_stats = (mean.detach(), var.detach())
        return y

    @torch.no_grad()
    def commit(self) -> None:
        """Fold the last training forward's statistics into the moving ones."""
        if self.batch_stats is None:
            return
        mean, var = self.batch_stats
        m = self.momentum
        self.mean.copy_(m * self.mean + (1.0 - m) * mean)
        self.var.copy_(m * self.var + (1.0 - m) * var)
        self.batch_stats = None


def live_batch_norms(module: nn.Module):
    """Every LiveBatchNorm under `module`."""
    return [m for m in module.modules() if isinstance(m, LiveBatchNorm)]


def make_norm(features: int, trainable: bool, bn: BNSpec = BNSpec()) -> nn.Module:
    """Frozen batch norm, or with `trainable` (batch_norm_trainable) the
    live one, which trains on batch statistics."""
    if trainable:
        return LiveBatchNorm(features, bn.momentum, bn.epsilon, bn.center, bn.scale)
    return FrozenBatchNorm(features, bn.epsilon, bn.center, bn.scale)


class Bottleneck(nn.Module):
    """ResNet v1 bottleneck: 1x1 -> 3x3(stride) -> 1x1, post-activation.
    slim_padding pads the strided 3x3 symmetrically (slim conv2d_same)
    instead of SAME. Shortcut: 1x1 conv when the depth changes, a
    parameterless subsample when only the stride does."""

    def __init__(self, in_depth: int, depth: int, depth_bottleneck: int,
                 stride: int = 1, dtype: torch.dtype = torch.bfloat16,
                 bn_trainable: bool = False, slim_padding: bool = False,
                 bn: BNSpec = BNSpec()):
        super().__init__()
        self.stride = stride
        self.slim_padding = slim_padding
        conv = lambda i, o, k, s: Conv2d(i, o, k, stride=s, bias=False, compute_dtype=dtype)
        self.conv1 = conv(in_depth, depth_bottleneck, 1, 1)
        self.bn1 = make_norm(depth_bottleneck, bn_trainable, bn)
        self.conv2 = conv(depth_bottleneck, depth_bottleneck, 3, stride)
        self.bn2 = make_norm(depth_bottleneck, bn_trainable, bn)
        self.conv3 = conv(depth_bottleneck, depth, 1, 1)
        self.bn3 = make_norm(depth, bn_trainable, bn)
        if in_depth != depth:
            # a 1x1 SAME conv pads nothing at any stride
            self.conv_shortcut = conv(in_depth, depth, 1, stride)
            self.bn_shortcut = make_norm(depth, bn_trainable, bn)

    def forward(self, x: Tensor) -> Tensor:  # NCHW
        y = F.relu(self.bn1(self.conv1(x)))
        if self.stride > 1 and self.slim_padding:
            y = layers.pad_hw(y, 1, 1, 1, 1, 3, self.stride)
        else:
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
    """A stack of bottleneck units `unit1..unitN`. The stride goes on the
    FIRST unit, or on the LAST with slim_stride_order (slim resnet_v1).
    With `remat` each unit is recomputed in the backward pass."""

    def __init__(self, num_units: int, in_depth: int, depth: int, stride: int,
                 dtype: torch.dtype = torch.bfloat16, bn_trainable: bool = False,
                 slim_stride_order: bool = False, bn: BNSpec = BNSpec(),
                 remat: bool = False):
        super().__init__()
        self.remat = remat
        stride_unit = num_units - 1 if slim_stride_order else 0
        for i in range(num_units):
            self.add_module(f"unit{i + 1}", Bottleneck(
                in_depth if i == 0 else depth, depth, depth // 4,
                stride=stride if i == stride_unit else 1, dtype=dtype,
                bn_trainable=bn_trainable, slim_padding=slim_stride_order, bn=bn,
            ))

    def forward(self, x: Tensor) -> Tensor:
        for unit in self:
            x = rematerialized(unit, x) if self.remat else unit(x)
        return x


def _nchw(x: Tensor) -> Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: Tensor) -> Tensor:
    return x.permute(0, 2, 3, 1)


class ResNetProposalFeatures(nn.Module):
    """conv1 + block1..block3 -> the stride-16 map. NHWC in, NHWC out."""

    out_channels = 1024

    def __init__(self, depth: int = 50, dtype: torch.dtype = torch.bfloat16,
                 bn_trainable: bool = False, slim_stride_order: bool = False,
                 conv0_space_to_depth: bool = False, bn: BNSpec = BNSpec(),
                 remat: bool = False):
        super().__init__()
        sizes = BLOCK_SIZES[depth]
        self.dtype = dtype
        self.slim_stride_order = so = slim_stride_order
        if conv0_space_to_depth:
            self.conv1 = SpaceToDepthConv1(64, compute_dtype=dtype)
        else:
            self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False, compute_dtype=dtype)
        self.bn1 = make_norm(64, bn_trainable, bn)
        strides = (2, 2, 1) if so else (1, 2, 2)
        stage = lambda i, cin, cout: ResNetStage(sizes[i], cin, cout, strides[i], dtype,
                                                 bn_trainable, so, bn, remat)
        self.block1 = stage(0, 64, 256)
        self.block2 = stage(1, 256, 512)
        self.block3 = stage(2, 512, 1024)

    def forward(self, images: Tensor) -> Tensor:
        x = _nchw(images.to(self.dtype))
        x = F.relu(self.bn1(self.conv1(x)))
        if self.slim_stride_order:  # slim pools with SAME padding
            x = F.max_pool2d(same_pad(x, 3, 2, value=float("-inf")), 3, 2)
        else:  # symmetric (1, 1), padded with -inf
            x = layers.max_pool2d(x, 3, 2, padding=1)
        x = self.block3(self.block2(self.block1(x)))
        return _nhwc(x)


class ResNetBoxClassifierFeatures(nn.Module):
    """block4 at stride 1 on ROI crops: [N, h, w, 1024] -> [N, h, w, 2048]."""

    out_channels = 2048

    def __init__(self, depth: int = 50, dtype: torch.dtype = torch.bfloat16,
                 bn_trainable: bool = False, slim_stride_order: bool = False,
                 bn: BNSpec = BNSpec(), remat: bool = False):
        super().__init__()
        self.dtype = dtype
        self.block4 = ResNetStage(BLOCK_SIZES[depth][3], 1024, 2048, 1, dtype,
                                  bn_trainable, slim_stride_order, bn, remat)

    def forward(self, x: Tensor) -> Tensor:
        return _nhwc(self.block4(_nchw(x.to(self.dtype))))


class ResNetClassifier(nn.Module):
    """The classification network (slim's train path that makes the
    ImageNet warm starts): `body` (conv1 .. block3), `block4` at stride
    2, a spatial mean and float32 `logits`. It trains with live batch
    norm by default, as slim's classification does; the moving
    statistics it learns are what a detector's frozen batch norm reads
    after a warm start (train/train_classifier.py --export_backbone)."""

    def __init__(self, depth: int = 50, num_classes: int = 1000, bn_trainable: bool = True,
                 dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.body = ResNetProposalFeatures(depth, dtype, bn_trainable=bn_trainable)
        self.block4 = ResNetStage(BLOCK_SIZES[depth][3], 1024, 2048, 2, dtype, bn_trainable)
        self.logits = Linear(2048, num_classes)

    def forward(self, images: Tensor) -> Tensor:
        x = self.block4(_nchw(self.body(images)))
        return self.logits(x.mean(dim=(2, 3)).float())


# Canonical per-channel means the reference subtracts in preprocess
# (R, G, B order, 0-255 scale).
RGB_MEANS = (123.68, 116.779, 103.939)


def preprocess_images(images: Tensor) -> Tensor:
    """Subtract the ImageNet channel means. Input [..., H, W, 3] in 0-255
    RGB float."""
    return images - torch.tensor(RGB_MEANS, dtype=images.dtype, device=images.device)

"""Layers that keep float32 parameters and compute in another type, as
flax's `nn.Conv` / `nn.ConvTranspose` / `nn.Dense` do with `param_dtype=float32` and a
`dtype`: the weight and bias are cast to the compute type at each call
(a differentiable cast, so the float32 parameters train). SGD at the
flagship's learning rate would lose most updates on bfloat16-stored
weights.

`LayerNorm` is flax's: epsilon 1e-6, the variance as
`mean(x^2) - mean(x)^2` (clipped at 0), `(x - mean) * (rsqrt(var + eps)
* scale) + bias`, with parameters named `scale` and `bias`.

Every padding of a trunk goes through `pad_hw`, `max_pool2d`,
`avg_pool2d` or `Conv2d`'s own padding. Inside a spatial context
(parallel/spatial.py `slab_context`) the tensor is one H-slab of the
image, and these take the rows a window reads beyond the slab from the
neighbouring slabs (a halo exchange); only the image's own top and
bottom are padded. Outside one they pad as PyTorch does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn


# the H-axis halo exchange of a spatial context: halo(x, top, bottom,
# kernel, stride, value) -> x with the rows its windows read above and
# below the slab; None outside a spatial context
_halo = None


def pad_hw(x: Tensor, top: int, bottom: int, left: int, right: int, kernel: int,
           stride: int, value: float = 0.0) -> Tensor:
    """Pad an NCHW tensor by (top, bottom) rows and (left, right) columns
    with `value`, for windows of `kernel` rows (dilated) at `stride`.
    Inside a spatial context the rows come from the neighbouring slabs
    where the slab has neighbours."""
    if _halo is not None:
        x = _halo(x, top, bottom, kernel, stride, value)
        top = bottom = 0
    if top or bottom or left or right:
        x = F.pad(x, (left, right, top, bottom), value=value)
    return x


def max_pool2d(x: Tensor, kernel: int, stride: int, padding: int = 0) -> Tensor:
    """F.max_pool2d with symmetric `padding` (-inf), through the halo."""
    if _halo is None or not padding:
        return F.max_pool2d(x, kernel, stride, padding=padding)
    x = pad_hw(x, padding, padding, padding, padding, kernel, stride, float("-inf"))
    return F.max_pool2d(x, kernel, stride)


def avg_pool2d(x: Tensor, kernel: int, stride: int, padding: int = 0) -> Tensor:
    """F.avg_pool2d with symmetric zero `padding` counted in the mean
    (count_include_pad), through the halo."""
    if _halo is None or not padding:
        return F.avg_pool2d(x, kernel, stride, padding=padding, count_include_pad=True)
    return F.avg_pool2d(pad_hw(x, padding, padding, padding, padding, kernel, stride),
                        kernel, stride)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with float32 parameters, computing in `compute_dtype`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=torch.float32, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        if _halo is not None and self.padding[0]:
            (ph, pw), (k, _), (d, _) = self.padding, self.kernel_size, self.dilation
            x = pad_hw(x.to(dt), ph, ph, pw, pw, (k - 1) * d + 1, self.stride[0])
            return F.conv2d(x, self.weight.to(dt), bias, self.stride, 0, self.dilation,
                            self.groups)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    """nn.ConvTranspose2d with float32 parameters, computing in
    `compute_dtype`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=torch.float32, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride,
                                  self.padding, self.output_padding, self.groups,
                                  self.dilation)


class Linear(nn.Linear):
    """nn.Linear with float32 parameters, computing in `compute_dtype`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=torch.float32, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.Module):
    """flax.linen.LayerNorm over the last axis, in float32."""

    EPSILON = 1e-6  # flax's default

    def __init__(self, features: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: Tensor) -> Tensor:
        x = x.float()
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.EPSILON) * self.scale
        return (x - mean) * mul + self.bias

"""Layers that keep float32 parameters and compute in another type, as
flax's `nn.Conv` / `nn.ConvTranspose` / `nn.Dense` do with `param_dtype=float32` and a
`dtype`: the weight and bias are cast to the compute type at each call
(a differentiable cast, so the float32 parameters train). SGD at the
flagship's learning rate would lose most updates on bfloat16-stored
weights.

`LayerNorm` is flax's: epsilon 1e-6, the variance as
`mean(x^2) - mean(x)^2` (clipped at 0), `(x - mean) * (rsqrt(var + eps)
* scale) + bias`, with parameters named `scale` and `bias`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn


class Conv2d(nn.Conv2d):
    """nn.Conv2d with float32 parameters, computing in `compute_dtype`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=torch.float32, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
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

"""Convolution and dense layers with float32 parameters that compute in
`compute_dtype`, and flax's LayerNorm (a frozen copy of
mtlx_torch/layers.py without the spatial halo).

A layer's `quantize`, None unless `set_quantize` gives one, rounds its
input and weight before the product: the lower precision that the
comparison's control runs in (`control.py`)."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor, nn

def set_quantize(net: nn.Module, quantize) -> None:
    """Every convolution and dense layer of `net` rounds its operands with
    `quantize` (None: not at all)."""
    for m in net.modules():
        if isinstance(m, (Conv2d, Linear)):
            m.quantize = quantize


def _q(layer, t: Tensor) -> Tensor:
    return t if layer.quantize is None else layer.quantize(t)


class Conv2d(nn.Conv2d):
    """nn.Conv2d with float32 parameters, computing in `compute_dtype`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=torch.float32, **kwargs)
        self.compute_dtype = compute_dtype
        self.quantize = None

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(_q(self, x.to(dt)), _q(self, self.weight.to(dt)), bias)


class Linear(nn.Linear):
    """nn.Linear with float32 parameters, computing in `compute_dtype`."""

    def __init__(self, *args, compute_dtype: torch.dtype = torch.float32, **kwargs):
        super().__init__(*args, dtype=torch.float32, **kwargs)
        self.compute_dtype = compute_dtype
        self.quantize = None

    def forward(self, x: Tensor) -> Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(_q(self, x.to(dt)), _q(self, self.weight.to(dt)), bias)


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

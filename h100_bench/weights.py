"""Seeded random weights, made on the device in two large draws and split
into the parameters by name (sorted), so that the program and the
reference load the same tensors. Initializers as the port's
`init_weights` states them (the distributions, not the numbers): the RPN's
convolutions truncated normal 0.01, the box predictor variance-scaling
uniform over the average fan, every other convolution and dense layer
lecun normal truncated at two deviations, biases 0, scales 1, but the
scale of each bottleneck's last batch norm (`bn3`), which starts at
RESIDUAL_SCALE: each residual branch starts small beside its shortcut, as
trained ResNets have them (Goyal et al.'s practice of a small or zero
last gamma). With every branch at the shortcut's size the calibrated
random trunk amplifies a perturbation about 1.25 times a unit, and
bfloat16's rounding alone moves the RPN's outputs by 30% of their largest
magnitude in ResNet-50 (14% in ResNet-101 at 0.3); at 0.1, by about 2%
in both."""

from __future__ import annotations

from typing import Dict, Tuple

import torch


RESIDUAL_SCALE = 0.1


def _rule(name: str, shape: Tuple[int, ...]):
    """('zeros' | 'fill' | 'normal' | 'uniform', value or scale) of a
    parameter."""
    if name.endswith(".bias"):
        return "zeros", 0.0
    if name.endswith(".bn3.scale"):
        return "fill", RESIDUAL_SCALE
    if name.endswith(".scale"):
        return "fill", 1.0
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    fan_in, fan_out = shape[1] * receptive, shape[0] * receptive
    if name.startswith("rpn."):
        return "normal", 0.01
    if name.startswith("box_predictor."):
        return "uniform", (3.0 / ((fan_in + fan_out) / 2)) ** 0.5
    # lecun normal: variance 1 / fan_in after truncation at 2 deviations
    return "normal", (1.0 / fan_in) ** 0.5 / 0.87962566103423978


def make_weights(shapes: Dict[str, Tuple[int, ...]], seed: int, device) -> Dict[str, torch.Tensor]:
    """{name: float32 tensor} for every parameter in `shapes`."""
    names = sorted(shapes)
    rules = {n: _rule(n, tuple(shapes[n])) for n in names}
    numel = {n: int(torch.Size(shapes[n]).numel()) for n in names}
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    normal = [n for n in names if rules[n][0] == "normal"]
    uniform = [n for n in names if rules[n][0] == "uniform"]
    z = torch.randn(sum(numel[n] for n in normal), generator=gen, device=device).clamp_(-2, 2)
    u = torch.rand(sum(numel[n] for n in uniform), generator=gen, device=device).mul_(2).sub_(1)
    out = {}
    for pool, group in ((z, normal), (u, uniform)):
        offset = 0
        for n in group:
            out[n] = pool[offset: offset + numel[n]].view(shapes[n]).mul(rules[n][1])
            offset += numel[n]
    for n in names:
        kind, value = rules[n]
        if kind in ("zeros", "fill"):
            out[n] = torch.full(tuple(shapes[n]), float(value), device=device)
    return out

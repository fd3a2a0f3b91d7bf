"""Balanced minibatch sampling with static shapes (port of
mtlx/assign/samplers.py).

mtlx draws `jax.random.uniform` scores inside each sampler; the port
takes the uniform draws as tensors (`uniforms`), so a test can inject
JAX's own draws and the train step makes them from one explicit
`torch.Generator`. Given the same draws the samples are exactly mtlx's:
both argsorts are stable.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import Tensor


def random_rank(mask: Tensor, uniforms: Tensor) -> Tensor:
    """Rank of each entry in a random order of the mask=True entries,
    which come first (invalid entries get the large ranks). [..., N]."""
    scores = torch.where(mask, uniforms, -1.0)
    order = torch.argsort(-scores, dim=-1, stable=True)
    ranks = torch.arange(mask.shape[-1], device=mask.device).expand_as(order)
    return torch.empty_like(order).scatter_(-1, order, ranks)


def subsample_mask(mask: Tensor, k, uniforms: Tensor) -> Tensor:
    """Keep min(k, sum(mask)) random True entries; k may be a tensor
    [..., 1]."""
    return mask & (random_rank(mask, uniforms) < k)


def balanced_subsample(
    indicator: Tensor,
    labels: Tensor,
    batch_size: int,
    positive_fraction: float = 0.5,
    uniforms: Tuple[Tensor, Tensor] = None,
) -> Tensor:
    """[..., N] bool sample mask with at most batch_size entries, at most
    int(positive_fraction * batch_size) of them positive, negatives
    filling the rest. uniforms = (u_pos, u_neg), each [..., N] in [0, 1):
    the draws of mtlx's split (pos, neg) keys."""
    u_pos, u_neg = uniforms
    pos_mask = indicator & labels
    neg_mask = indicator & ~labels
    max_pos = int(positive_fraction * batch_size)
    num_pos = torch.clamp_max(pos_mask.sum(-1, keepdim=True), max_pos)
    sampled_pos = subsample_mask(pos_mask, num_pos, u_pos)
    num_neg = batch_size - sampled_pos.sum(-1, keepdim=True)
    sampled_neg = subsample_mask(neg_mask, num_neg, u_neg)
    return sampled_pos | sampled_neg

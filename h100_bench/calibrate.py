"""Frozen batch norm calibrated on a batch: random weights need it, or
the activations of a deep trunk grow or vanish. Every module named
`FrozenBatchNorm` takes the mean and the biased variance of its input over
the batch and the positions, in float32; the trunk on the images, then the
box classifier's block on a 7x7 average pool of each image's stride-16
map. The program and the reference are calibrated alike, each from its
own activations."""

from __future__ import annotations

import torch
import torch.nn.functional as F


@torch.no_grad()
def calibrate(backbone, classifier_backbone, preprocess, images: torch.Tensor) -> None:
    def hook(mod, args):
        x = args[0].float()
        mod.mean.copy_(x.mean(dim=(0, 2, 3)))
        mod.var.copy_(x.var(dim=(0, 2, 3), unbiased=False))

    handles = [m.register_forward_pre_hook(hook)
               for net in (backbone, classifier_backbone) for m in net.modules()
               if type(m).__name__ == "FrozenBatchNorm"]
    try:
        feats = backbone(preprocess(images.float()))
        pooled = F.adaptive_avg_pool2d(feats.permute(0, 3, 1, 2).float(), 7)
        classifier_backbone(pooled.permute(0, 2, 3, 1).contiguous())
    finally:
        for h in handles:
            h.remove()

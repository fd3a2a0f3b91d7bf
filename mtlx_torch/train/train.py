"""The training step as the training CLI composes it (port of the augment
wrapper and the step wrapper of mtlx/train/train.py): bucket padding,
device-side augmentation, then the raw train step.

The CLI itself (`--pipeline_config_path`, `--train_dir`), the loader and
checkpoints are not ported yet: ROADMAP.md queue 1 #14-15.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import torch
from torch import Tensor

from mtlx_torch.data import preprocessor as prep
from mtlx_torch.detector.faster_rcnn import FasterRCNN
from mtlx_torch.train import train_step as ts


def make_augmented_batch_fn(aug_options: List[Tuple[str, dict]]) -> Callable:
    """Returns augment(batch, draws) -> batch with the options applied;
    draws[name] holds each option's per-image uniforms."""

    def augment(batch: Dict[str, Tensor], draws: Dict[str, Tensor]) -> Dict[str, Tensor]:
        if not aug_options:
            return batch
        sample = {
            "image": batch["image"].float(),
            "boxes": batch["gt_boxes"],
            "classes": batch["gt_classes"],
            "mask": batch["gt_mask"],
            "true_shape": batch["true_shape"],
        }
        out = prep.batch_preprocess(sample, aug_options, draws)
        return dict(batch, image=out["image"], gt_boxes=out["boxes"], gt_mask=out["mask"],
                    true_shape=out["true_shape"])

    return augment


def make_step_fn(model: FasterRCNN, aug_options: List[Tuple[str, dict]],
                 regularization_fn: Optional[Callable] = None) -> Callable:
    """Returns step_fn(state, batch, generator=None, draws=None) ->
    (state, metrics): pad the batch to its bucket, augment it, take one
    train step. Draws not given come from `generator`, in the order of
    train_step.make_draws (the augmentations' first)."""
    augment = make_augmented_batch_fn(aug_options)
    raw_step = ts.make_train_step(model, regularization_fn)

    def step_fn(state, batch, generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Tensor]] = None):
        batch = ts.pad_for_model(model, batch)
        draws = dict(draws or {})
        if generator is not None:
            img = batch["image"]
            made = ts.make_draws(model, img.shape[0], tuple(img.shape[1:3]), generator,
                                 aug_options, num_gt=batch["gt_boxes"].shape[1])
            draws = {**made, **draws}
        return raw_step(state, augment(batch, draws), draws=draws)

    return step_fn

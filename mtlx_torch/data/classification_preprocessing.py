"""Classification preprocessing (port of
mtlx/data/classification_preprocessing.py; slim's vgg_preprocessing and
inception_preprocessing): a random resized crop, a flip and, for
Inception, a brightness jitter in training, a central crop in eval.

The port takes a batch [B, H, W, 3] (0-255 floats) and its random draws
as tensors, one uniform in [0, 1) per image under each key of
DRAW_KEYS (`make_draws`), which is the port's rule for random draws
(train/train_step.py `make_draws`). Each draw is used as mtlx uses the
jax.random draw of the same name: `jax.random.uniform(key, minval=a,
maxval=b)` is max(a, u * (b - a) + a) in float32 and
`jax.random.bernoulli(key, 0.5)` is u < 0.5, so a test that injects
JAX's uniforms gets mtlx's crops.

Every crop of a batch (one box an image) goes through
`ops/roi.py batch_crop_and_resize`: one launch of the crop kernel a
batch on the card, its plain version on the CPU. mtlx crops with the
two-matmul `crop_and_resize_mxu`, so the two agree to float32 rounding,
not to the bit. Nothing in mtlx calls this module, and nothing in the
port's CLIs calls it either.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import Tensor

from mtlx_torch.backbones.resnet import preprocess_images
from mtlx_torch.ops import roi as roi_ops

DRAW_KEYS = ("area", "aspect", "y", "x", "flip", "brightness")
CENTRAL_FRACTION = 0.875


def make_draws(batch_size: int, generator: torch.Generator) -> Dict[str, Tensor]:
    """One uniform [B] a key of DRAW_KEYS, in that order, from `generator`
    on its own device."""
    return {k: torch.rand(batch_size, generator=generator, device=generator.device)
            for k in DRAW_KEYS}


def _f32(v: float, like: Tensor) -> Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _uniform(u: Tensor, lo: float, hi: float) -> Tensor:
    """jax.random.uniform(minval=lo, maxval=hi) from its [0, 1) draw."""
    lo_t, hi_t = _f32(lo, u), _f32(hi, u)
    return torch.maximum(lo_t, u * (hi_t - lo_t) + lo_t)


def random_crop_boxes(draws: Dict[str, Tensor], h: int, w: int, min_area: float = 0.08,
                      max_area: float = 1.0, min_aspect: float = 0.75,
                      max_aspect: float = 1.333) -> Tensor:
    """The Inception-style random resized crop's normalized box of each
    image, [B, 4], as mtlx's `_random_crop_resize` draws it: an area
    fraction and an aspect ratio, the crop's sides (each capped at the
    image's), then its corner."""
    area = _uniform(draws["area"], min_area, max_area)
    aspect = _uniform(draws["aspect"], min_aspect, max_aspect)
    hf, wf = _f32(h, area), _f32(w, area)
    ch = torch.sqrt(area * hf * wf / aspect)
    cw = ch * aspect
    ch = torch.minimum(ch, hf)
    cw = torch.minimum(cw, wf)
    y0 = draws["y"] * (hf - ch)
    x0 = draws["x"] * (wf - cw)
    return torch.stack([y0 / hf, x0 / wf, (y0 + ch) / hf, (x0 + cw) / wf], dim=-1)


def _crop(images: Tensor, boxes: Tensor, out_size: Tuple[int, int]) -> Tensor:
    """[B, H, W, 3] x [B, 4] -> [B, oh, ow, 3]: one crop launch."""
    crops = roi_ops.batch_crop_and_resize(images.contiguous(), boxes[:, None].contiguous(),
                                          tuple(out_size))
    return crops[:, 0]


def _central_crop(images: Tensor, out_size: Tuple[int, int]) -> Tensor:
    lo = (1.0 - CENTRAL_FRACTION) / 2.0
    box = torch.tensor([lo, lo, 1.0 - lo, 1.0 - lo], dtype=torch.float32, device=images.device)
    return _crop(images, box.expand(images.shape[0], 4), out_size)


def _flip(images: Tensor, u: Tensor) -> Tensor:
    """Each image mirrored left to right where its draw is below 0.5."""
    return torch.where((u < 0.5)[:, None, None, None], images.flip(2), images)


def _check_draws(draws: Optional[Dict[str, Tensor]], keys) -> Dict[str, Tensor]:
    missing = [k for k in keys if draws is None or k not in draws]
    if missing:
        raise ValueError(f"training preprocessing needs the draws {missing} (make_draws)")
    return draws


def vgg_preprocess(images: Tensor, draws: Optional[Dict[str, Tensor]] = None,
                   out_size: Tuple[int, int] = (224, 224), is_training: bool = True) -> Tensor:
    """VGG / ResNet style (0-255 input): in training a random resized crop
    (area fraction 0.5-1) and a flip, in eval the central 87.5% crop;
    then the ImageNet channel means subtracted."""
    images = images.float()
    if is_training:
        draws = _check_draws(draws, ("area", "aspect", "y", "x", "flip"))
        boxes = random_crop_boxes(draws, images.shape[1], images.shape[2], min_area=0.5)
        images = _flip(_crop(images, boxes, out_size), draws["flip"])
    else:
        images = _central_crop(images, out_size)
    return preprocess_images(images)


def inception_preprocess(images: Tensor, draws: Optional[Dict[str, Tensor]] = None,
                         out_size: Tuple[int, int] = (224, 224),
                         is_training: bool = True) -> Tensor:
    """Inception / MobileNet style (0-255 input): in training a random
    resized crop (area fraction 0.08-1), a flip and a brightness shift in
    [-32, 32) clipped to [0, 255], in eval the central 87.5% crop; then
    scaled to [-1, 1]."""
    images = images.float()
    if is_training:
        draws = _check_draws(draws, DRAW_KEYS)
        boxes = random_crop_boxes(draws, images.shape[1], images.shape[2])
        images = _flip(_crop(images, boxes, out_size), draws["flip"])
        delta = _uniform(draws["brightness"], -32.0, 32.0)
        images = torch.clamp(images + delta[:, None, None, None], 0.0, 255.0)
    else:
        images = _central_crop(images, out_size)
    return images * (2.0 / 255.0) - 1.0

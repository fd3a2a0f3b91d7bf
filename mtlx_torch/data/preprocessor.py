"""Device-side augmentation (port of mtlx/data/preprocessor.py; the
flagship config uses `random_horizontal_flip` only). Batched: a sample
dict holds image [B, H, W, 3] float, boxes [B, G, 4] in absolute canvas
pixels, classes [B, G], mask [B, G] and true_shape [B, 2].

mtlx draws each decision from a key; the port takes the draws as
tensors: for the flip, one uniform in [0, 1) per image, which flips it
when below `probability` (jax.random.bernoulli's rule).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import Tensor


def random_horizontal_flip(sample: Dict[str, Tensor], uniforms: Tensor,
                           probability: float = 0.5) -> Dict[str, Tensor]:
    """Mirror the true-image region of each image whose draw is below
    `probability`, and its boxes."""
    do = uniforms < probability  # [B]
    img = sample["image"]
    b, height, width, ch = img.shape
    w = sample["true_shape"][:, 1].to(torch.int64)[:, None]  # [B, 1]
    cols = torch.arange(width, device=img.device)
    src = torch.where(cols < w, w - 1 - cols, cols)  # [B, W]
    flipped = torch.gather(img, 2, src[:, None, :, None].expand(b, height, width, ch))
    boxes = sample["boxes"]
    wf = w.to(boxes.dtype)
    fboxes = torch.stack(
        [boxes[..., 0], wf - boxes[..., 3], boxes[..., 2], wf - boxes[..., 1]], dim=-1
    )
    out = dict(sample)
    out["image"] = torch.where(do[:, None, None, None], flipped, img)
    out["boxes"] = torch.where(do[:, None, None], fboxes, boxes)
    return out


TRANSFORMS = {"random_horizontal_flip": random_horizontal_flip}


def batch_preprocess(sample: Dict[str, Tensor], options: List[Tuple[str, dict]],
                     draws: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Apply (transform name, kwargs) steps in order; `draws[name]` holds
    each step's uniforms."""
    for name, kwargs in options:
        fn = TRANSFORMS.get(name)
        if fn is None:
            raise NotImplementedError(
                f"augmentation {name!r} is not ported: ROADMAP.md queue 1 item 11 "
                "(the other device-side augmentations)"
            )
        sample = fn(sample, draws[name], **kwargs)
    return sample

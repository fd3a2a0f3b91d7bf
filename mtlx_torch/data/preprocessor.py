"""Device-side augmentation (port of mtlx/data/preprocessor.py):
`random_horizontal_flip` and `ssd_random_crop` (on `random_crop_image`).
Batched: a sample dict holds image [B, H, W, 3] float, boxes [B, G, 4] in
absolute canvas pixels, classes [B, G], mask [B, G] and true_shape [B, 2].

mtlx draws each decision from a key; the port takes the draws as tensors
(`make_draws` makes them from a generator; a test passes JAX's):
  * the flip: one uniform in [0, 1) per image, which flips it when below
    `probability` (jax.random.bernoulli's rule);
  * the crops: a dict of `keep` [B] (keep the image when below
    random_coef), `windows` [B, num_attempts, 4] (the area, aspect, y and
    x uniforms of each candidate window) and, for ssd_random_crop,
    `branch` [B] (int64, the operation each image takes). A uniform u
    becomes minval + u * (maxval - minval) in float32, at least minval,
    as jax.random.uniform scales its bits.

With a fixed_shape_resizer the crops resample the chosen window back onto
the whole canvas: one launch of the crop kernel for the batch. (With a
keep_aspect_ratio_resizer mtlx crops on the host instead,
mtlx/data/host_geometry.py, which is not ported: ROADMAP.md queue 1 item
11.)
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple, Union

import torch
from torch import Tensor

from mtlx_torch.geometry import box_ops
from mtlx_torch.ops import roi as roi_lib

Param = Union[float, Tensor]


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


def _scaled(u: Tensor, minval: Param, maxval: Param) -> Tensor:
    """jax.random.uniform's scaling of its [0, 1) floats, in float32."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=u.device)
    lo, hi = f32(minval), f32(maxval)
    return torch.maximum(lo, u * (hi - lo) + lo)


def _per_image(v: Param, like: Tensor) -> Tensor:
    """A crop parameter as a float32 [B, 1] column."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device).expand(
        like.shape[0]).reshape(-1, 1)


def random_crop_image(
    sample: Dict[str, Tensor],
    draws: Dict[str, Tensor],
    min_object_covered: Param = 1.0,
    min_aspect_ratio: Param = 0.75,
    max_aspect_ratio: Param = 1.33,
    min_area: Param = 0.1,
    max_area: Param = 1.0,
    overlap_thresh: Param = 0.3,
    random_coef: Param = 0.0,
    keep: Tensor = None,
) -> Dict[str, Tensor]:
    """Sample a crop window inside each true image and resample it onto
    the whole canvas (mtlx's random_crop_image). Each parameter is a
    float or a [B] tensor (one value an image, as ssd_random_crop's
    operations give them); `keep` [B] bool keeps those images whole.

    The first of the candidate windows (draws["windows"]) that holds at
    least min_object_covered of some ground-truth box is taken (any window
    when there is no ground truth); with none, or with the keep uniform
    below random_coef, the image stays. Boxes are clipped to the window
    and re-expressed on the resampled canvas; a box whose IoA with the
    window falls below overlap_thresh is masked out."""
    img = sample["image"]
    b, canvas_h, canvas_w, _ = img.shape
    col = lambda v: _per_image(v, img)
    keep_original = draws["keep"].reshape(b, 1) < col(random_coef)
    th = sample["true_shape"][:, 0].float()[:, None]  # [B, 1]
    tw = sample["true_shape"][:, 1].float()[:, None]
    u = draws["windows"]  # [B, K, 4]
    area_frac = _scaled(u[..., 0], col(min_area), col(max_area))
    aspect = _scaled(u[..., 1], col(min_aspect_ratio), col(max_aspect_ratio))
    h = torch.sqrt(area_frac * th * tw / aspect)
    w = h * aspect
    h = torch.minimum(h, th)
    w = torch.minimum(w, tw)
    y = u[..., 2] * (th - h)
    x = u[..., 3] * (tw - w)
    windows = torch.stack([y, x, y + h, x + w], dim=-1)  # [B, K, 4]

    gt_mask = sample["mask"].bool()
    boxes = sample["boxes"]
    cover = box_ops.ioa(windows, boxes)  # [B, K, G]: each box's share inside each window
    covered = ((cover >= col(min_object_covered)[..., None]) & gt_mask[:, None, :]).any(-1)
    # vacuous without ground truth (TF uses the whole image as the box)
    satisfied = covered | ~gt_mask.any(-1, keepdim=True)
    satisfied = torch.where(col(min_object_covered) > 0.0, satisfied, True)
    first = torch.argmax(satisfied.to(torch.uint8), dim=-1)  # the first satisfying window
    keep_original = keep_original[:, 0] | ~satisfied.any(-1)
    if keep is not None:
        keep_original = keep_original | keep
    window = torch.gather(windows, 1, first[:, None, None].expand(b, 1, 4))[:, 0]  # [B, 4]

    norm = torch.tensor([canvas_h, canvas_w, canvas_h, canvas_w], dtype=torch.float32,
                        device=img.device)
    crop = roi_lib.batch_crop_and_resize(img.float().contiguous(),
                                         (window / norm)[:, None, :].contiguous(),
                                         (canvas_h, canvas_w))[:, 0]

    ioa = box_ops.ioa(window[:, None, :], boxes)[:, 0]  # [B, G]
    keep_box = ioa >= col(overlap_thresh)
    clipped = box_ops.clip_to_window(boxes, window)
    y0, x0 = window[:, 0:1], window[:, 1:2]
    ch = window[:, 2:3] - y0
    cw = window[:, 3:4] - x0
    scale_y = ch.new_tensor(float(canvas_h)) / ch
    scale_x = cw.new_tensor(float(canvas_w)) / cw
    moved = torch.stack([(clipped[..., 0] - y0) * scale_y, (clipped[..., 1] - x0) * scale_x,
                         (clipped[..., 2] - y0) * scale_y, (clipped[..., 3] - x0) * scale_x],
                        dim=-1)
    k = keep_original
    out = dict(sample)
    out["image"] = torch.where(k[:, None, None, None], img, crop.to(img.dtype))
    out["boxes"] = torch.where(k[:, None, None], boxes, moved)
    out["mask"] = torch.where(k[:, None], gt_mask, gt_mask & keep_box)
    full = torch.tensor([canvas_h, canvas_w], dtype=sample["true_shape"].dtype,
                        device=img.device)
    out["true_shape"] = torch.where(k[:, None], sample["true_shape"], full)
    return out


# the default operations of ssd_random_crop (mtlx's _SSD_DEFAULT_OPERATIONS),
# after its keep-the-image branch
SSD_DEFAULT_OPERATIONS = tuple(
    dict(min_object_covered=t, min_aspect_ratio=0.5, max_aspect_ratio=2.0,
         min_area=0.1, max_area=1.0, overlap_thresh=t, random_coef=0.0)
    for t in (0.1, 0.3, 0.5, 0.7, 0.9, 0.0)
)
_CROP_KEYS = ("min_object_covered", "min_aspect_ratio", "max_aspect_ratio",
              "min_area", "max_area", "overlap_thresh", "random_coef")
_CROP_DEFAULTS = dict(min_object_covered=1.0, min_aspect_ratio=0.75, max_aspect_ratio=1.33,
                      min_area=0.1, max_area=1.0, overlap_thresh=0.3, random_coef=0.0)


def ssd_branches(operations: Sequence[dict] = ()) -> Tuple[bool, Tuple[dict, ...]]:
    """(whether branch 0 keeps the image, the crop operations after it):
    the default schedule is a keep branch and six crops, configured
    operations are crops only (mtlx's _ssd_branches)."""
    return not operations, tuple(operations) or SSD_DEFAULT_OPERATIONS


def ssd_random_crop(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                    operations: Sequence[dict] = ()) -> Dict[str, Tensor]:
    """Classic SSD patch sampling: each image takes one of the branches
    (draws["branch"], uniform over them in mtlx) and random_crop_image
    with that operation's parameters, all in one batched computation (and
    one crop launch). mtlx's lax.switch under vmap computes every branch
    and selects; only the chosen one is computed here, to the same
    result."""
    keep_branch, ops = ssd_branches(operations)
    branch = draws["branch"].long()
    crop_index = branch - 1 if keep_branch else branch
    keep = crop_index < 0
    params = {}
    for key in _CROP_KEYS:
        table = torch.tensor([float(op.get(key, _CROP_DEFAULTS[key])) for op in ops],
                             dtype=torch.float32, device=branch.device)
        params[key] = table[torch.clamp(crop_index, 0, len(ops) - 1)]
    return random_crop_image(sample, draws, keep=keep, **params)


# the options a pipeline may name (random_crop_image serves ssd_random_crop;
# as an option of its own it is not ported: ROADMAP.md queue 1 item 11)
TRANSFORMS = {"random_horizontal_flip": random_horizontal_flip,
              "ssd_random_crop": ssd_random_crop}

# candidate windows a crop draws (mtlx's num_attempts)
_NUM_ATTEMPTS = 8


def make_draws(name: str, kwargs: dict, batch_size: int,
               generator: torch.Generator) -> Union[Tensor, Dict[str, Tensor]]:
    """One option's draws for a batch, from `generator` on its device:
    the flip's [B] uniforms, or a crop's dict (module docstring)."""
    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    if name == "random_horizontal_flip":
        return u(batch_size)
    if name == "ssd_random_crop":
        keep_branch, ops = ssd_branches(kwargs.get("operations", ()))
        return {"keep": u(batch_size), "windows": u(batch_size, _NUM_ATTEMPTS, 4),
                "branch": torch.randint(0, len(ops) + keep_branch, (batch_size,),
                                        generator=generator, device=generator.device)}
    raise NotImplementedError(
        f"augmentation {name!r} is not ported: ROADMAP.md queue 1 item 11 "
        "(the other device-side augmentations)"
    )


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

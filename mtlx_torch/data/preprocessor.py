"""Device-side augmentation (port of mtlx/data/preprocessor.py): every
entry of mtlx's TRANSFORMS, and the host-geometry window resample.
Batched: a sample dict holds image [B, H, W, 3] float (0-255), boxes
[B, G, 4] in absolute canvas pixels, classes [B, G], mask [B, G] and
true_shape [B, 2] (the real image's extent within the canvas).

mtlx draws each decision from a key (per image and per option: step i of
image b takes `fold_in(split(rng, B)[b], i)`); the port takes the draws as
tensors. `make_draws` makes one option's draws from a generator, and a
test passes JAX's. What each option takes:
  * a [B] uniform in [0, 1): the flips, random_rotation90 and
    random_rgb_to_gray (the image changes when it is below `probability`,
    jax.random.bernoulli's rule), random_image_scale and the
    brightness / contrast / hue / saturation adjustments (scaled into
    their range);
  * random_distort_color: [B, 4] uniforms, its four adjustments in order;
  * random_jitter_boxes: [B, G, 4] uniforms; random_pixel_value_scale
    [B, H, W, 3];
  * random_black_patches: a dict of `do` [B, P] uniforms and `y`, `x`
    [B, P] int64 corners (jax.random.randint's draws);
  * random_pad_image: [B, 4] int64, the raw randint draws of the new
    height (in [0, H]), the new width (in [0, W]), the top (in [0, H))
    and the left (in [0, W)), reduced as mtlx reduces them;
  * the crops: a dict of `keep` [B] (keep the image when below
    random_coef) and `windows` [B, num_attempts, 4] (the area, aspect, y
    and x uniforms of each candidate window); the SSD crops add `branch`
    [B] (int64, the operation each image takes) and the crop-and-pad ones
    `pad` [B, 4] (random_pad_image's draws);
  * normalize_image, subtract_channel_mean, resize_image,
    random_resize_method and scale_boxes_to_pixel_coordinates: none (an
    empty dict).
A uniform u becomes minval + u * (maxval - minval) in float32, at least
minval, as jax.random.uniform scales its bits.

With a fixed_shape_resizer the crops resample the chosen window back onto
the whole canvas: one launch of the crop kernel for the batch. With a
keep_aspect_ratio_resizer the crop / pad family runs on the host instead
(data/host_geometry.py), and `batch_apply_host_window` resamples the
pixels on the device.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from mtlx_torch.geometry import box_ops, keypoint_ops
from mtlx_torch.ops import roi as roi_lib

Param = Union[float, Tensor]
Draws = Union[Tensor, Dict[str, Tensor]]


def _f32(v, like: Tensor) -> Tensor:
    """A float32 tensor on `like`'s device (a divisor stays a tensor, so the
    division is IEEE's on every device)."""
    return torch.as_tensor(v, dtype=torch.float32, device=like.device)


def _scaled(u: Tensor, minval: Param, maxval: Param) -> Tensor:
    """jax.random.uniform's scaling of its [0, 1) floats, at least lo:
    u * (hi - lo) + lo as XLA computes it, one fused multiply-add in
    float32. The float64 product of two float32s is exact, so rounding the
    float64 sum to float32 gives the fused result (but for a double
    rounding, which float64's 29 spare bits make rare)."""
    lo, hi = _f32(minval, u), _f32(maxval, u)
    fused = (u.double() * (hi - lo).double() + lo.double()).float()
    return torch.maximum(lo, fused)


def _per_image(v: Param, like: Tensor) -> Tensor:
    """A crop parameter as a float32 [B, 1] column."""
    return _f32(v, like).expand(like.shape[0]).reshape(-1, 1)


def _gather_rows_cols(img: Tensor, rows: Tensor, cols: Tensor) -> Tensor:
    """out[b, i, j] = img[b, rows[b, i], cols[b, j]] (rows [B, H'], cols
    [B, W'], int64)."""
    b, _, w, c = img.shape
    picked = torch.gather(img, 1, rows[:, :, None, None].expand(b, rows.shape[1], w, c))
    return torch.gather(picked, 2, cols[:, None, :, None].expand(b, rows.shape[1],
                                                                  cols.shape[1], c))


def _inside(img: Tensor, new_h: Tensor, new_w: Tensor) -> Tensor:
    """[B, H, W, 1]: the pixels within each image's (new_h, new_w)."""
    _, height, width, _ = img.shape
    rows = torch.arange(height, device=img.device)
    cols = torch.arange(width, device=img.device)
    return ((rows[None, :, None] < new_h[:, None, None])
            & (cols[None, None, :] < new_w[:, None, None]))[..., None]


# ---------------------------------------------------------------- geometric


def random_horizontal_flip(sample: Dict[str, Tensor], uniforms: Tensor,
                           probability: float = 0.5) -> Dict[str, Tensor]:
    """Mirror the true-image region of each image whose draw is below
    `probability`, its boxes and, where the sample has them, its
    instance masks [B, G, gh, gw] (at canvas / stride, mirrored within
    round(true width / stride)) and keypoints [B, G, P, 2]."""
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
    if "instance_masks" in sample:
        out["instance_masks"] = _flip_masks(sample["instance_masks"], w, width, 3, do)
    if "keypoints" in sample:
        kp = sample["keypoints"]
        flipped_kp = keypoint_ops.flip_horizontal(kp, wf[:, :, None] / 2.0)
        out["keypoints"] = torch.where(do[:, None, None, None], flipped_kp, kp)
    return out


def _flip_masks(m: Tensor, extent: Tensor, canvas: int, dim: int, do: Tensor) -> Tensor:
    """Instance masks [B, G, gh, gw] mirrored along `dim` (2: rows, 3:
    columns) within each image's extent [B, 1] on the mask raster, where
    `do` [B] is set: the raster's stride is the canvas extent over its
    size, and the true extent rounds to it half to even (jnp.round)."""
    size = m.shape[dim]
    stride = canvas // size
    em = torch.round(extent.to(torch.float32) / stride).to(torch.int64)  # [B, 1]
    idx = torch.arange(size, device=m.device)
    src = torch.where(idx < em, em - 1 - idx, idx)  # [B, size]
    shape = [m.shape[0], 1, 1, 1]
    shape[dim] = size
    flipped = torch.gather(m, dim, src.reshape(shape).expand(m.shape))
    return torch.where(do[:, None, None, None], flipped, m)


def random_vertical_flip(sample: Dict[str, Tensor], uniforms: Tensor,
                         probability: float = 0.5) -> Dict[str, Tensor]:
    """Mirror the true-image region top to bottom, its boxes and, where
    the sample has them, its instance masks and keypoints."""
    do = uniforms < probability
    img = sample["image"]
    b, height, width, ch = img.shape
    h = sample["true_shape"][:, 0].to(torch.int64)[:, None]
    rows = torch.arange(height, device=img.device)
    src = torch.where(rows < h, h - 1 - rows, rows)  # [B, H]
    flipped = torch.gather(img, 1, src[:, :, None, None].expand(b, height, width, ch))
    boxes = sample["boxes"]
    hf = h.to(boxes.dtype)
    fboxes = torch.stack(
        [hf - boxes[..., 2], boxes[..., 1], hf - boxes[..., 0], boxes[..., 3]], dim=-1
    )
    out = dict(sample)
    out["image"] = torch.where(do[:, None, None, None], flipped, img)
    out["boxes"] = torch.where(do[:, None, None], fboxes, boxes)
    if "instance_masks" in sample:
        out["instance_masks"] = _flip_masks(sample["instance_masks"], h, height, 2, do)
    if "keypoints" in sample:
        kp = sample["keypoints"]
        flipped_kp = keypoint_ops.flip_vertical(kp, hf[:, :, None] / 2.0)
        out["keypoints"] = torch.where(do[:, None, None, None], flipped_kp, kp)
    return out


def random_jitter_boxes(sample: Dict[str, Tensor], uniforms: Tensor,
                        ratio: float = 0.05) -> Dict[str, Tensor]:
    """Move each box corner by up to `ratio` of the box's extent."""
    boxes = sample["boxes"]
    h = boxes[..., 2] - boxes[..., 0]
    w = boxes[..., 3] - boxes[..., 1]
    noise = _scaled(uniforms, -ratio, ratio)
    out = dict(sample)
    out["boxes"] = boxes + noise * torch.stack([h, w, h, w], dim=-1)
    return out


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
    float or a [B] tensor (one value an image, as the SSD crops'
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


def random_rotation90(sample: Dict[str, Tensor], uniforms: Tensor,
                      probability: float = 0.5) -> Dict[str, Tensor]:
    """Rotate the true region 90 degrees counter-clockwise; on a canvas
    that is not square the option does nothing (mtlx's static-shape rule)."""
    img = sample["image"]
    b, height, width, ch = img.shape
    if height != width:
        return sample
    do = uniforms < probability
    th = sample["true_shape"][:, 0].to(torch.int64)
    tw = sample["true_shape"][:, 1].to(torch.int64)
    rows = torch.arange(height, device=img.device)[None, :, None]
    cols = torch.arange(width, device=img.device)[None, None, :]
    # counter-clockwise within the true region: out[i, j] = in[j, tw - 1 - i]
    src_r = torch.clamp(cols, 0, height - 1).expand(b, height, width)
    src_c = torch.clamp(tw[:, None, None] - 1 - rows, 0, width - 1).expand(b, height, width)
    inside = (rows < tw[:, None, None]) & (cols < th[:, None, None])
    flat = (src_r * width + src_c).reshape(b, height * width, 1).expand(-1, -1, ch)
    picked = torch.gather(img.reshape(b, height * width, ch), 1, flat).reshape(img.shape)
    rotated = torch.where(inside[..., None], picked, 0.0)
    boxes = sample["boxes"]
    twf = tw.to(boxes.dtype)[:, None]
    rboxes = torch.stack(
        [twf - boxes[..., 3], boxes[..., 0], twf - boxes[..., 1], boxes[..., 2]], dim=-1
    )
    out = dict(sample)
    out["image"] = torch.where(do[:, None, None, None], rotated, img)
    out["boxes"] = torch.where(do[:, None, None], rboxes, boxes)
    out["true_shape"] = torch.where(do[:, None], sample["true_shape"].flip(-1),
                                    sample["true_shape"])
    return out


def _resample_scaled(img: Tensor, sy: Tensor, sx: Tensor, method: str = "bilinear") -> Tensor:
    """out[b, i, j] = interp(in[b], i / sy[b], j / sx[b]) on the fixed
    canvas (mtlx's _resample_scaled, one scale pair an image)."""
    _, height, width, _ = img.shape
    ys = torch.arange(height, dtype=torch.float32, device=img.device)[None, :] / sy[:, None]
    xs = torch.arange(width, dtype=torch.float32, device=img.device)[None, :] / sx[:, None]
    if method == "nearest":
        yn = torch.clamp(torch.round(ys).to(torch.int64), 0, height - 1)
        xn = torch.clamp(torch.round(xs).to(torch.int64), 0, width - 1)
        return _gather_rows_cols(img, yn, xn)
    y0 = torch.clamp(torch.floor(ys).to(torch.int64), 0, height - 1)
    x0 = torch.clamp(torch.floor(xs).to(torch.int64), 0, width - 1)
    y1 = torch.clamp(y0 + 1, 0, height - 1)
    x1 = torch.clamp(x0 + 1, 0, width - 1)
    fy = (ys - y0.float())[:, :, None, None]
    fx = (xs - x0.float())[:, None, :, None]
    tl = _gather_rows_cols(img, y0, x0)
    tr = _gather_rows_cols(img, y0, x1)
    bl = _gather_rows_cols(img, y1, x0)
    br = _gather_rows_cols(img, y1, x1)
    top = tl + (tr - tl) * fx
    bot = bl + (br - bl) * fx
    return top + (bot - top) * fy


def _rescaled(sample: Dict[str, Tensor], sy: Tensor, sx: Tensor, new_h: Tensor, new_w: Tensor,
              method: str = "bilinear") -> Dict[str, Tensor]:
    """The true region resampled by (sy, sx) per image, zero outside
    (new_h, new_w), the boxes scaled with it."""
    img = sample["image"]
    scaled = _resample_scaled(img, sy, sx, method)
    out = dict(sample)
    out["image"] = torch.where(_inside(img, new_h, new_w), scaled, 0.0)
    out["boxes"] = sample["boxes"] * torch.stack([sy, sx, sy, sx], dim=-1)[:, None, :]
    out["true_shape"] = torch.stack([new_h, new_w], dim=-1).to(sample["true_shape"].dtype)
    return out


def random_image_scale(sample: Dict[str, Tensor], uniforms: Tensor, min_scale_ratio: float = 0.5,
                       max_scale_ratio: float = 2.0) -> Dict[str, Tensor]:
    """Rescale the true-image content by a random factor, capped so it
    stays on the canvas; boxes and true_shape scale with it."""
    img = sample["image"]
    _, height, width, _ = img.shape
    th = sample["true_shape"][:, 0].float()
    tw = sample["true_shape"][:, 1].float()
    s = _scaled(uniforms, min_scale_ratio, max_scale_ratio)
    s = torch.minimum(s, torch.minimum(_f32(height, th) / th, _f32(width, tw) / tw))
    new_h = torch.floor(th * s).to(torch.int64)
    new_w = torch.floor(tw * s).to(torch.int64)
    return _rescaled(sample, s, s, new_h, new_w)


def _resize_to(sample: Dict[str, Tensor], target_h: int, target_w: int,
               method: str = "bilinear") -> Dict[str, Tensor]:
    """The true region resized to (target_h, target_w), capped at the canvas."""
    img = sample["image"]
    b, height, width, _ = img.shape
    th = sample["true_shape"][:, 0].float()
    tw = sample["true_shape"][:, 1].float()
    sy = torch.minimum(_f32(target_h, th) / th, _f32(height, th) / th)
    sx = torch.minimum(_f32(target_w, tw) / tw, _f32(width, tw) / tw)
    full = lambda v: torch.full((b,), v, dtype=torch.int64, device=img.device)
    return _rescaled(sample, sy, sx, full(min(target_h, height)), full(min(target_w, width)),
                     method)


def random_resize_method(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                         target_height: int, target_width: int) -> Dict[str, Tensor]:
    """Resize the true region to a fixed target, bilinear (mtlx computes
    the reference's random interpolation choice as bilinear)."""
    return _resize_to(sample, target_height, target_width)


def resize_image(sample: Dict[str, Tensor], draws: Dict[str, Tensor], new_height: int = 0,
                 new_width: int = 0, method: int = 3) -> Dict[str, Tensor]:
    """Deterministic resize of the true region to (new_height, new_width).
    `method` is the ResizeImage enum: 4 NEAREST_NEIGHBOR is exact, the
    others (1 AREA, 2 BICUBIC, 3 BILINEAR) are bilinear, as in mtlx."""
    if not new_height or not new_width:
        raise ValueError("resize_image requires new_height and new_width")
    return _resize_to(sample, new_height, new_width, "nearest" if method == 4 else "bilinear")


def _pad(sample: Dict[str, Tensor], ints: Tensor, fill: Tensor,
         min_hw: Tuple[int, int] = (0, 0), max_hw: Tuple[int, int] = (0, 0),
         min_ratio: Optional[Tensor] = None, max_ratio: Optional[Tensor] = None,
         has_max_ratio: Optional[Tensor] = None) -> Dict[str, Tensor]:
    """mtlx's random_pad_image on each image: grow the true region to a
    drawn size (within the bounds, clamped to the canvas) and move the
    content to a drawn offset; the rest reads `fill` [B, 3]. The ratios
    are [B, 2] (height, width) multiples of the true size: a minimum of 0
    bounds nothing, and a maximum bounds where `has_max_ratio` [B]."""
    img = sample["image"]
    b, height, width, _ = img.shape
    th = sample["true_shape"][:, 0].to(torch.int64)
    tw = sample["true_shape"][:, 1].to(torch.int64)
    min_h = torch.clamp(th, min=int(min_hw[0]))
    min_w = torch.clamp(tw, min=int(min_hw[1]))
    max_h = torch.full_like(th, int(max_hw[0] or height))
    max_w = torch.full_like(tw, int(max_hw[1] or width))
    if min_ratio is not None:
        min_h = torch.maximum(min_h, torch.ceil(min_ratio[:, 0] * th.float()).to(torch.int64))
        min_w = torch.maximum(min_w, torch.ceil(min_ratio[:, 1] * tw.float()).to(torch.int64))
    if max_ratio is not None:
        max_h = torch.where(has_max_ratio, torch.minimum(
            max_h, torch.floor(max_ratio[:, 0] * th.float()).to(torch.int64)), max_h)
        max_w = torch.where(has_max_ratio, torch.minimum(
            max_w, torch.floor(max_ratio[:, 1] * tw.float()).to(torch.int64)), max_w)
    # jnp.clip: the upper bound wins where the bounds cross
    new_h = torch.minimum(torch.maximum(ints[:, 0], torch.clamp(min_h, max=height)),
                          torch.maximum(torch.clamp(max_h, max=height), min_h))
    new_h = torch.clamp(new_h, max=height)
    new_w = torch.minimum(torch.maximum(ints[:, 1], torch.clamp(min_w, max=width)),
                          torch.maximum(torch.clamp(max_w, max=width), min_w))
    new_w = torch.clamp(new_w, max=width)
    top = ints[:, 2] % torch.clamp(new_h - th, min=1)
    left = ints[:, 3] % torch.clamp(new_w - tw, min=1)
    rows = torch.arange(height, device=img.device)[None, :]
    cols = torch.arange(width, device=img.device)[None, :]
    src_r = torch.clamp(rows - top[:, None], 0, height - 1)
    src_c = torch.clamp(cols - left[:, None], 0, width - 1)
    in_r = (rows >= top[:, None]) & (rows < (top + th)[:, None])
    in_c = (cols >= left[:, None]) & (cols < (left + tw)[:, None])
    content = (in_r[:, :, None] & in_c[:, None, :])[..., None]
    out = dict(sample)
    out["image"] = torch.where(content, _gather_rows_cols(img, src_r, src_c),
                               fill.to(img.dtype)[:, None, None, :])
    offset = torch.stack([top, left, top, left], dim=-1).to(sample["boxes"].dtype)
    out["boxes"] = sample["boxes"] + offset[:, None, :]
    out["true_shape"] = torch.stack([new_h, new_w], dim=-1).to(sample["true_shape"].dtype)
    return out


def _fill(pad_color: Sequence[float], like: Tensor) -> Tensor:
    """The pad colour of every image, [B, 3] (black unless three values)."""
    color = tuple(pad_color) if len(pad_color) == 3 else (0.0, 0.0, 0.0)
    return _f32(color, like).expand(like.shape[0], 3)


def _ratio(ratio: Sequence[float], like: Tensor) -> Optional[Tensor]:
    """A (height, width) size ratio as [B, 2], or None when not two values."""
    return _f32(tuple(ratio), like).expand(like.shape[0], 2) if len(ratio) == 2 else None


def random_pad_image(sample: Dict[str, Tensor], ints: Tensor, min_image_height: int = 0,
                     min_image_width: int = 0, max_image_height: int = 0,
                     max_image_width: int = 0, pad_color: Sequence[float] = (),
                     min_size_ratio: Sequence[float] = (),
                     max_size_ratio: Sequence[float] = ()) -> Dict[str, Tensor]:
    """Grow the true region by padding above and left of the content, on
    the fixed canvas (mtlx's random_pad_image): the absolute bounds and the
    [h, w] ratios of the true size bound the new size, all clamped to the
    canvas."""
    img = sample["image"]
    max_ratio = _ratio(max_size_ratio, img)
    has_max = None if max_ratio is None else torch.ones(img.shape[0], dtype=torch.bool,
                                                        device=img.device)
    return _pad(sample, ints, _fill(pad_color, img), (min_image_height, min_image_width),
                (max_image_height, max_image_width), _ratio(min_size_ratio, img), max_ratio,
                has_max)


def random_crop_to_aspect_ratio(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                                aspect_ratio: float = 1.0,
                                overlap_thresh: float = 0.3) -> Dict[str, Tensor]:
    """Crop the true region to the target aspect ratio (a window of 95-100%
    of the area, no coverage constraint), as mtlx does."""
    return random_crop_image(sample, draws, min_object_covered=0.0,
                             min_aspect_ratio=aspect_ratio, max_aspect_ratio=aspect_ratio,
                             min_area=0.95, max_area=1.0, overlap_thresh=overlap_thresh)


def random_crop_pad_image(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                          min_object_covered=1.0, min_aspect_ratio=0.75, max_aspect_ratio=1.33,
                          min_area=0.1, max_area=1.0, overlap_thresh=0.3, random_coef=0.0,
                          min_padded_size_ratio=(), max_padded_size_ratio=(),
                          pad_color=()) -> Dict[str, Tensor]:
    """random_crop_image, then random_pad_image with the padded-size ratios."""
    s = random_crop_image(sample, draws, min_object_covered, min_aspect_ratio, max_aspect_ratio,
                          min_area, max_area, overlap_thresh, random_coef)
    return random_pad_image(s, draws["pad"], pad_color=tuple(pad_color),
                            min_size_ratio=tuple(min_padded_size_ratio),
                            max_size_ratio=tuple(max_padded_size_ratio))


# the default operations of the SSD crops (mtlx's _SSD_DEFAULT_OPERATIONS),
# after their keep-the-image branch
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


def _ssd_crop(sample: Dict[str, Tensor], draws: Dict[str, Tensor], operations: Sequence[dict],
              fixed_aspect: Optional[float] = None, with_pad: bool = False) -> Dict[str, Tensor]:
    """Each image takes one of the branches (draws["branch"], uniform over
    them in mtlx) and random_crop_image with that operation's parameters
    (then random_pad_image with its pad ratios and colour), all in one
    batched computation and one crop launch. mtlx's lax.switch under vmap
    computes every branch and selects; only the chosen one is computed
    here, to the same result."""
    keep_branch, ops = ssd_branches(operations)
    branch = draws["branch"].long()
    crop_index = branch - 1 if keep_branch else branch
    keep = crop_index < 0
    index = torch.clamp(crop_index, 0, len(ops) - 1)
    table = lambda rows: torch.tensor(rows, dtype=torch.float32, device=branch.device)[index]
    params = {}
    for key in _CROP_KEYS:
        params[key] = table([float(op.get(key, _CROP_DEFAULTS[key])) for op in ops])
    if fixed_aspect is not None:
        params["min_aspect_ratio"] = params["max_aspect_ratio"] = _f32(fixed_aspect, branch)
    out = random_crop_image(sample, draws, keep=keep, **params)
    if not with_pad:
        return out
    sizes = lambda key: [tuple(op.get(key, ())) for op in ops]
    fills = [tuple(c) if len(c) == 3 else (0.0, 0.0, 0.0) for c in sizes("pad_color")]
    mins = [r if len(r) == 2 else (0.0, 0.0) for r in sizes("min_padded_size_ratio")]
    maxs = [r if len(r) == 2 else (0.0, 0.0) for r in sizes("max_padded_size_ratio")]
    has_max = torch.tensor([len(r) == 2 for r in sizes("max_padded_size_ratio")],
                           device=branch.device)[index]
    padded = _pad(out, draws["pad"], table(fills), min_ratio=table(mins),
                  max_ratio=table(maxs), has_max_ratio=has_max)
    # the keep branch neither crops nor pads
    return {k: torch.where(keep.reshape((-1,) + (1,) * (v.dim() - 1)), out[k], v)
            if k in ("image", "boxes", "true_shape") else v for k, v in padded.items()}


def ssd_random_crop(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                    operations: Sequence[dict] = ()) -> Dict[str, Tensor]:
    """Classic SSD patch sampling: a uniform pick among the operations
    (default: the keep branch and six crops)."""
    return _ssd_crop(sample, draws, operations)


def ssd_random_crop_pad(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                        operations: Sequence[dict] = ()) -> Dict[str, Tensor]:
    """Crop then pad, each operation with its own pad-size ratios and
    colour (mtlx's ssd_random_crop_pad)."""
    return _ssd_crop(sample, draws, operations, with_pad=True)


def ssd_random_crop_fixed_aspect_ratio(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                                       operations: Sequence[dict] = (),
                                       aspect_ratio: float = 1.0) -> Dict[str, Tensor]:
    """ssd_random_crop with every operation's aspect ratio forced to
    `aspect_ratio`."""
    return _ssd_crop(sample, draws, operations, fixed_aspect=aspect_ratio)


def scale_boxes_to_pixel_coordinates(sample: Dict[str, Tensor],
                                     draws: Dict[str, Tensor]) -> Dict[str, Tensor]:
    """Normalized [0, 1] boxes to absolute pixels of the true region."""
    ts = sample["true_shape"].to(sample["boxes"].dtype)
    out = dict(sample)
    out["boxes"] = sample["boxes"] * torch.cat([ts, ts], dim=-1)[:, None, :]
    return out


# ---------------------------------------------------------------- photometric (0-255 floats)


def normalize_image(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                    original_minval=0.0, original_maxval=255.0, target_minval=0.0,
                    target_maxval=1.0) -> Dict[str, Tensor]:
    img = sample["image"]
    img = (img - original_minval) / _f32(original_maxval - original_minval, img)
    out = dict(sample)
    out["image"] = img * (target_maxval - target_minval) + target_minval
    return out


def random_pixel_value_scale(sample: Dict[str, Tensor], uniforms: Tensor, minval=0.9,
                             maxval=1.1) -> Dict[str, Tensor]:
    out = dict(sample)
    out["image"] = torch.clamp(sample["image"] * _scaled(uniforms, minval, maxval), 0.0, 255.0)
    return out


def _column(v: Tensor) -> Tensor:
    """A per-image scalar as [B, 1, 1, 1]."""
    return v.reshape(-1, 1, 1, 1)


def random_adjust_brightness(sample: Dict[str, Tensor], uniforms: Tensor,
                             max_delta=0.2) -> Dict[str, Tensor]:
    delta = _scaled(uniforms, -max_delta, max_delta) * 255.0
    out = dict(sample)
    out["image"] = torch.clamp(sample["image"] + _column(delta), 0.0, 255.0)
    return out


def random_adjust_contrast(sample: Dict[str, Tensor], uniforms: Tensor, min_delta=0.8,
                           max_delta=1.25) -> Dict[str, Tensor]:
    factor = _column(_scaled(uniforms, min_delta, max_delta))
    mean = sample["image"].mean(dim=(1, 2), keepdim=True)
    out = dict(sample)
    out["image"] = torch.clamp((sample["image"] - mean) * factor + mean, 0.0, 255.0)
    return out


def _rgb_to_hsv(rgb: Tensor) -> Tensor:
    """mtlx's _hsv_vec: RGB in [0, 1] to (hue in [0, 1), saturation, value)."""
    r, g, b = rgb.unbind(-1)
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    diff = mx - mn + 1e-12
    six = _f32(6.0, rgb)
    h = torch.where(
        mx == r, torch.remainder((g - b) / diff, 6.0),
        torch.where(mx == g, (b - r) / diff + 2.0, (r - g) / diff + 4.0),
    ) / six
    s = torch.where(mx > 0, diff / (mx + 1e-12), 0.0)
    return torch.stack([h, s, mx], dim=-1)


def _hsv_to_rgb(hsv: Tensor) -> Tensor:
    """mtlx's _hsv_to_rgb_vec."""
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    c = v * s
    x = c * (1.0 - torch.abs(torch.remainder(h, 2.0) - 1.0))
    m = v - c
    z = torch.zeros_like(c)
    idx = torch.remainder(torch.floor(h).to(torch.int64), 6)[..., None]
    pick = lambda *choices: torch.gather(torch.stack(choices, dim=-1), -1, idx)[..., 0]
    r = pick(c, x, z, z, x, c)
    g = pick(x, c, c, x, z, z)
    b = pick(z, z, x, c, c, x)
    return torch.stack([r + m, g + m, b + m], dim=-1)


def random_adjust_hue(sample: Dict[str, Tensor], uniforms: Tensor,
                      max_delta=0.02) -> Dict[str, Tensor]:
    delta = _scaled(uniforms, -max_delta, max_delta)
    hsv = _rgb_to_hsv(sample["image"] / _f32(255.0, uniforms))
    hue = torch.remainder(hsv[..., 0] + delta.reshape(-1, 1, 1), 1.0)
    hsv = torch.cat([hue[..., None], hsv[..., 1:]], dim=-1)
    out = dict(sample)
    out["image"] = torch.clamp(_hsv_to_rgb(hsv) * 255.0, 0.0, 255.0)
    return out


def random_adjust_saturation(sample: Dict[str, Tensor], uniforms: Tensor, min_delta=0.8,
                             max_delta=1.25) -> Dict[str, Tensor]:
    factor = _scaled(uniforms, min_delta, max_delta)
    hsv = _rgb_to_hsv(sample["image"] / _f32(255.0, uniforms))
    sat = torch.clamp(hsv[..., 1] * factor.reshape(-1, 1, 1), 0.0, 1.0)
    hsv = torch.stack([hsv[..., 0], sat, hsv[..., 2]], dim=-1)
    out = dict(sample)
    out["image"] = torch.clamp(_hsv_to_rgb(hsv) * 255.0, 0.0, 255.0)
    return out


def random_rgb_to_gray(sample: Dict[str, Tensor], uniforms: Tensor,
                       probability=0.1) -> Dict[str, Tensor]:
    do = uniforms < probability
    img = sample["image"]
    gray = (img * _f32((0.2989, 0.587, 0.114), img)).sum(-1, keepdim=True)
    out = dict(sample)
    out["image"] = torch.where(_column(do), gray.expand(img.shape), img)
    return out


def random_distort_color(sample: Dict[str, Tensor], uniforms: Tensor,
                         color_ordering=0) -> Dict[str, Tensor]:
    """Brightness, then saturation, hue and contrast (ordering 0) or
    contrast, saturation and hue; uniforms [B, 4] in that order."""
    s = random_adjust_brightness(sample, uniforms[:, 0], 32.0 / 255.0)
    if color_ordering == 0:
        s = random_adjust_saturation(s, uniforms[:, 1], 0.5, 1.5)
        s = random_adjust_hue(s, uniforms[:, 2], 0.2)
        return random_adjust_contrast(s, uniforms[:, 3], 0.5, 1.5)
    s = random_adjust_contrast(s, uniforms[:, 1], 0.5, 1.5)
    s = random_adjust_saturation(s, uniforms[:, 2], 0.5, 1.5)
    return random_adjust_hue(s, uniforms[:, 3], 0.2)


def _patch_size(ratio: float, height: int, width: int) -> int:
    return int(ratio * max(height, width))


def random_black_patches(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                         max_black_patches=10, probability=0.5,
                         size_to_image_ratio=0.1) -> Dict[str, Tensor]:
    """Black out up to max_black_patches squares of size_to_image_ratio
    of the canvas's longer side, each with `probability`."""
    img = sample["image"]
    _, height, width, _ = img.shape
    size = _patch_size(size_to_image_ratio, height, width)
    rows = torch.arange(height, device=img.device)[None, :]
    cols = torch.arange(width, device=img.device)[None, :]
    black = torch.zeros(img.shape[:3], dtype=torch.bool, device=img.device)
    for i in range(max_black_patches):
        y0, x0 = draws["y"][:, i:i + 1], draws["x"][:, i:i + 1]
        in_r = (rows >= y0) & (rows < y0 + size)
        in_c = (cols >= x0) & (cols < x0 + size)
        do = (draws["do"][:, i] < probability)[:, None, None]
        black |= do & in_r[:, :, None] & in_c[:, None, :]
    out = dict(sample)
    out["image"] = torch.where(black[..., None], 0.0, img)
    return out


def subtract_channel_mean(sample: Dict[str, Tensor], draws: Dict[str, Tensor],
                          means=(0.0, 0.0, 0.0)) -> Dict[str, Tensor]:
    out = dict(sample)
    out["image"] = sample["image"] - _f32(tuple(means), sample["image"])
    return out


# ---------------------------------------------------------------- host-geometry window


def batch_apply_host_window(images: Tensor, true_shapes: Tensor, windows: Tensor,
                            src_shapes: Tensor, pad_colors: Tensor,
                            contents: Optional[Tensor] = None) -> Tensor:
    """Materialize host-drawn crop / pad geometry (data/host_geometry.py)
    on a batch: one half-pixel bilinear resample of each image's `window`
    (source-canvas coordinates) onto its [0, true_shape) region, clamped
    at the window's edge (mtlx's apply_host_window, vmapped). A tap
    outside `contents` (the source pixels still visible after the op
    chain; default the true source region [0, src_shape)) reads the pad
    colour; the output beyond true_shape is zero.

    images [B, H, W, C] float; windows / contents [B, 4] float (y0, x0,
    y1, x1); true_shapes / src_shapes [B, 2] int; pad_colors [B, C]."""
    b, height, width, _ = images.shape
    dev = images.device
    windows = windows.float()
    fh = true_shapes[:, 0].float()[:, None]
    fw = true_shapes[:, 1].float()[:, None]
    sh = src_shapes[:, 0].float()[:, None]
    sw = src_shapes[:, 1].float()[:, None]
    if contents is None:
        contents = torch.cat([torch.zeros_like(src_shapes, dtype=torch.float32),
                              src_shapes.float()], dim=-1)
    c = contents.float()
    w0, w1, w2, w3 = (windows[:, k:k + 1] for k in range(4))
    ys = (torch.arange(height, dtype=torch.float32, device=dev)[None, :] + 0.5) * (
        (w2 - w0) / fh) - 0.5 + w0
    xs = (torch.arange(width, dtype=torch.float32, device=dev)[None, :] + 0.5) * (
        (w3 - w1) / fw) - 0.5 + w1
    ys = torch.minimum(torch.maximum(ys, w0), torch.maximum(w2 - 1.0, w0))
    xs = torch.minimum(torch.maximum(xs, w1), torch.maximum(w3 - 1.0, w1))
    y0f = torch.floor(ys)
    x0f = torch.floor(xs)
    wy = (ys - y0f)[:, :, None, None]
    wx = (xs - x0f)[:, None, :, None]
    pad = pad_colors.to(images.dtype)[:, None, None, :]
    y_lo, y_hi = torch.clamp(c[:, 0:1], min=0.0), torch.minimum(c[:, 2:3], sh)
    x_lo, x_hi = torch.clamp(c[:, 1:2], min=0.0), torch.minimum(c[:, 3:4], sw)

    def tap(yt: Tensor, xt: Tensor) -> Tensor:
        ok = (((yt >= y_lo) & (yt < y_hi))[:, :, None]
              & ((xt >= x_lo) & (xt < x_hi))[:, None, :])[..., None]
        yi = torch.clamp(yt.to(torch.int64), 0, height - 1)
        xi = torch.clamp(xt.to(torch.int64), 0, width - 1)
        return torch.where(ok, _gather_rows_cols(images, yi, xi), pad)

    out = (tap(y0f, x0f) * (1 - wy) * (1 - wx)
           + tap(y0f, x0f + 1) * (1 - wy) * wx
           + tap(y0f + 1, x0f) * wy * (1 - wx)
           + tap(y0f + 1, x0f + 1) * wy * wx)
    rows = torch.arange(height, dtype=torch.float32, device=dev)[None, :, None]
    cols = torch.arange(width, dtype=torch.float32, device=dev)[None, None, :]
    inside = ((rows < fh[:, :, None]) & (cols < fw[:, :, None]))[..., None]
    return torch.where(inside, out, 0.0)


# ---------------------------------------------------------------- dispatcher

TRANSFORMS: Dict[str, Callable] = {
    "normalize_image": normalize_image,
    "random_horizontal_flip": random_horizontal_flip,
    "random_vertical_flip": random_vertical_flip,
    "random_pixel_value_scale": random_pixel_value_scale,
    "random_rgb_to_gray": random_rgb_to_gray,
    "random_adjust_brightness": random_adjust_brightness,
    "random_adjust_contrast": random_adjust_contrast,
    "random_adjust_hue": random_adjust_hue,
    "random_adjust_saturation": random_adjust_saturation,
    "random_distort_color": random_distort_color,
    "random_jitter_boxes": random_jitter_boxes,
    "random_crop_image": random_crop_image,
    "ssd_random_crop": ssd_random_crop,
    "ssd_random_crop_pad": ssd_random_crop_pad,
    "ssd_random_crop_fixed_aspect_ratio": ssd_random_crop_fixed_aspect_ratio,
    "random_rotation90": random_rotation90,
    "random_image_scale": random_image_scale,
    "random_pad_image": random_pad_image,
    "random_crop_pad_image": random_crop_pad_image,
    "random_crop_to_aspect_ratio": random_crop_to_aspect_ratio,
    "random_resize_method": random_resize_method,
    "resize_image": resize_image,
    "scale_boxes_to_pixel_coordinates": scale_boxes_to_pixel_coordinates,
    "random_black_patches": random_black_patches,
    "subtract_channel_mean": subtract_channel_mean,
}

# the options that carry instance masks and keypoints along: the flips
# mirror them, the photometric and box-only ones leave them as they are.
# The crop, scale and rotation family does not transform them, and the
# train CLI refuses it when they are loaded (train.make_augmented_batch_fn)
MASK_SAFE_TRANSFORMS = frozenset({
    "normalize_image",
    "random_horizontal_flip",
    "random_vertical_flip",
    "random_pixel_value_scale",
    "random_rgb_to_gray",
    "random_adjust_brightness",
    "random_adjust_contrast",
    "random_adjust_hue",
    "random_adjust_saturation",
    "random_distort_color",
    "random_jitter_boxes",
    "scale_boxes_to_pixel_coordinates",
    "subtract_channel_mean",
})

# candidate windows a crop draws (mtlx's num_attempts)
NUM_ATTEMPTS = 8
# the options that take a [B] uniform
_ONE_UNIFORM = frozenset((
    "random_horizontal_flip", "random_vertical_flip", "random_rotation90",
    "random_rgb_to_gray", "random_image_scale", "random_adjust_brightness",
    "random_adjust_contrast", "random_adjust_hue", "random_adjust_saturation",
))
_NO_DRAWS = frozenset((
    "normalize_image", "subtract_channel_mean", "resize_image", "random_resize_method",
    "scale_boxes_to_pixel_coordinates",
))


def draw_key(position: int) -> str:
    """The key of the option at `position` in a step's draws: options are
    keyed by position, so a pipeline that names one option twice draws
    each time anew (as mtlx's fold_in(rng, i))."""
    return f"aug_{position}"


def make_draws(name: str, kwargs: dict, batch_size: int, canvas_hw: Tuple[int, int],
               num_gt: int, generator: torch.Generator) -> Draws:
    """One option's draws for a batch on a (H, W) canvas with num_gt
    ground-truth slots, from `generator` on its device (module
    docstring)."""
    dev = generator.device
    height, width = canvas_hw

    def u(*shape):
        return torch.rand(shape, generator=generator, device=dev)

    def ints(high, *shape):
        return torch.randint(0, high, shape, generator=generator, device=dev)

    def pad():
        return torch.stack([ints(height + 1, batch_size), ints(width + 1, batch_size),
                            ints(height, batch_size), ints(width, batch_size)], dim=-1)

    def crop():
        return {"keep": u(batch_size), "windows": u(batch_size, NUM_ATTEMPTS, 4)}

    if name in _NO_DRAWS:
        return {}
    if name in _ONE_UNIFORM:
        return u(batch_size)
    if name == "random_distort_color":
        return u(batch_size, 4)
    if name == "random_jitter_boxes":
        return u(batch_size, num_gt, 4)
    if name == "random_pixel_value_scale":
        return u(batch_size, height, width, 3)
    if name == "random_black_patches":
        p = kwargs.get("max_black_patches", 10)
        size = _patch_size(kwargs.get("size_to_image_ratio", 0.1), height, width)
        return {"do": u(batch_size, p), "y": ints(max(height - size, 1), batch_size, p),
                "x": ints(max(width - size, 1), batch_size, p)}
    if name == "random_pad_image":
        return pad()
    if name in ("random_crop_image", "random_crop_to_aspect_ratio"):
        return crop()
    if name == "random_crop_pad_image":
        return {**crop(), "pad": pad()}
    if name in ("ssd_random_crop", "ssd_random_crop_pad", "ssd_random_crop_fixed_aspect_ratio"):
        keep_branch, ops = ssd_branches(kwargs.get("operations", ()))
        d = {**crop(), "branch": ints(len(ops) + keep_branch, batch_size)}
        if name == "ssd_random_crop_pad":
            d["pad"] = pad()
        return d
    raise ValueError(f"unimplemented preprocessing step {name!r}")


def batch_preprocess(sample: Dict[str, Tensor], options: List[Tuple[str, dict]],
                     draws: Dict[str, Draws]) -> Dict[str, Tensor]:
    """Apply (transform name, kwargs) steps in order; draws[draw_key(i)]
    holds the draws of the step at position i."""
    for i, (name, kwargs) in enumerate(options):
        fn = TRANSFORMS.get(name)
        if fn is None:
            raise ValueError(f"unimplemented preprocessing step {name!r}")
        sample = fn(sample, draws[draw_key(i)], **kwargs)
    return sample

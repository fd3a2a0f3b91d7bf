"""Host-side crop / pad geometry (port of mtlx/data/host_geometry.py).

With a keep_aspect_ratio_resizer the reference's crop / pad augmentations
change the image's final size and aspect ratio: it crops or pads the
decoded image and only then resizes it, so a tall crop of a landscape
photo trains at a tall shape. The device ops of data/preprocessor.py
resample onto the incoming canvas instead, so the train CLI hands these
options to the host when the resizer keeps the aspect:

  * the host draws the crop / pad geometry in numpy (from the boxes and
    the image's extent, no pixels), composes the op chain into one source
    window, applies the keep-aspect rule to the result and rewrites
    true_shape and the boxes; the bucket machinery then batches and
    computes at the real post-crop shape;
  * the device materializes the pixels with one bilinear window resample
    (preprocessor.batch_apply_host_window) in the train step.

Pixel values differ from the reference by one extra resample (the window
is cut from the already resized image); the geometry (final size, aspect,
boxes, coverage and rejection sampling) matches. The host ops run before
the device ones whatever their place in the options list: photometric
ops commute with geometry, flips in distribution. A sample's draws come
from the numpy Generator the caller passes (the loader seeds one for each
record visit).
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

from mtlx_torch.data.loader import keep_aspect_target
from mtlx_torch.geometry import np_box_ops
from mtlx_torch.utils.bucketing import bucket_multiple

# the options whose geometry (not pixels) this module draws
CROP_FAMILY = frozenset({
    "random_crop_image",
    "random_pad_image",
    "random_crop_pad_image",
    "random_crop_to_aspect_ratio",
    "ssd_random_crop",
    "ssd_random_crop_pad",
    "ssd_random_crop_fixed_aspect_ratio",
})

# the fields a sample gains for the device resample
AUG_FIELDS = ("aug_window", "aug_src_shape", "aug_pad_color", "aug_content")

# the SSD crops' default schedule after its keep branch (as
# preprocessor.SSD_DEFAULT_OPERATIONS)
_SSD_DEFAULT_OPERATIONS = tuple(
    dict(min_object_covered=t, min_aspect_ratio=0.5, max_aspect_ratio=2.0,
         min_area=0.1, max_area=1.0, overlap_thresh=t, random_coef=0.0)
    for t in (0.1, 0.3, 0.5, 0.7, 0.9, 0.0)
)

_CROP_KEYS = ("min_object_covered", "min_aspect_ratio", "max_aspect_ratio",
              "min_area", "max_area", "overlap_thresh", "random_coef")


def split_host_geometry(aug_options, resizer):
    """(host geometry ops, device ops) of the builder's options: the crop /
    pad family goes to the host only with a keep-aspect resizer; with a
    fixed one the device path is exact and keeps every option."""
    kind = resizer[0] if isinstance(resizer, tuple) else resizer
    if kind != "keep_aspect":
        return [], list(aug_options)
    host = [(n, kw) for n, kw in aug_options if n in CROP_FAMILY]
    device = [(n, kw) for n, kw in aug_options if n not in CROP_FAMILY]
    return host, device


class _Frame:
    """The geometry threaded through the op chain: the frame's extent, its
    origin in source-canvas coordinates (crops and pads only translate),
    the ground truth in frame coordinates, the pad colour, and the source
    pixels still visible (a crop discards what lies outside its window: a
    later pad fills that area with the pad colour)."""

    def __init__(self, h: float, w: float, boxes: np.ndarray, valid: np.ndarray):
        self.h = float(h)
        self.w = float(w)
        self.oy = 0.0
        self.ox = 0.0
        self.boxes = boxes.astype(np.float64).copy()
        self.valid = valid.copy()
        self.pad_color: Tuple[float, float, float] = (0.0, 0.0, 0.0)
        self.pad_color_set = False
        self.content = np.asarray([0.0, 0.0, float(h), float(w)])


def _crop(frame: _Frame, rng, min_object_covered=1.0, min_aspect_ratio=0.75,
          max_aspect_ratio=1.33, min_area=0.1, max_area=1.0,
          overlap_thresh=0.3, random_coef=0.0, num_attempts=8) -> None:
    """random_crop_image's sampler (tf.image.sample_distorted_bounding_box's
    rule): draw num_attempts windows, take the first that covers
    min_object_covered of some box, keep the frame when none does (or with
    probability random_coef)."""
    if random_coef > 0.0 and rng.random() < random_coef:
        return
    th, tw = frame.h, frame.w
    window = None
    vboxes = frame.boxes[frame.valid]
    for _ in range(num_attempts):
        area_frac = rng.uniform(min_area, max_area)
        aspect = rng.uniform(min_aspect_ratio, max_aspect_ratio)
        h = math.sqrt(area_frac * th * tw / aspect)
        w = h * aspect
        h, w = min(h, th), min(w, tw)
        y = rng.random() * (th - h)
        x = rng.random() * (tw - w)
        cand = np.asarray([y, x, y + h, x + w])
        if min_object_covered > 0.0 and len(vboxes):
            cover = np_box_ops.ioa(cand[None, :], vboxes)[0]
            if not np.any(cover >= min_object_covered):
                continue
        window = cand
        break
    if window is None:
        return  # TF's max_attempts fallback: the frame stays
    y0, x0, y1, x1 = window
    ioa = np_box_ops.ioa(window[None, :], frame.boxes)[0]
    keep = ioa >= overlap_thresh
    clipped = np_box_ops.clip_to_window(frame.boxes, window)
    frame.boxes = clipped - np.asarray([y0, x0, y0, x0])
    frame.valid = frame.valid & keep
    c = frame.content
    frame.content = np.asarray([
        max(c[0], frame.oy + y0), max(c[1], frame.ox + x0),
        min(c[2], frame.oy + y1), min(c[3], frame.ox + x1),
    ])
    frame.content[2] = max(frame.content[2], frame.content[0])
    frame.content[3] = max(frame.content[3], frame.content[1])
    frame.oy += y0
    frame.ox += x0
    frame.h, frame.w = y1 - y0, x1 - x0


def _pad(frame: _Frame, rng, src_scale: float, min_image_height=0,
         min_image_width=0, max_image_height=0, max_image_width=0,
         pad_color=(), min_size_ratio=(), max_size_ratio=()) -> None:
    """Grow the frame (the reference's random_pad_image): a size uniform in
    [min, max] (by default up to twice the frame), the content at a
    uniform offset. The absolute bounds are in original pixels (src_scale
    converts them); the frame is not clamped to the canvas, the keep-aspect
    rule rescales it afterwards."""
    th, tw = frame.h, frame.w
    min_h = max(th, float(min_image_height) * src_scale)
    min_w = max(tw, float(min_image_width) * src_scale)
    max_h = float(max_image_height) * src_scale if max_image_height else 2 * th
    max_w = float(max_image_width) * src_scale if max_image_width else 2 * tw
    if len(min_size_ratio) == 2:
        min_h = max(min_h, min_size_ratio[0] * th)
        min_w = max(min_w, min_size_ratio[1] * tw)
    if len(max_size_ratio) == 2:
        max_h = min(max_h, max_size_ratio[0] * th)
        max_w = min(max_w, max_size_ratio[1] * tw)
    new_h = rng.uniform(min_h, max(max_h, min_h))
    new_w = rng.uniform(min_w, max(max_w, min_w))
    top = rng.random() * (new_h - th)
    left = rng.random() * (new_w - tw)
    frame.boxes = frame.boxes + np.asarray([top, left, top, left])
    frame.oy -= top
    frame.ox -= left
    frame.h, frame.w = new_h, new_w
    if len(pad_color) == 3 and not frame.pad_color_set:
        frame.pad_color = tuple(float(c) for c in pad_color)
        frame.pad_color_set = True


def _crop_pad(frame, rng, src_scale, min_padded_size_ratio=(),
              max_padded_size_ratio=(), pad_color=(), **crop_kw) -> None:
    _crop(frame, rng, **{k: crop_kw[k] for k in _CROP_KEYS if k in crop_kw})
    _pad(frame, rng, src_scale, pad_color=tuple(pad_color),
         min_size_ratio=tuple(min_padded_size_ratio),
         max_size_ratio=tuple(max_padded_size_ratio))


def _crop_to_aspect_ratio(frame, rng, aspect_ratio=1.0, overlap_thresh=0.3) -> None:
    _crop(frame, rng, min_object_covered=0.0,
          min_aspect_ratio=aspect_ratio, max_aspect_ratio=aspect_ratio,
          min_area=0.95, max_area=1.0, overlap_thresh=overlap_thresh)


def _ssd_branch(frame, rng, src_scale, operations, fixed_aspect=None,
                with_pad=False) -> None:
    keep = not operations
    ops = tuple(operations) or _SSD_DEFAULT_OPERATIONS
    n = len(ops) + (1 if keep else 0)
    idx = int(rng.integers(n))
    if keep and idx == 0:
        return
    op = dict(ops[idx - 1 if keep else idx])
    if fixed_aspect is not None:
        op["min_aspect_ratio"] = fixed_aspect
        op["max_aspect_ratio"] = fixed_aspect
    if with_pad:
        _crop_pad(frame, rng, src_scale, **op)
    else:
        _crop(frame, rng, **{k: op[k] for k in _CROP_KEYS if k in op})


class HostGeometry:
    """Applies a chain of crop / pad-family ops to one loader sample
    (numpy, pixels untouched): rewrites true_shape and the boxes to the
    post-augmentation keep-aspect shape and attaches the window the device
    resample materializes (the AUG_FIELDS) and `pack_shape`, the extent of
    pixels the resample reads and writes."""

    def __init__(self, ops: Sequence[Tuple[str, dict]], min_dimension: int,
                 max_dimension: int, canvas_size: Tuple[int, int]):
        unknown = [n for n, _ in ops if n not in CROP_FAMILY]
        if unknown:
            raise ValueError(f"not host-geometry ops: {unknown}")
        self.ops = list(ops)
        self.min_dimension = int(min_dimension)
        self.max_dimension = int(max_dimension)
        self.canvas_size = tuple(canvas_size)

    def __call__(self, sample: Dict[str, np.ndarray],
                 rng: np.random.Generator) -> Dict[str, np.ndarray]:
        pre_h, pre_w = int(sample["true_shape"][0]), int(sample["true_shape"][1])
        orig = sample.get("original_shape")
        src_scale = pre_h / float(orig[0]) if orig is not None else 1.0
        frame = _Frame(pre_h, pre_w, sample["gt_boxes"], sample["gt_mask"])
        for name, kw in self.ops:  # the ops share the one stream, in order
            if name == "random_crop_image":
                _crop(frame, rng, **kw)
            elif name == "random_pad_image":
                _pad(frame, rng, src_scale, **kw)
            elif name == "random_crop_pad_image":
                _crop_pad(frame, rng, src_scale, **kw)
            elif name == "random_crop_to_aspect_ratio":
                _crop_to_aspect_ratio(frame, rng, **kw)
            elif name == "ssd_random_crop":
                _ssd_branch(frame, rng, src_scale, kw.get("operations", ()))
            elif name == "ssd_random_crop_pad":
                _ssd_branch(frame, rng, src_scale, kw.get("operations", ()), with_pad=True)
            else:  # ssd_random_crop_fixed_aspect_ratio (__init__ admits no other)
                _ssd_branch(frame, rng, src_scale, kw.get("operations", ()),
                            fixed_aspect=kw.get("aspect_ratio", 1.0))

        fh, fw = keep_aspect_target(frame.h, frame.w, self.min_dimension, self.max_dimension)
        ch, cw = self.canvas_size
        fh, fw = min(fh, ch), min(fw, cw)
        sy, sx = fh / frame.h, fw / frame.w
        out = dict(sample)
        out["true_shape"] = np.asarray([fh, fw], np.int32)
        out["gt_boxes"] = (frame.boxes * np.asarray([sy, sx, sy, sx])).astype(np.float32)
        out["gt_mask"] = frame.valid
        if "gt_keypoints" in sample:
            # the crops and pads only move the frame's origin, so it maps
            # the keypoints; a point outside the final frame, or whose
            # source lies outside the content every crop of the chain kept,
            # becomes NaN (keypoint_ops.prune_outside_window)
            src_kp = sample["gt_keypoints"].astype(np.float64)
            kp = (src_kp - np.asarray([frame.oy, frame.ox])) * np.asarray([sy, sx])
            c = frame.content
            inside = ((kp[..., 0] >= 0) & (kp[..., 0] <= fh)
                      & (kp[..., 1] >= 0) & (kp[..., 1] <= fw)
                      & (src_kp[..., 0] >= c[0]) & (src_kp[..., 0] <= c[2])
                      & (src_kp[..., 1] >= c[1]) & (src_kp[..., 1] <= c[3]))
            out["gt_keypoints"] = np.where(inside[..., None], kp, np.nan).astype(np.float32)
        # gt_instance_masks pass through: they stay on the source canvas (at
        # mask_stride resolution) and the train step resamples them through
        # the image's window (train.make_augmented_batch_fn)
        out["aug_window"] = np.asarray(
            [frame.oy, frame.ox, frame.oy + frame.h, frame.ox + frame.w], np.float32)
        out["aug_src_shape"] = np.asarray([pre_h, pre_w], np.int32)
        out["aug_pad_color"] = np.asarray(frame.pad_color, np.float32)
        out["aug_content"] = frame.content.astype(np.float32)
        # the pixels to ship: the resample reads up to window ∩ content (taps
        # outside the content read the pad colour) and writes the output's
        # true region; the batch packs over the largest
        read_h = max(0.0, min(frame.oy + frame.h, frame.content[2]))
        read_w = max(0.0, min(frame.ox + frame.w, frame.content[3]))
        out["pack_shape"] = np.asarray(
            [min(ch, max(fh, math.ceil(read_h))), min(cw, max(fw, math.ceil(read_w)))],
            np.int32)
        return out

    def achievable_post_buckets(self, multiple: int = 0) -> List[Tuple[int, int]]:
        """Every bucket shape the post-augmentation keep-aspect rule can
        give: the final shape is a function of the augmented aspect ratio
        alone, so a dense sweep of aspects finds the finite set."""
        multiple = bucket_multiple(multiple)
        ch, cw = self.canvas_size
        shapes = set()
        for a in np.geomspace(0.05, 20.0, 4096):
            fh, fw = keep_aspect_target(1000.0, 1000.0 * a, self.min_dimension,
                                        self.max_dimension)
            shapes.add((min(ch, -(-min(fh, ch) // multiple) * multiple),
                        min(cw, -(-min(fw, cw) // multiple) * multiple)))
        return sorted(shapes)

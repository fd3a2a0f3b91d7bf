"""preprocessor_builder — PreprocessingStep protos -> (name, kwargs) list
(port of mtlx/builders/preprocessor_builder.py): every step of mtlx's
data/preprocessor.py TRANSFORMS, with the same kwargs."""

from __future__ import annotations

from typing import List, Tuple

# the proto fields each step passes on as kwargs (mtlx's _FIELD_MAPS)
_FIELD_MAPS = {
    "normalize_image": (
        "original_minval", "original_maxval", "target_minval", "target_maxval",
    ),
    "random_horizontal_flip": (),
    "random_vertical_flip": (),
    "random_pixel_value_scale": ("minval", "maxval"),
    "random_rgb_to_gray": ("probability",),
    "random_adjust_brightness": ("max_delta",),
    "random_adjust_contrast": ("min_delta", "max_delta"),
    "random_adjust_hue": ("max_delta",),
    "random_adjust_saturation": ("min_delta", "max_delta"),
    "random_distort_color": ("color_ordering",),
    "random_jitter_boxes": ("ratio",),
    "random_crop_image": (
        "min_object_covered", "min_aspect_ratio", "max_aspect_ratio",
        "min_area", "max_area", "overlap_thresh", "random_coef",
    ),
    "random_black_patches": (
        "max_black_patches", "probability", "size_to_image_ratio",
    ),
    "subtract_channel_mean": ("means",),
    "ssd_random_crop": (),
    "ssd_random_crop_pad": (),
    "ssd_random_crop_fixed_aspect_ratio": ("aspect_ratio",),
    "random_rotation90": (),
    "random_image_scale": ("min_scale_ratio", "max_scale_ratio"),
    "random_pad_image": (
        "min_image_height", "min_image_width",
        "max_image_height", "max_image_width", "pad_color",
    ),
    "random_crop_pad_image": (
        "min_object_covered", "min_aspect_ratio", "max_aspect_ratio",
        "min_area", "max_area", "overlap_thresh", "random_coef",
        "min_padded_size_ratio", "max_padded_size_ratio", "pad_color",
    ),
    "random_crop_to_aspect_ratio": ("aspect_ratio", "overlap_thresh"),
    "random_resize_method": ("target_height", "target_width"),
    "resize_image": ("new_height", "new_width", "method"),
    "scale_boxes_to_pixel_coordinates": (),
}

# the crop fields of each of an SSD crop's operations
_SSD_OP_CROP_FIELDS = (
    "min_object_covered", "min_aspect_ratio", "max_aspect_ratio",
    "min_area", "max_area", "overlap_thresh", "random_coef",
)


def _ssd_operations(sub, with_pad: bool):
    """The SSD crop's operations as kwargs dicts (none: the preprocessor's
    default 7-way schedule); with_pad adds each one's pad-size ratios and
    colour."""
    ops = []
    for op in sub.operations:
        d = {f: getattr(op, f) for f in _SSD_OP_CROP_FIELDS}
        if with_pad:
            d["min_padded_size_ratio"] = tuple(op.min_padded_size_ratio)
            d["max_padded_size_ratio"] = tuple(op.max_padded_size_ratio)
            d["pad_color"] = (op.pad_color_r, op.pad_color_g, op.pad_color_b)
        ops.append(d)
    return tuple(ops)


def build_step(step_proto) -> Tuple[str, dict]:
    which = step_proto.WhichOneof("preprocessing_step")
    if which is None:
        raise ValueError("empty preprocessing step")
    if which not in _FIELD_MAPS:
        raise ValueError(f"preprocessing step {which!r} is declared in the config schema but "
                         "not implemented in mtlx_torch.data.preprocessor")
    sub = getattr(step_proto, which)
    kwargs = {}
    for field in _FIELD_MAPS[which]:
        value = getattr(sub, field)
        if hasattr(value, "__len__") and not isinstance(value, str):
            value = tuple(value)
        kwargs[field] = value
    if which in ("ssd_random_crop", "ssd_random_crop_fixed_aspect_ratio"):
        kwargs["operations"] = _ssd_operations(sub, with_pad=False)
    elif which == "ssd_random_crop_pad":
        kwargs["operations"] = _ssd_operations(sub, with_pad=True)
    return which, kwargs


def build(steps) -> List[Tuple[str, dict]]:
    return [build_step(s) for s in steps]

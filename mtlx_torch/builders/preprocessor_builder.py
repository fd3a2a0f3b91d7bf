"""preprocessor_builder — PreprocessingStep protos -> (name, kwargs) list
(port of mtlx/builders/preprocessor_builder.py). The port's device-side
augmentation (`data/preprocessor.py`) has `random_horizontal_flip` (the
flagship's one option) and `ssd_random_crop` (the SSD configs'); every
other step raises naming itself."""

from __future__ import annotations

from typing import List, Tuple

from mtlx_torch.data.preprocessor import TRANSFORMS

# the proto fields each ported step passes on as kwargs (mtlx's _FIELD_MAPS)
_FIELD_MAPS = {"random_horizontal_flip": (), "ssd_random_crop": ()}
# the crop / pad options, which a keep_aspect_ratio_resizer moves to the host
# (mtlx/data/host_geometry.py CROP_FAMILY)
CROP_FAMILY = frozenset((
    "random_crop_image", "random_pad_image", "random_crop_pad_image",
    "random_crop_to_aspect_ratio", "ssd_random_crop", "ssd_random_crop_pad",
    "ssd_random_crop_fixed_aspect_ratio",
))
# the crop fields of each of an SSDRandomCrop's operations
_SSD_OP_CROP_FIELDS = (
    "min_object_covered", "min_aspect_ratio", "max_aspect_ratio",
    "min_area", "max_area", "overlap_thresh", "random_coef",
)


def build_step(step_proto) -> Tuple[str, dict]:
    which = step_proto.WhichOneof("preprocessing_step")
    if which is None:
        raise ValueError("empty preprocessing step")
    if which not in _FIELD_MAPS or which not in TRANSFORMS:
        raise NotImplementedError(
            f"augmentation {which!r} is not ported: ROADMAP.md queue 1 item 11 "
            "(the other device-side augmentations)"
        )
    sub = getattr(step_proto, which)
    kwargs = {}
    for field in _FIELD_MAPS[which]:
        value = getattr(sub, field)
        if isinstance(value, list):
            value = tuple(value)
        kwargs[field] = value
    if which == "ssd_random_crop":
        # no operations: the preprocessor's default 7-way schedule
        kwargs["operations"] = tuple({f: getattr(op, f) for f in _SSD_OP_CROP_FIELDS}
                                     for op in sub.operations)
    return which, kwargs


def build(steps) -> List[Tuple[str, dict]]:
    return [build_step(s) for s in steps]

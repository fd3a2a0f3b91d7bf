"""preprocessor_builder — PreprocessingStep protos -> (name, kwargs) list
(port of mtlx/builders/preprocessor_builder.py). The port's device-side
augmentation (`data/preprocessor.py`) has `random_horizontal_flip` only,
the flagship's one option; every other step raises naming itself."""

from __future__ import annotations

from typing import List, Tuple

from mtlx_torch.data.preprocessor import TRANSFORMS

# the proto fields each ported step passes on as kwargs (mtlx's _FIELD_MAPS)
_FIELD_MAPS = {"random_horizontal_flip": ()}


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
    return which, kwargs


def build(steps) -> List[Tuple[str, dict]]:
    return [build_step(s) for s in steps]

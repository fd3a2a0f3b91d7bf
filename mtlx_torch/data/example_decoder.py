"""tf.train.Example encode/decode for detection records (port of
mtlx/data/example_decoder.py), on the port's own wire-format code
(`config/text_format.py`): no protobuf.

An Example is `features` (field 1) holding a map of feature name ->
Feature, each one of bytes_list (1), float_list (2, packed float32) or
int64_list (3, packed varints). `decode_example` returns mtlx's
InputDataFields dict (numpy); `build_example` writes the reference's
feature keys.
"""

from __future__ import annotations

import struct
from typing import Dict, List, Tuple

import numpy as np

from mtlx_torch.config.text_format import (
    WIRE_BYTES,
    WIRE_FIXED32,
    iter_fields,
    read_varint,
    signed64,
    write_bytes_field,
    write_varint,
)


class InputDataFields:
    image = "image"
    image_encoded = "image_encoded"
    image_format = "image_format"
    source_id = "source_id"
    groundtruth_boxes = "groundtruth_boxes"
    groundtruth_classes = "groundtruth_classes"
    groundtruth_difficult = "groundtruth_difficult"
    groundtruth_truncated = "groundtruth_truncated"
    groundtruth_group_of = "groundtruth_group_of"
    groundtruth_instance_masks = "groundtruth_instance_masks"
    groundtruth_keypoints = "groundtruth_keypoints"
    original_shape = "original_shape"


# ---------------------------------------------------------------- decode


def _parse_feature(buf, copy: bool = True) -> Tuple[str, object]:
    """('bytes', [bytes]) | ('float', float32 array) | ('int64', int64 array);
    with copy false the bytes values are memoryview slices of `buf`."""
    kind, payload = None, None
    for number, _, value in iter_fields(buf):
        kind, payload = number, value
    if kind == 1:
        return "bytes", [bytes(v) if copy else v for n, w, v in iter_fields(payload) if n == 1]
    if kind == 2:
        parts = []
        for n, wire, v in iter_fields(payload):
            if n != 1:
                continue
            if wire == WIRE_BYTES:  # packed
                parts.append(np.frombuffer(v, "<f4"))
            elif wire == WIRE_FIXED32:
                parts.append(np.frombuffer(struct.pack("<I", v), "<f4"))
        return "float", (np.concatenate(parts).astype(np.float32) if parts
                         else np.zeros((0,), np.float32))
    if kind == 3:
        values: List[int] = []
        for n, wire, v in iter_fields(payload):
            if n != 1:
                continue
            if wire == WIRE_BYTES:  # packed
                pos = 0
                while pos < len(v):
                    x, pos = read_varint(v, pos)
                    values.append(signed64(x))
            else:
                values.append(signed64(v))
        return "int64", np.asarray(values, np.int64)
    return "none", None


def parse_features(serialized: bytes) -> Dict[str, Tuple[str, object]]:
    """name -> (kind, values) of every feature of a serialized Example. A
    memoryview in gives its bytes values as slices of it (no copy)."""
    copy = not isinstance(serialized, memoryview)
    out = {}
    for number, _, features in iter_fields(serialized):
        if number != 1:
            continue
        for n, _, entry in iter_fields(features):
            if n != 1:
                continue
            key, value = "", b""
            for n2, _, v2 in iter_fields(entry):
                if n2 == 1:
                    key = bytes(v2).decode()
                elif n2 == 2:
                    value = v2
            out[key] = _parse_feature(value, copy)
    return out


def _floats(fmap, key):
    kind, v = fmap.get(key, (None, None))
    return v if kind == "float" else np.zeros((0,), np.float32)


def _ints(fmap, key):
    kind, v = fmap.get(key, (None, None))
    return v if kind == "int64" else np.zeros((0,), np.int64)


def _bytes(fmap, key):
    kind, v = fmap.get(key, (None, None))
    return v if kind == "bytes" else []


def decode_example(serialized: bytes, decode_image: bool = True,
                   load_instance_masks: bool = False,
                   return_encoded: bool = False) -> Dict:
    """Parse one serialized Example -> InputDataFields dict (numpy), as
    mtlx's decode_example does. groundtruth_classes stay 1-based as
    stored. decode_image decodes `image/encoded` by its `image/format`
    (data/imgcodec.py). Given a memoryview, the encoded image comes back
    as a slice of it, not a copy. load_instance_masks decodes the
    per-instance PNGs of `image/object/mask` into an [N, h, w] float32
    0 / 1 array (a pixel is 1 where its luma is above 0, as mtlx's PIL
    convert('L') > 0)."""
    fmap = parse_features(serialized)
    out: Dict = {}
    ymin = _floats(fmap, "image/object/bbox/ymin")
    xmin = _floats(fmap, "image/object/bbox/xmin")
    ymax = _floats(fmap, "image/object/bbox/ymax")
    xmax = _floats(fmap, "image/object/bbox/xmax")
    out[InputDataFields.groundtruth_boxes] = np.stack(
        [ymin, xmin, ymax, xmax], axis=1
    ) if len(ymin) else np.zeros((0, 4), np.float32)
    out[InputDataFields.groundtruth_classes] = _ints(fmap, "image/object/class/label")
    out[InputDataFields.groundtruth_difficult] = _ints(fmap, "image/object/difficult")
    out[InputDataFields.groundtruth_truncated] = _ints(fmap, "image/object/truncated")
    out[InputDataFields.groundtruth_group_of] = _ints(fmap, "image/object/group_of")
    if "image/source_id" in fmap:
        out[InputDataFields.source_id] = bytes(_bytes(fmap, "image/source_id")[0]).decode()
    h = _ints(fmap, "image/height")
    w = _ints(fmap, "image/width")
    out[InputDataFields.original_shape] = (
        int(h[0]) if len(h) else -1,
        int(w[0]) if len(w) else -1,
    )
    encoded = _bytes(fmap, "image/encoded")
    fmt = [bytes(f) for f in _bytes(fmap, "image/format")]
    if decode_image and encoded:
        from mtlx_torch.data import imgcodec

        f = fmt[0] if fmt else b"jpeg"
        th, tw = imgcodec.image_dims(encoded[0], f)
        out[InputDataFields.image] = imgcodec.decode_resized(encoded[0], f, th, tw)
    if return_encoded and encoded:
        out[InputDataFields.image_encoded] = encoded[0]
        if fmt:
            out[InputDataFields.image_format] = fmt[0]
    ky = _floats(fmap, "image/object/keypoint/y")
    if len(ky):
        kx = _floats(fmap, "image/object/keypoint/x")
        n = len(out[InputDataFields.groundtruth_classes])
        p = len(ky) // max(n, 1)
        out[InputDataFields.groundtruth_keypoints] = np.stack(
            [ky, kx], axis=-1
        ).reshape(n, p, 2)
    if load_instance_masks and "image/object/mask" in fmap:
        from mtlx_torch.data import imgcodec

        masks = [(imgcodec.decode_png_luma(b) > 0).astype(np.float32)
                 for b in _bytes(fmap, "image/object/mask")]
        out[InputDataFields.groundtruth_instance_masks] = (
            np.stack(masks) if masks else np.zeros((0, 1, 1), np.float32))
    return out


# ---------------------------------------------------------------- encode


def _feature(kind: int, payload: bytes) -> bytes:
    out = bytearray()
    write_bytes_field(out, kind, payload)
    return bytes(out)


def bytes_list_feature(values) -> bytes:
    inner = bytearray()
    for v in values:
        write_bytes_field(inner, 1, v)
    return _feature(1, inner)


def bytes_feature(value: bytes) -> bytes:
    return bytes_list_feature([value])


def float_list_feature(values) -> bytes:
    inner = bytearray()
    packed = np.asarray(values, "<f4").tobytes()
    if packed:
        write_bytes_field(inner, 1, packed)
    return _feature(2, inner)


def int64_list_feature(values) -> bytes:
    inner = bytearray()
    packed = bytearray()
    for v in values:
        write_varint(packed, int(v))
    if packed:
        write_bytes_field(inner, 1, packed)
    return _feature(3, inner)


def serialize_example(features: Dict[str, bytes]) -> bytes:
    """A serialized Example from name -> serialized Feature, in the dict's
    order."""
    fmap = bytearray()
    for key, feature in features.items():
        entry = bytearray()
        write_bytes_field(entry, 1, key.encode())
        write_bytes_field(entry, 2, feature)
        write_bytes_field(fmap, 1, entry)
    out = bytearray()
    write_bytes_field(out, 1, fmap)
    return bytes(out)


def build_example(
    encoded_image: bytes,
    image_format: bytes,
    height: int,
    width: int,
    filename: str,
    boxes_norm: np.ndarray,  # [N, 4] ymin,xmin,ymax,xmax normalized
    class_labels,  # [N] 1-based ids
    class_texts,  # [N] names
    difficult=None,
    truncated=None,
    group_of=None,
    poses=None,
    instance_masks=None,  # optional [N] list of [h, w] 0 / 1 arrays
    keypoints=None,  # optional [N, P, 2] normalized (y, x)
) -> bytes:
    """One serialized Example with the reference's feature keys (mtlx's
    build_example, which returns the message; this returns its bytes).
    Instance masks go under `image/object/mask` as one 8-bit gray PNG
    each (0 / 255), the TF OD API's PNG-masks format."""
    n = len(class_labels)
    difficult = difficult if difficult is not None else [0] * n
    truncated = truncated if truncated is not None else [0] * n
    poses = poses if poses is not None else [b"Unspecified"] * n
    f = {
        "image/height": int64_list_feature([height]),
        "image/width": int64_list_feature([width]),
        "image/filename": bytes_feature(filename.encode()),
        "image/source_id": bytes_feature(filename.encode()),
        "image/encoded": bytes_feature(encoded_image),
        "image/format": bytes_feature(image_format),
    }
    if n:
        boxes_norm = np.asarray(boxes_norm, np.float32)
        f["image/object/bbox/ymin"] = float_list_feature(boxes_norm[:, 0])
        f["image/object/bbox/xmin"] = float_list_feature(boxes_norm[:, 1])
        f["image/object/bbox/ymax"] = float_list_feature(boxes_norm[:, 2])
        f["image/object/bbox/xmax"] = float_list_feature(boxes_norm[:, 3])
        f["image/object/class/text"] = bytes_list_feature(
            [t.encode() if isinstance(t, str) else t for t in class_texts])
        f["image/object/class/label"] = int64_list_feature(class_labels)
        f["image/object/difficult"] = int64_list_feature(difficult)
        f["image/object/truncated"] = int64_list_feature(truncated)
        if group_of is not None:
            f["image/object/group_of"] = int64_list_feature(group_of)
        f["image/object/view"] = bytes_list_feature(poses)
        if instance_masks is not None:
            from mtlx_torch.data import imgcodec

            f["image/object/mask"] = bytes_list_feature(
                [imgcodec.encode_png((np.asarray(m) > 0).astype(np.uint8) * 255)
                 for m in instance_masks])
        if keypoints is not None:
            kp = np.asarray(keypoints, np.float32)
            f["image/object/keypoint/y"] = float_list_feature(kp[..., 0].reshape(-1))
            f["image/object/keypoint/x"] = float_list_feature(kp[..., 1].reshape(-1))
    return serialize_example(f)

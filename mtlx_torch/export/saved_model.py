"""Serve the program that `exporter.export_saved_model` wrote (the port of
mtlx's TF SavedModel and its three signatures).

    sm = load_saved_model("<output_directory>/saved_model")   # on the card
    out = sm.signatures["serving_default"](images, true_shape)
    out = sm.signatures["encoded_image_string"]([jpeg_or_png_bytes, ...])
    out = sm.signatures["tf_example"]([serialized_example, ...])

`model.pt2` is a `torch.export` program: the eval-mode detector with its
weights frozen in, the kernels called as the `mtlx::` ops of
`kernels/ops.py`, a dynamic batch and a fixed canvas. It is the graph and
its frozen weights in one file; mtlx's `frozen_inference_graph.pb` (a
GraphDef for TF1 sessions) has no counterpart. The program bakes in the
device it was exported on, so it is served there: `load_saved_model`
raises when asked for another device.

The signatures are mtlx's (`mtlx/export/exporter.py` `export_saved_model`):

  * `serving_default` / `image_tensor(images, true_shape=None)`: uint8
    [B, ch, cw, 3] images on the model canvas and their int32 [B, 2] true
    (pre-padding) sizes, the whole canvas where not given;
  * `encoded_image_string(blobs)`: JPEG or PNG bytes, each decoded at full
    size, resized onto its resizer target with the TF1 `resize_images`
    bilinear (align_corners=False), rounded by floor(x + 0.5), clipped to
    the canvas and padded onto it at the top left;
  * `tf_example(serialized)`: serialized tf.train.Examples, whose one
    `image/encoded` value takes the encoded path.

Torch has no in-graph image decode, so the encoded signatures decode on
the host with the port's codec (`data/imgcodec.py`) and compute what
mtlx's graph computes, as TF's ops do it. Each signature returns numpy
arrays: detection_boxes (normalized to the true image), detection_scores,
detection_classes (1-based, float32) and num_detections (float32).

The module imports no detector, backbone, head or builder: a serving
process needs torch, numpy, the ops, the host codec and the Example
parser.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mtlx_torch.data import imgcodec
from mtlx_torch.data.example_decoder import parse_features
from mtlx_torch.device import DeviceLike, resolve_device
from mtlx_torch.kernels import ops  # noqa: F401  registers torch.ops.mtlx.*

PROGRAM_FILE = "model.pt2"
# the serving facts the host side needs, kept inside the .pt2
META_FILE = "mtlx_serving.json"
FORMAT = "mtlx_torch-pt2-v1"
SIGNATURES = ("serving_default", "image_tensor", "encoded_image_string", "tf_example")
OUTPUTS = ("detection_boxes", "detection_scores", "detection_classes", "num_detections")
_JPEG_SIGNATURE = b"\xff\xd8\xff"
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def keep_aspect_target(h: int, w: int, min_dimension: int, max_dimension: int) -> Tuple[int, int]:
    """The keep-aspect target of mtlx's serving graph: the scale in float64,
    each side rounded half to even (`tf.round`)."""
    scale = min(min_dimension / float(min(h, w)), max_dimension / float(max(h, w)))
    return int(np.round(h * scale)), int(np.round(w * scale))


def resize_images_tf1(image: np.ndarray, th: int, tw: int) -> np.ndarray:
    """float32 [th, tw, C]: TF's `compat.v1.image.resize_images` bilinear with
    align_corners=False on one image, in TF's float32 arithmetic (the scale
    in / out and each source coordinate i * scale in float32; the lower
    tap floor, the upper tap ceil clipped to the last row or column; the
    two x-blends, then the y-blend, each a + (b - a) * t). At the image's
    own size every weight is 0 and the result is the image."""
    h, w = image.shape[:2]

    def axis(out: int, size: int):
        scale = np.float32(size) / np.float32(out)
        src = np.arange(out, dtype=np.float32) * scale
        low = np.floor(src)
        lo = np.maximum(low.astype(np.int64), 0)
        hi = np.minimum(np.ceil(src).astype(np.int64), size - 1)
        return lo, hi, src - low

    y0, y1, ty = axis(th, h)
    x0, x1, tx = axis(tw, w)
    tx = tx[None, :, None]

    def x_blend(rows: np.ndarray) -> np.ndarray:
        rows = rows.astype(np.float32)
        left = rows[:, x0]
        return left + (rows[:, x1] - left) * tx

    top = x_blend(image[y0])
    return top + (x_blend(image[y1]) - top) * ty[:, None, None]


def decode_image(blob: bytes) -> np.ndarray:
    """[h, w, 3] uint8 at the image's own size, as `tf.io.decode_image(blob,
    channels=3)` decodes a JPEG or a PNG; other bytes raise."""
    head = bytes(blob[:8])
    if head.startswith(_JPEG_SIGNATURE):
        return imgcodec.decode_jpeg_tf(blob)
    if head == _PNG_SIGNATURE:
        return imgcodec.decode_png(blob)
    raise ValueError(f"an encoded image is neither a JPEG nor a PNG (it begins with {head!r})")


def canvas_of(image: np.ndarray, resizer, canvas: Tuple[int, int]):
    """(uint8 [ch, cw, 3], int32 [2]): a decoded image resized onto its
    target, clipped and padded onto the canvas, and its true size (mtlx's
    `_decode_resize_pad`)."""
    kind, params = resizer
    if kind == "fixed":
        th, tw = int(params["height"]), int(params["width"])
    else:
        th, tw = keep_aspect_target(*image.shape[:2], **params)
    fit_h, fit_w = min(th, canvas[0]), min(tw, canvas[1])
    out = np.zeros((*canvas, 3), np.uint8)
    if (th, tw) == image.shape[:2]:  # the resize and the rounding give the image back
        out[:fit_h, :fit_w] = image[:fit_h, :fit_w]
    else:
        resized = resize_images_tf1(image, th, tw)[:fit_h, :fit_w]
        out[:fit_h, :fit_w] = np.floor(resized + np.float32(0.5))
    return out, np.asarray([fit_h, fit_w], np.int32)


def encoded_image(serialized: bytes) -> bytes:
    """The one `image/encoded` value of a serialized tf.train.Example (what
    `tf.io.parse_example` with a scalar FixedLenFeature reads)."""
    kind, values = parse_features(serialized).get("image/encoded", (None, None))
    if kind != "bytes" or len(values) != 1:
        raise ValueError("a tf.train.Example without exactly one image/encoded value")
    return values[0]


class SavedModel:
    """A loaded program and mtlx's signatures around it."""

    def __init__(self, program: torch.export.ExportedProgram, meta: Dict, device: torch.device):
        self.module = program.module()
        self.meta = meta
        self.device = device
        self.canvas = tuple(meta["canvas"])
        self.resizer = (meta["resizer"][0], meta["resizer"][1])
        self.signatures = {"serving_default": self.image_tensor,
                           "image_tensor": self.image_tensor,
                           "encoded_image_string": self.encoded_image_string,
                           "tf_example": self.tf_example}

    def image_tensor(self, images, true_shape=None) -> Dict[str, np.ndarray]:
        """uint8 [B, ch, cw, 3] on the canvas, int32 [B, 2] true sizes."""
        images = torch.as_tensor(np.ascontiguousarray(images))
        if images.dtype != torch.uint8 or images.dim() != 4 or (
                tuple(images.shape[1:]) != (*self.canvas, 3)):
            raise ValueError(f"want uint8 images [B, {self.canvas[0]}, {self.canvas[1]}, 3], got "
                             f"{images.dtype} {tuple(images.shape)}")
        if true_shape is None:
            true_shape = np.tile(np.asarray(self.canvas, np.int32), (images.shape[0], 1))
        true_shape = torch.as_tensor(np.asarray(true_shape, np.int32))
        if tuple(true_shape.shape) != (images.shape[0], 2):
            raise ValueError(f"want true_shape [{images.shape[0]}, 2], got "
                             f"{tuple(true_shape.shape)}")
        with torch.no_grad():
            out = self.module(images.to(self.device), true_shape.to(self.device))
        return {k: out[k].cpu().numpy() for k in OUTPUTS}

    def encoded_image_string(self, blobs: Sequence[bytes]) -> Dict[str, np.ndarray]:
        """JPEG or PNG bytes, decoded, resized and padded on the host."""
        canvases, shapes = zip(*(canvas_of(decode_image(b), self.resizer, self.canvas)
                                 for b in blobs))
        return self.image_tensor(np.stack(canvases), np.stack(shapes))

    def tf_example(self, serialized: Sequence[bytes]) -> Dict[str, np.ndarray]:
        """Serialized tf.train.Examples, served by their image/encoded."""
        return self.encoded_image_string([encoded_image(s) for s in serialized])


def load_saved_model(saved_model_dir: str, device: DeviceLike = None) -> SavedModel:
    """The program in `saved_model_dir` (`<output_directory>/saved_model`),
    served on `device`: the card by default, which must be the device the
    program was exported on."""
    device = resolve_device(device)
    extra = {META_FILE: ""}
    program = torch.export.load(os.path.join(saved_model_dir, PROGRAM_FILE), extra_files=extra)
    meta = json.loads(extra[META_FILE])
    if meta.get("format") != FORMAT:
        raise ValueError(f"{saved_model_dir} holds no {FORMAT} program")
    baked = torch.device(meta["device"])
    if baked.type != device.type or (baked.index or 0) != (device.index or 0):
        raise ValueError(f"the program in {saved_model_dir} was exported for {baked} and serves "
                         f"only there, not on {device}: export it again with --device")
    return SavedModel(program, meta, device)


def program_meta(canvas, resizer, device: torch.device, dtype: torch.dtype,
                 step: Optional[int]) -> Dict:
    """The META_FILE record `export_saved_model` keeps inside the .pt2."""
    return {"format": FORMAT, "canvas": list(canvas), "resizer": list(resizer),
            "device": str(device), "dtype": str(dtype).replace("torch.", ""), "step": step,
            "signatures": list(SIGNATURES), "outputs": list(OUTPUTS)}

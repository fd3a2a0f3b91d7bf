"""Standalone inference (port of mtlx/export/exporter.py `InferenceModel`).

An export directory holds the pipeline config (`pipeline.config`, the
text proto) and the detector's `state_dict` (`model.pt`).
`export_inference_graph` writes one from a train directory's latest
checkpoint; `InferenceModel.load` rebuilds the eval-mode detector from
it, reading the pipeline text with the port's own reader (no protobuf). Inputs
are images as arrays; outputs follow the reference contract:
detection_boxes (normalized to the original image), detection_scores,
detection_classes (1-based), num_detections, as numpy arrays.

Served batches run on a bucketed compute canvas: the largest true image
extent of the batch rounded up to the bucket granularity (128 px by
default) and capped at the model canvas, so a 600x800 image computes on
640x896 and not on the 1024x1024 canvas.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from mtlx_torch.data.imgcodec import pil_resize
from mtlx_torch.device import DeviceLike, resolve_device
from mtlx_torch.utils.bucketing import bucket_extent, bucket_multiple as _bucket_multiple

PIPELINE_FILE = "pipeline.config"
STATE_DICT_FILE = "model.pt"


def resize_keep_aspect(
    image: np.ndarray, min_dimension: int, max_dimension: int
) -> Tuple[np.ndarray, float]:
    """Reference keep_aspect_ratio_resizer: scale so the short side reaches
    min_dimension unless the long side would exceed max_dimension.
    Returns (resized image, scale)."""
    h, w = image.shape[:2]
    scale = min(min_dimension / min(h, w), max_dimension / max(h, w))
    return pil_resize(image, int(round(h * scale)), int(round(w * scale))), scale


def resize_fixed(image: np.ndarray, height: int, width: int) -> np.ndarray:
    return pil_resize(image, height, width)


class InferenceModel:
    """A detector served on one device (`device=None` means the CUDA
    device and raises without one)."""

    def __init__(self, model, resizer, bucket_multiple: int = 0,
                 device: DeviceLike = None, pipeline_text: Optional[str] = None):
        self.model = model.to(resolve_device(device))
        self.device = self.model.device
        self.resizer = resizer
        self.bucket_multiple = _bucket_multiple(bucket_multiple)
        # the text proto the model was built from; `save` writes it out
        self.pipeline_text = pipeline_text

    @classmethod
    def load(cls, export_dir: str, device: DeviceLike = None,
             dtype: torch.dtype = torch.bfloat16) -> "InferenceModel":
        from mtlx_torch.builders import model_builder
        from mtlx_torch.config import config_util

        with open(os.path.join(export_dir, PIPELINE_FILE)) as f:
            text = f.read()
        pipeline = config_util.parse_pipeline_text(text)
        device = resolve_device(device)
        model = model_builder.build(pipeline.model, is_training=False, dtype=dtype,
                                    device=device)
        state = torch.load(os.path.join(export_dir, STATE_DICT_FILE),
                           map_location=device, weights_only=True)
        model.modules.load_state_dict(state)
        resizer = model_builder.resizer_params(model_builder.image_resizer(pipeline.model))
        return cls(model, resizer, bucket_multiple=pipeline.bucketing.bucket_multiple,
                   device=device, pipeline_text=text)

    def save(self, export_dir: str) -> str:
        """Write `pipeline.config` and the weights into `export_dir`."""
        if self.pipeline_text is None:
            raise ValueError("this model was not built from a pipeline config; "
                             "pass pipeline_text to save it")
        os.makedirs(export_dir, exist_ok=True)
        with open(os.path.join(export_dir, PIPELINE_FILE), "w") as f:
            f.write(self.pipeline_text)
        state = {k: v.detach().cpu() for k, v in self.model.modules.state_dict().items()}
        torch.save(state, os.path.join(export_dir, STATE_DICT_FILE))
        return export_dir

    def _serve(self, images: np.ndarray, true_shapes: np.ndarray) -> Dict[str, torch.Tensor]:
        model = self.model
        images_t = torch.from_numpy(np.ascontiguousarray(images)).to(self.device)
        shapes_t = torch.from_numpy(np.asarray(true_shapes, np.int32)).to(self.device)
        pre = model.preprocess(images_t.float())
        pred = model.predict(pre, shapes_t, training=False)
        return model.postprocess(pred, shapes_t)

    def predict_image_tensor(self, images: np.ndarray) -> Dict[str, np.ndarray]:
        """[B, H, W, 3] images already on the compute canvas."""
        b, h, w, _ = images.shape
        true_shapes = np.tile([[h, w]], (b, 1)).astype(np.int32)
        return self._postprocess_output(self._serve(images, true_shapes))

    def predict_images(self, arrays: Sequence[np.ndarray]) -> Dict[str, np.ndarray]:
        """Decoded [H, W, 3] uint8 images of any size (mtlx's
        `_predict_decoded`): each resized by the config's image_resizer,
        all padded onto the bucket of the batch's largest extent, served
        as one batch."""
        canvas_h, canvas_w = self.model.cfg.canvas_size
        kind, params = self.resizer
        resized, true_shapes = [], []
        for a in arrays:
            if kind == "keep_aspect":
                a, _ = resize_keep_aspect(a, **params)
            else:
                a = resize_fixed(a, **params)
            th, tw = a.shape[:2]
            resized.append(a[:canvas_h, :canvas_w])
            true_shapes.append([min(th, canvas_h), min(tw, canvas_w)])
        shapes = np.asarray(true_shapes, np.int32)
        bh = bucket_extent(shapes[:, 0].max(), canvas_h, self.bucket_multiple)
        bw = bucket_extent(shapes[:, 1].max(), canvas_w, self.bucket_multiple)
        images = np.zeros((len(resized), bh, bw, 3), resized[0].dtype)
        for i, a in enumerate(resized):
            images[i, : a.shape[0], : a.shape[1]] = a
        return self._postprocess_output(self._serve(images, shapes))

    @staticmethod
    def _postprocess_output(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return {
            "detection_boxes": out["detection_boxes"],
            "detection_scores": out["detection_scores"],
            "detection_classes": out["detection_classes"] + 1,  # 1-based ids
            "num_detections": out["num_detections"],
        }


def export_inference_graph(pipeline_config_path: str, trained_checkpoint_dir: str,
                           output_directory: str) -> str:
    """Bundle the pipeline text and the serving weights of a train
    directory's latest checkpoint into `output_directory`, the bundle
    `InferenceModel.load` reads (port of mtlx's export_inference_graph;
    the weights are the eval-mode detector's `state_dict`, without the
    training-only aux heads)."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.train.checkpoints import CheckpointManager
    from mtlx_torch.train.train_step import TrainState

    with open(pipeline_config_path) as f:
        text = f.read()
    pipeline = config_util.parse_pipeline_text(text)
    # the export only copies weights from the checkpoint into the bundle:
    # it computes nothing, so it needs no card and holds the detector in
    # host memory; `InferenceModel.load` puts the bundle on the card
    model = model_builder.build(pipeline.model, is_training=False, device="cpu")
    if CheckpointManager(trained_checkpoint_dir).restore(
            TrainState(0, model, None, None), params_only=True) is None:
        raise FileNotFoundError(f"no checkpoint in {trained_checkpoint_dir}")
    resizer = model_builder.resizer_params(model_builder.image_resizer(pipeline.model))
    return InferenceModel(model, resizer, bucket_multiple=pipeline.bucketing.bucket_multiple,
                          device="cpu", pipeline_text=text).save(output_directory)

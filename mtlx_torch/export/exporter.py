"""Model export and standalone inference (port of mtlx/export/exporter.py).

An export directory holds the pipeline config (`pipeline.config`, the
text proto, with the resolved `bucketing.bucket_multiple`), the
detector's `state_dict` (`model.pt`) and `export_metadata.json` (the
checkpoint's step). `export_inference_graph` writes one from a train
directory's checkpoint, also as a CLI:

    python -m mtlx_torch.export.exporter --pipeline_config_path=... \
        --trained_checkpoint_dir=... --output_directory=... \
        [--checkpoint_step N] [--bucket_multiple M] [--saved_model [--device D]]

With `--saved_model` it also writes `<output_directory>/saved_model`:
`model.pt2`, a `torch.export` program of the detector with frozen weights
that `saved_model.load_saved_model` serves under mtlx's three signatures
(`export_saved_model`), and its `pipeline.config`.

`InferenceModel.load` rebuilds the eval-mode detector from a bundle,
reading the pipeline text with the port's own reader (no protobuf), and
serves the reference's three input types: images as arrays
(`predict_image_tensor`, `predict_images`), encoded JPEG / PNG bytes
(`predict_encoded_images`) and serialized tf.train.Examples
(`predict_tf_examples`). Outputs follow the reference contract:
detection_boxes (normalized to the original image), detection_scores,
detection_classes (1-based), num_detections, as numpy arrays; a mask
model also returns detection_masks [B, D, 14, 14], each detection's mask
probabilities within its box (mtlx's InferenceModel drops them; its
model's postprocess returns them as here).

Served batches run on a bucketed compute canvas: the largest true image
extent of the batch rounded up to the bucket granularity (128 px by
default) and capped at the model canvas, so a 600x800 image computes on
640x896 and not on the 1024x1024 canvas.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from mtlx_torch.data import imgcodec
from mtlx_torch.data.imgcodec import pil_resize
from mtlx_torch.data.loader import keep_aspect_target
from mtlx_torch.device import DeviceLike, resolve_device
from mtlx_torch.utils.bucketing import bucket_extent, bucket_multiple as _bucket_multiple

PIPELINE_FILE = "pipeline.config"
STATE_DICT_FILE = "model.pt"
METADATA_FILE = "export_metadata.json"
EXPORT_FORMAT = "mtlx_torch-v1"
_JPEG_SIGNATURE = b"\xff\xd8\xff"
_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


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
        """Decoded [H, W, 3] uint8 images of any size: each resized by the
        config's image_resizer, all padded onto the bucket of the batch's
        largest extent, served as one batch."""
        return self._predict_decoded(list(arrays))

    def predict_encoded_images(self, blobs: Sequence[bytes]) -> Dict[str, np.ndarray]:
        """Encoded images in, detections out; each blob is decoded by the
        format its bytes begin with. JPEGs decode straight onto their
        resizer target with the port's codec, on its thread pool (mtlx's
        native branch); PNGs decode with the port's PNG decoder and
        resize as `predict_images` resizes. Any other bytes raise. (mtlx
        sends a batch through PIL as a whole when one blob is not a JPEG;
        here each blob takes its own format's path.)"""
        arrays: List[Optional[np.ndarray]] = [None] * len(blobs)
        jpegs = []
        for i, b in enumerate(blobs):
            head = bytes(b[:8])
            if head.startswith(_JPEG_SIGNATURE):
                jpegs.append(i)
            elif head == _PNG_SIGNATURE:
                arrays[i] = self._resize(imgcodec.decode_png(b))
            else:
                raise ValueError(f"encoded image {i} is neither a JPEG nor a PNG (it begins "
                                 f"with {head!r})")
        if jpegs:
            targets = [self._target(*imgcodec.jpeg_dims(blobs[i])) for i in jpegs]
            decoded = imgcodec.decode_jpeg_batch([blobs[i] for i in jpegs],
                                                 [t[0] for t in targets],
                                                 [t[1] for t in targets], threads=2)
            for i, a in zip(jpegs, decoded):
                arrays[i] = a
        return self._predict_decoded(arrays, already_resized=True)

    def predict_tf_examples(self, serialized: Sequence[bytes]) -> Dict[str, np.ndarray]:
        """Serialized tf.train.Examples in: each `image/encoded` decoded
        by its `image/format` with the port's Example decoder, then served
        as `predict_images` serves arrays."""
        from mtlx_torch.data.example_decoder import decode_example

        return self._predict_decoded([decode_example(s)["image"] for s in serialized])

    def _target(self, h: int, w: int) -> Tuple[int, int]:
        """The resizer's target (height, width) for an h x w image."""
        kind, params = self.resizer
        if kind == "keep_aspect":
            return keep_aspect_target(h, w, **params)
        return params["height"], params["width"]

    def _resize(self, image: np.ndarray) -> np.ndarray:
        """The image resized onto its resizer target, bilinearly with PIL
        as mtlx's serving path resizes (unchanged when already there)."""
        return pil_resize(image, *self._target(*image.shape[:2]))

    def _predict_decoded(self, arrays: List[np.ndarray],
                         already_resized: bool = False) -> Dict[str, np.ndarray]:
        """Serve decoded images as one batch on the bucket of its largest
        extent (mtlx's `_predict_decoded`); `already_resized` images are on
        their resizer target already."""
        canvas_h, canvas_w = self.model.cfg.canvas_size
        resized, true_shapes = [], []
        for a in arrays:
            if not already_resized:
                a = self._resize(a)
            th, tw = a.shape[:2]
            resized.append(a[:canvas_h, :canvas_w])
            true_shapes.append([min(th, canvas_h), min(tw, canvas_w)])
        shapes = np.asarray(true_shapes, np.int32)
        bh = bucket_extent(shapes[:, 0].max(), canvas_h, self.bucket_multiple)
        bw = bucket_extent(shapes[:, 1].max(), canvas_w, self.bucket_multiple)
        if not getattr(self.model, "supports_bucketed_compute", True):
            bh, bw = canvas_h, canvas_w  # SSD computes on its whole canvas
        images = np.zeros((len(resized), bh, bw, 3), resized[0].dtype)
        for i, a in enumerate(resized):
            images[i, : a.shape[0], : a.shape[1]] = a
        return self._postprocess_output(self._serve(images, shapes))

    @staticmethod
    def _postprocess_output(out: Dict[str, torch.Tensor]) -> Dict[str, np.ndarray]:
        out = {k: v.cpu().numpy() for k, v in out.items()}
        served = {
            "detection_boxes": out["detection_boxes"],
            "detection_scores": out["detection_scores"],
            "detection_classes": out["detection_classes"] + 1,  # 1-based ids
            "num_detections": out["num_detections"],
        }
        if "detection_masks" in out:  # a mask model's, box-relative
            served["detection_masks"] = out["detection_masks"]
        return served


def _restored_model(pipeline_config_path: str, trained_checkpoint_dir: str,
                    checkpoint_step: Optional[int], bucket_multiple: int):
    """(configs with the resolved bucket granularity, the eval-mode detector
    in host memory with the checkpoint's serving weights, its step, the
    pipeline text): mtlx's `_load_trained`."""
    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util, text_format
    from mtlx_torch.train.checkpoints import CheckpointManager
    from mtlx_torch.train.train_step import TrainState
    from mtlx_torch.utils.bucketing import resolve_bucketing

    configs = config_util.get_configs_from_pipeline_file(pipeline_config_path)
    # serving computes every bucket it meets: the bound on the variants is
    # the train and eval CLIs' (mtlx's exporter ignores it too)
    configs["bucketing"].bucket_multiple = resolve_bucketing(configs["bucketing"],
                                                             bucket_multiple)[0]
    # restoring only copies weights from the checkpoint: it computes
    # nothing, so it needs no card and holds the detector in host memory
    model = model_builder.build(configs["model"], is_training=False, device="cpu")
    # eval_config.use_moving_averages exports the moving average of the
    # weights, where the checkpoint has one
    restored = CheckpointManager(trained_checkpoint_dir).restore(
        TrainState(0, model, None, None), checkpoint_step, params_only=True,
        use_ema=configs["eval_config"].use_moving_averages)
    if restored is None:
        raise FileNotFoundError(f"no checkpoint in {trained_checkpoint_dir}")
    text = text_format.to_text(config_util.create_pipeline_proto_from_configs(configs))
    return configs, model, int(restored.step), text


def export_inference_graph(pipeline_config_path: str, trained_checkpoint_dir: str,
                           output_directory: str, checkpoint_step: Optional[int] = None,
                           bucket_multiple: int = 0) -> str:
    """Bundle the pipeline config and the serving weights of a train
    directory's checkpoint (the latest, or `checkpoint_step`) into
    `output_directory`, the bundle `InferenceModel.load` reads (port of
    mtlx's export_inference_graph). The serving bucket granularity is
    resolved (the flag over the pipeline's `bucketing {}` block, else the
    default) and written into the bundle's pipeline.config;
    export_metadata.json holds the checkpoint's step. The weights are the
    eval-mode detector's `state_dict`: without the MTL aux heads, unless
    the pipeline's `mtl.refine` keeps them in serving (then the bundle
    holds them and its pipeline.config says `refine: true`)."""
    from mtlx_torch.builders import model_builder

    configs, model, step, text = _restored_model(pipeline_config_path, trained_checkpoint_dir,
                                                 checkpoint_step, bucket_multiple)
    # the bundle holds the weights in host memory; `InferenceModel.load`
    # puts it on the card
    resizer = model_builder.resizer_params(model_builder.image_resizer(configs["model"]))
    InferenceModel(model, resizer, bucket_multiple=configs["bucketing"].bucket_multiple,
                   device="cpu", pipeline_text=text).save(output_directory)
    with open(os.path.join(output_directory, METADATA_FILE), "w") as f:
        json.dump({"step": step, "format": EXPORT_FORMAT}, f)
    return output_directory


class ServingForward(torch.nn.Module):
    """The function mtlx's SavedModel converts: uint8 images on the canvas
    and their int32 true sizes -> preprocess -> predict -> postprocess ->
    detection_boxes, detection_scores, detection_classes (1-based, float32)
    and num_detections (float32)."""

    def __init__(self, model):
        super().__init__()
        self.model = model
        self.detector = model.modules  # registers the weights

    def forward(self, images: torch.Tensor, true_shape: torch.Tensor):
        model = self.model
        pre = model.preprocess(images.float())
        pred = model.predict(pre, true_shape, training=False)
        out = model.postprocess(pred, true_shape)
        return {"detection_boxes": out["detection_boxes"],
                "detection_scores": out["detection_scores"],
                "detection_classes": (out["detection_classes"] + 1).float(),
                "num_detections": out["num_detections"].float()}


def trace_serving_program(model, example_batch: int = 2) -> torch.export.ExportedProgram:
    """`ServingForward(model)` exported with a dynamic batch at the model
    canvas, its weights frozen (no gradient). One eager call first fills
    the model's caches (the anchor grid) with real tensors, which the
    program keeps as constants. The example batch is at least 2:
    torch.export specialises sizes 0 and 1."""
    if example_batch < 2:
        raise ValueError(f"trace with a batch of at least 2, not {example_batch}")
    for p in model.modules.parameters():
        p.requires_grad_(False)
    forward = ServingForward(model).eval()
    ch, cw = model.cfg.canvas_size
    images = torch.zeros((example_batch, ch, cw, 3), dtype=torch.uint8, device=model.device)
    true_shape = torch.tensor([[ch, cw]] * example_batch, dtype=torch.int32, device=model.device)
    with torch.no_grad():
        forward(images, true_shape)
    batch = torch.export.Dim("batch", min=1)
    return torch.export.export(forward, (images, true_shape),
                               dynamic_shapes=({0: batch}, {0: batch}), strict=False)


def export_saved_model(pipeline_config_path: str, trained_checkpoint_dir: str,
                       output_directory: str, checkpoint_step: Optional[int] = None,
                       bucket_multiple: int = 0, device: DeviceLike = None) -> str:
    """The serving program of a train directory's checkpoint (port of
    mtlx's export_saved_model): `output_directory/model.pt2`, a
    `torch.export` program of the eval-mode detector restored as
    `export_inference_graph` restores it (the moving average where
    `eval_config.use_moving_averages` asks for it), and its
    `pipeline.config`. `saved_model.load_saved_model` serves it under
    mtlx's three signatures.

    The program holds the weights frozen and the graph in one file (mtlx's
    frozen_inference_graph.pb, a GraphDef for TF1 sessions, has no
    counterpart), takes any batch at the model canvas, and calls the
    kernels as the `mtlx::` ops. It bakes in the device it is exported on,
    `device` (the card by default), and serves only there; the compute
    type is bfloat16 on the card (as `InferenceModel.load`) and float32 on
    the CPU."""
    from mtlx_torch.builders import model_builder

    configs, restored, step, text = _restored_model(pipeline_config_path, trained_checkpoint_dir,
                                                    checkpoint_step, bucket_multiple)
    device = resolve_device(device)
    dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
    model = model_builder.build(configs["model"], is_training=False, dtype=dtype, device=device)
    model.modules.load_state_dict(restored.modules.state_dict())
    resizer = model_builder.resizer_params(model_builder.image_resizer(configs["model"]))
    return save_serving_program(model, resizer, output_directory, step=step, pipeline_text=text)


def save_serving_program(model, resizer, output_directory: str, step: Optional[int] = None,
                         pipeline_text: Optional[str] = None) -> str:
    """Trace `model` (`trace_serving_program`, on its own device and in its
    own compute type) and write `output_directory/model.pt2`, with the
    serving facts the loader needs inside it, and `pipeline.config` where
    `pipeline_text` is given."""
    from mtlx_torch.export import saved_model

    program = trace_serving_program(model)
    meta = saved_model.program_meta(model.cfg.canvas_size, resizer, model.device,
                                    model.cfg.dtype, step)
    os.makedirs(output_directory, exist_ok=True)
    torch.export.save(program, os.path.join(output_directory, saved_model.PROGRAM_FILE),
                      extra_files={saved_model.META_FILE: json.dumps(meta)})
    if pipeline_text is not None:
        with open(os.path.join(output_directory, PIPELINE_FILE), "w") as f:
            f.write(pipeline_text)
    return output_directory


def main(argv=None) -> str:
    from mtlx_torch.utils.bucketing import bucket_multiple_arg

    p = argparse.ArgumentParser(description="Export a trained checkpoint as a serving bundle")
    p.add_argument("--pipeline_config_path", required=True)
    p.add_argument("--trained_checkpoint_dir", required=True)
    p.add_argument("--output_directory", required=True)
    p.add_argument("--checkpoint_step", type=int, default=None)
    p.add_argument("--saved_model", action="store_true",
                   help="also write the serving program (torch.export, frozen weights, three "
                        "signatures) under <output_directory>/saved_model: model.pt2 and its "
                        "pipeline.config")
    p.add_argument("--device", default=None,
                   help="the device the --saved_model program is exported for and served on "
                        "(default: the CUDA device; 'cpu' runs the plain versions)")
    p.add_argument("--bucket_multiple", type=bucket_multiple_arg, default=0,
                   help="serving compute-bucket granularity in pixels (a multiple of 32); "
                        "overrides the pipeline's `bucketing {}` block and is recorded in the "
                        "export's pipeline.config; default 128")
    args = p.parse_args(argv)
    out = export_inference_graph(args.pipeline_config_path, args.trained_checkpoint_dir,
                                 args.output_directory, args.checkpoint_step,
                                 bucket_multiple=args.bucket_multiple)
    print(f"[export] wrote {out}", flush=True)
    if args.saved_model:
        sm = export_saved_model(args.pipeline_config_path, args.trained_checkpoint_dir,
                                os.path.join(args.output_directory, "saved_model"),
                                args.checkpoint_step, bucket_multiple=args.bucket_multiple,
                                device=args.device)
        print(f"[export] wrote the serving program {sm}", flush=True)
    return out


if __name__ == "__main__":
    main()

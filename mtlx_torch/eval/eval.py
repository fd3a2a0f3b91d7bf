"""Evaluation CLI (port of mtlx/eval/eval.py):

    python -m mtlx_torch.eval.eval --pipeline_config_path=... \\
        --checkpoint_dir=... --eval_dir=... [--run_once]

Polls checkpoint_dir for new checkpoints, runs eval_config.num_examples
images through the detector's predict and postprocess on the device in
batches grouped by compute bucket, feeds the numpy evaluators of
eval_config.metrics_set (Pascal, weighted Pascal, COCO, OpenImages) and
prints `[eval] step N: {json}` with their metrics (`Precision/mAP@0.5IOU`
and the per-class APs; `DetectionBoxes_Precision/mAP`, `mAP@.50IOU`,
`mAP@.75IOU`, the mAP and AR@100 by area and AR@1/10/100;
`OpenImagesV2_Precision/mAP@0.5IOU`; with eval_instance_masks, the mask
metrics `DetectionMasks_*` and `PascalMasks_*` / `WeightedPascalMasks_*`
on the groundtruth masks upscaled from the loader's raster and each
detection's mask pasted into its box) and eval/images_per_sec; each
evaluation's metrics are also appended
to `<eval_dir>/metrics.jsonl` and written, where finite, as scalars to a
TensorBoard event file in eval_dir (`utils/summary_writer.py`).
`--run_once` evaluates the latest checkpoint and exits. It runs on the
CUDA device unless `--device cpu` is passed.

The first eval_config.num_visualizations images of each evaluation are
drawn as mtlx draws them (utils/visualization_utils.py): the detections
scoring 0.3 or more on the left, the groundtruth on the right, written
as the image summaries `Detections_Left_Groundtruth_Right/<i>` of the
event file and, with eval_config.visualization_export_dir, as
`export-<step>-<i>.png` files there.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, List

import numpy as np
import torch

# the evaluators that match on instance masks
MASK_EVALUATORS = ("CocoMaskEvaluator", "PascalInstanceSegmentationEvaluator",
                   "WeightedPascalInstanceSegmentationEvaluator")


def parse_args(argv=None):
    from mtlx_torch.utils.bucketing import bucket_multiple_arg

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--pipeline_config_path", required=True)
    p.add_argument("--checkpoint_dir", required=True)
    p.add_argument("--eval_dir", required=True)
    p.add_argument("--run_once", action="store_true")
    p.add_argument("--eval_training_data", action="store_true",
                   help="evaluate on train_input_reader instead of eval_input_reader")
    p.add_argument("--master", default="", help=argparse.SUPPRESS)
    p.add_argument("--tf1_resize", action="store_true",
                   help="TF1 resize_images convention (see the train CLI)")
    p.add_argument("--eval_batch_size", type=int, default=8,
                   help="images per eval step (per-image evaluation is batch-invariant; "
                        "tail batches are padded and the padding ignored)")
    p.add_argument("--bucket_multiple", type=bucket_multiple_arg, default=0,
                   help="compute bucket granularity in pixels (a multiple of 32); "
                        "overrides the pipeline's `bucketing {}` block; default 128")
    p.add_argument("--max_bucket_variants", type=int, default=0,
                   help="bound the compute buckets to N shapes, as the train CLI's flag; "
                        "0 = the pipeline's `bucketing {}` block, else no bound")
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    return p.parse_args(argv)


def build_evaluators(eval_config, categories: List[dict]):
    """metrics_set names -> evaluators (default: the Pascal VOC one)."""
    from mtlx_torch.eval.coco_evaluation import CocoDetectionEvaluator, CocoMaskEvaluator
    from mtlx_torch.eval.object_detection_evaluation import (
        OpenImagesDetectionEvaluator,
        PascalDetectionEvaluator,
        PascalInstanceSegmentationEvaluator,
        WeightedPascalDetectionEvaluator,
        WeightedPascalInstanceSegmentationEvaluator,
    )

    names = list(eval_config.metrics_set) or ["pascal_voc_detection_metrics"]
    evaluators = []
    for name in names:
        if name in ("pascal_voc_detection_metrics", "pascal_voc_metrics"):
            evaluators.append(PascalDetectionEvaluator(categories))
        elif name in ("weighted_pascal_voc_detection_metrics", "weighted_pascal_voc_metrics"):
            evaluators.append(WeightedPascalDetectionEvaluator(categories))
        elif name == "open_images_V2_detection_metrics":
            evaluators.append(OpenImagesDetectionEvaluator(categories))
        elif name == "coco_detection_metrics":
            evaluators.append(CocoDetectionEvaluator(categories))
        elif name == "pascal_voc_instance_segmentation_metrics":
            evaluators.append(PascalInstanceSegmentationEvaluator(categories))
        elif name == "weighted_pascal_voc_instance_segmentation_metrics":
            evaluators.append(WeightedPascalInstanceSegmentationEvaluator(categories))
        elif name == "coco_mask_metrics":
            evaluators.append(CocoMaskEvaluator(categories))
        else:
            raise ValueError(f"unknown eval_config.metrics_set entry {name!r}")
    return evaluators


def detect(model, images: np.ndarray, true_shapes: np.ndarray,
           bucket_multiple: int = 0) -> Dict[str, np.ndarray]:
    """predict + postprocess of one batch of uint8 images (packed to their
    bucket or on the canvas) on the model's device, as numpy."""
    from mtlx_torch.train import train_step as ts

    with torch.inference_mode():
        x = torch.from_numpy(np.ascontiguousarray(images)).to(model.device)
        shapes = torch.from_numpy(np.asarray(true_shapes, np.int32)).to(model.device)
        x = ts.pad_for_model(model, {"image": x}, bucket_multiple)["image"]
        det = model.postprocess(model.predict(model.preprocess(x.float()), shapes), shapes)
    return {k: v.cpu().numpy() for k, v in det.items()}


def evaluate_checkpoint(model, dataset, eval_config, categories: List[dict],
                        batch_size: int = 1, bucket_multiple: int = 0,
                        max_bucket_variants: int = 0, writer=None,
                        step: int = 0) -> Dict[str, float]:
    """One evaluation pass of the model's current weights; returns the
    metrics dict. max_bucket_variants > 0 bounds the compute buckets as
    training does (data/loader.py BucketCoalescer; the metrics do not
    depend on the padding). The first num_visualizations images, in the
    order evaluated, are drawn into `writer`'s image summaries and, with
    visualization_export_dir, into PNG files, both at `step` (module
    docstring)."""
    from mtlx_torch.data.imgcodec import encode_png
    from mtlx_torch.data.loader import BucketCoalescer, pack_batch_images, record_bucket_keys
    from mtlx_torch.utils import visualization_utils as viz
    from mtlx_torch.utils.label_map_util import create_category_index

    evaluators = [] if eval_config.ignore_groundtruth else build_evaluators(eval_config,
                                                                            categories)
    mask_evaluators = check_mask_metrics(evaluators, eval_config, dataset, model)
    detections_export = [] if eval_config.export_path else None
    category_index = create_category_index(categories)
    viz_dir = eval_config.visualization_export_dir
    num_viz = eval_config.num_visualizations if (writer is not None or viz_dir) else 0
    if viz_dir:
        os.makedirs(viz_dir, exist_ok=True)
    num = min(eval_config.num_examples or len(dataset), len(dataset))
    # bucket-major order: a batch of mixed buckets computes on the largest
    # one (metrics are per image, so the order does not change them)
    order = list(range(num))
    coalescer = None
    if batch_size > 1 or max_bucket_variants:
        keys = record_bucket_keys(dataset, max_records=num, bucket_multiple=bucket_multiple)
        if max_bucket_variants:
            coalescer = BucketCoalescer(keys, max_bucket_variants, dataset.canvas_size)
            keys = [coalescer.map(k) for k in keys]
        if batch_size > 1:
            order.sort(key=lambda i: (keys[i], i))
    t0 = time.perf_counter()
    done = 0
    for start in range(0, num, batch_size):
        idx = order[start : start + batch_size]
        samples = dataset.get_batch(idx, decode_threads=2)
        true_shapes = np.stack([s["true_shape"] for s in samples])
        images = pack_batch_images(np.stack([s["image"] for s in samples]), true_shapes,
                                   bucket_multiple, coalescer)
        if len(idx) < batch_size:  # pad the tail batch
            pad = batch_size - len(idx)
            images = np.concatenate([images, np.repeat(images[-1:], pad, 0)])
            true_shapes = np.concatenate([true_shapes, np.repeat(true_shapes[-1:], pad, 0)])
        det = detect(model, images, true_shapes, bucket_multiple)
        if not eval_config.eval_instance_masks:
            det.pop("detection_masks", None)
        if mask_evaluators and "detection_masks" not in det and start == 0:
            print(f"[eval] note: {mask_evaluators} requested but no detection masks reach the "
                  "evaluator — use a mask-predicting model (coco_mask_metrics scores zero "
                  "mask detections)", flush=True)
        for j, s in enumerate(samples):
            th, tw = s["true_shape"]
            gt_n = int(s["gt_mask"].sum())
            # the evaluator works in absolute true-image pixels
            gt_info = {
                "groundtruth_boxes": s["gt_boxes"][:gt_n],
                "groundtruth_classes": s["gt_classes"][:gt_n] + 1,
                "groundtruth_difficult": s["gt_difficult"][:gt_n].astype(bool),
                "groundtruth_group_of": s["gt_group_of"][:gt_n].astype(bool),
            }
            n_det = int(det["num_detections"][j])
            boxes_norm = det["detection_boxes"][j][:n_det]
            scale = np.asarray([th, tw, th, tw], np.float32)
            det_info = {
                "detection_boxes": boxes_norm * scale,
                "detection_scores": det["detection_scores"][j][:n_det],
                "detection_classes": det["detection_classes"][j][:n_det] + 1,
            }
            to_evaluate = bool(mask_evaluators) and "gt_instance_masks" in s
            det_masks = None
            if "detection_masks" in det and (to_evaluate or done < num_viz):
                det_masks = viz.paste_instance_masks(det["detection_masks"][j][:n_det],
                                                     boxes_norm, int(th), int(tw))
            if to_evaluate:
                # both sides in the true image's frame
                gt_info["groundtruth_instance_masks"] = true_frame_masks(
                    s["gt_instance_masks"][:gt_n], s["image"].shape[0], int(th), int(tw))
                if det_masks is not None:
                    det_info["detection_masks"] = det_masks
            for evaluator in evaluators:
                evaluator.add_single_ground_truth_image_info(s["source_id"], gt_info)
                evaluator.add_single_detected_image_info(s["source_id"], det_info)
            if detections_export is not None:
                detections_export.append({"source_id": s["source_id"],
                                          **{k: det_info[k].tolist() for k in (
                                              "detection_boxes", "detection_scores",
                                              "detection_classes")}})
            if done < num_viz:
                # left: the detections scoring 0.3 or more; right: the groundtruth
                image = np.array(s["image"][:th, :tw], np.uint8, copy=True)
                viz.visualize_boxes_and_labels_on_image_array(
                    image, boxes_norm, det_info["detection_classes"],
                    det_info["detection_scores"], category_index, instance_masks=det_masks,
                    min_score_thresh=0.3)
                gt_image = np.array(s["image"][:th, :tw], np.uint8, copy=True)
                viz.visualize_boxes_and_labels_on_image_array(
                    gt_image, gt_info["groundtruth_boxes"] / scale,
                    gt_info["groundtruth_classes"], None, category_index,
                    instance_masks=gt_info.get("groundtruth_instance_masks"),
                    min_score_thresh=0.0)
                image = np.concatenate([image, gt_image], axis=1)
                if writer is not None:
                    writer.image(f"Detections_Left_Groundtruth_Right/{done}", image, step)
                if viz_dir:
                    with open(os.path.join(viz_dir, f"export-{step}-{done}.png"), "wb") as f:
                        f.write(encode_png(image))
            done += 1
    if detections_export is not None:
        with open(eval_config.export_path, "w") as f:
            json.dump(detections_export, f)
    metrics: Dict[str, float] = {}
    for evaluator in evaluators:
        metrics.update(evaluator.evaluate())
    metrics["eval/images_per_sec"] = done / (time.perf_counter() - t0)
    return metrics


def check_mask_metrics(evaluators, eval_config, dataset, model) -> List[str]:
    """The names of the mask evaluators among `evaluators`; raises, as
    mtlx does, where the config could never feed them: eval_instance_masks
    off, an input reader that loads no instance masks, or (for the Pascal
    ones) a model that predicts none."""
    names = [type(e).__name__ for e in evaluators if type(e).__name__ in MASK_EVALUATORS]
    if not names:
        return names
    if not eval_config.eval_instance_masks:
        raise ValueError(
            f"metrics_set requests {names} but eval_config.eval_instance_masks is false — set "
            "it to true (and load_instance_masks on the eval input reader), or drop the "
            "instance-segmentation metrics_set entries")
    if not getattr(dataset, "load_instance_masks", True):
        raise ValueError(
            f"metrics_set requests {names} but the eval input reader does not load instance "
            "masks — set eval_input_reader.load_instance_masks: true")
    pascal = [n for n in names if n != "CocoMaskEvaluator"]
    if pascal and not getattr(getattr(model, "cfg", None), "predict_instance_masks", True):
        raise ValueError(
            f"metrics_set requests {pascal} but the model does not predict instance masks — "
            "enable predict_instance_masks on the box predictor (mask_rcnn_box_predictor "
            "{ predict_instance_masks: true })")
    return names


def true_frame_masks(raster: np.ndarray, canvas_h: int, th: int, tw: int) -> np.ndarray:
    """Ground-truth masks [G, CH / s, CW / s] of the loader's raster as
    [G, th, tw] bool in the true image's frame: each one's true region
    (round(true / s)) upscaled with PIL (bilinear) and thresholded at 127,
    as mtlx's eval does."""
    from PIL import Image

    ms = canvas_h // raster.shape[1]
    mth, mtw = max(1, round(th / ms)), max(1, round(tw / ms))
    out = np.zeros((len(raster), th, tw), bool)
    for k in range(len(raster)):
        small = (raster[k][:mth, :mtw] * 255).astype(np.uint8)
        out[k] = np.asarray(Image.fromarray(small, "L").resize((tw, th), Image.BILINEAR)) > 127
    return out


def main(argv=None):
    args = parse_args(argv)

    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.data.loader import DetectionDataset
    from mtlx_torch.device import resolve_device
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train.train_step import TrainState
    from mtlx_torch.utils import label_map_util
    from mtlx_torch.utils.bucketing import resolve_bucketing
    from mtlx_torch.utils.summary_writer import SummaryWriter

    device = resolve_device(args.device)
    configs = config_util.get_configs_from_pipeline_file(args.pipeline_config_path)
    for note in config_util.compatibility_notes(configs):
        print(f"[eval] note: {note}", flush=True)
    multiple, max_variants = resolve_bucketing(configs["bucketing"], args.bucket_multiple,
                                               args.max_bucket_variants)
    eval_config = configs["eval_config"]
    input_config = (configs["train_input_config"] if args.eval_training_data
                    else configs["eval_input_config"])
    model = model_builder.build(configs["model"], is_training=False, device=device)
    dataset = DetectionDataset(
        list(input_config.tf_record_input_reader.input_path),
        canvas_size=model.cfg.canvas_size,
        resizer=model_builder.resizer_params(model_builder.image_resizer(configs["model"])),
        max_boxes=100,
        load_instance_masks=input_config.load_instance_masks,
        num_keypoints=input_config.num_keypoints,
        tf1_resize=args.tf1_resize,
    )
    if input_config.label_map_path:
        categories = list(label_map_util.create_category_index_from_labelmap(
            input_config.label_map_path).values())
    else:
        categories = [{"id": i + 1, "name": f"class_{i + 1}"}
                      for i in range(model.cfg.num_classes)]

    state = TrainState(0, model, None, None)
    manager = ckpt_lib.CheckpointManager(args.checkpoint_dir)
    writer = SummaryWriter(args.eval_dir)
    last_step, evals, metrics = None, 0, None
    try:
        while True:
            step = manager.latest_step()
            if step is not None and step != last_step:
                # use_moving_averages evaluates the moving average of the
                # weights, where the checkpoint has one
                manager.restore(state, step, params_only=True,
                                use_ema=eval_config.use_moving_averages)
                metrics = evaluate_checkpoint(model, dataset, eval_config, categories,
                                              batch_size=args.eval_batch_size,
                                              bucket_multiple=multiple,
                                              max_bucket_variants=max_variants,
                                              writer=writer, step=step)
                rounded = {k: round(float(v), 4) for k, v in metrics.items()}
                print(f"[eval] step {step}: " + json.dumps(rounded), flush=True)
                with open(os.path.join(args.eval_dir, "metrics.jsonl"), "a") as f:
                    f.write(json.dumps({"step": step, **rounded}) + "\n")
                for k, v in metrics.items():
                    if np.isfinite(v):
                        writer.scalar(k, float(v), step)
                writer.flush()
                last_step = step
                evals += 1
            if args.run_once or (eval_config.max_evals and evals >= eval_config.max_evals):
                break
            time.sleep(eval_config.eval_interval_secs or 300)
    finally:
        dataset.close()
        writer.close()
    return metrics


if __name__ == "__main__":
    main()

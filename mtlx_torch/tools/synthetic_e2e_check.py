"""End-to-end learnability check of the port on synthetic data (port of
tools/synthetic_e2e_check.py): write 48 JPEG records of coloured
rectangles, train a detector from scratch through the train CLI,
evaluate the last checkpoint through the eval CLI, and require mAP@0.5
well above chance. `--model frcnn` (the default) trains the 3-task MTL
Faster R-CNN R50 and requires 0.5; `--model ssd` trains SSD MobileNet-v1
(depth 0.5, live batch norm, 3:1 mining, sigmoid NMS) and requires 0.3,
as mtlx's tool does.

    python -m mtlx_torch.tools.synthetic_e2e_check [--model frcnn|ssd] \\
        [--steps 300] [--require_map R] [--keep_aspect] [--workdir DIR] [--device cpu]

It runs on the CUDA device unless `--device cpu` is passed. `--keep_aspect`
resizes with keep_aspect_ratio_resizer {96, 160} instead of a fixed
128x128: the images land on a 128x128 compute bucket of the 160x160
canvas. The records are encoded with PIL, as the reference tool encodes
them; the train and eval CLIs decode them with the port's JPEG codec.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import tempfile
from typing import Dict

import numpy as np

CONFIG = """
model {{
  faster_rcnn {{
    num_classes: 2
    image_resizer {{ {resizer} }}
    feature_extractor {{ type: 'faster_rcnn_resnet50' }}
    first_stage_anchor_generator {{
      grid_anchor_generator {{ scales: [0.25, 0.5, 1.0] aspect_ratios: [0.5, 1.0, 2.0]
                               height: 128 width: 128 }}
    }}
    first_stage_box_predictor_depth: 256
    first_stage_max_proposals: 32
    first_stage_minibatch_size: 64
    second_stage_batch_size: 16
    initial_crop_size: 14
    maxpool_kernel_size: 2
    maxpool_stride: 2
    second_stage_post_processing {{
      batch_non_max_suppression {{ score_threshold: 0.0 iou_threshold: 0.6
        max_detections_per_class: 10 max_total_detections: 20 }}
      score_converter: SOFTMAX
    }}
    first_stage_localization_loss_weight: 2.0
    second_stage_localization_loss_weight: 2.0
    mtl {{ window: true closeness: true edgemask: true
          window_loss_weight: 0.2 closeness_loss_weight: 0.2 edgemask_loss_weight: 0.3 }}
  }}
}}
train_config {{
  batch_size: 8
  optimizer {{
    momentum_optimizer {{
      learning_rate {{
        cosine_decay_learning_rate {{ learning_rate_base: 0.01
          total_steps: {steps} warmup_learning_rate: 0.001 warmup_steps: 30 }}
      }}
      momentum_optimizer_value: 0.9
    }}
    use_moving_average: false
  }}
  gradient_clipping_by_norm: 10.0
  data_augmentation_options {{ random_horizontal_flip {{}} }}
  num_steps: {steps}
  save_checkpoints_steps: {steps}
  max_number_of_boxes: 6
}}
train_input_reader {{
  tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}"
}}
eval_config {{ num_examples: 24 num_visualizations: 2 }}
eval_input_reader {{
  tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}"
  shuffle: false
}}
"""

FIXED_RESIZER = "fixed_shape_resizer { height: 128 width: 128 }"
KEEP_ASPECT_RESIZER = "keep_aspect_ratio_resizer { min_dimension: 96 max_dimension: 160 }"


SSD_CONFIG = """
model {{
  ssd {{
    num_classes: 2
    image_resizer {{ {resizer} }}
    feature_extractor {{
      type: 'ssd_mobilenet_v1'
      depth_multiplier: 0.5
      min_depth: 16
      conv_hyperparams {{
        op: CONV
        regularizer {{ l2_regularizer {{ weight: 0.0 }} }}
        initializer {{ truncated_normal_initializer {{ stddev: 0.03 }} }}
        activation: RELU_6
        batch_norm {{ train: true decay: 0.99 center: true scale: true
                      epsilon: 0.001 }}
      }}
    }}
    box_coder {{
      faster_rcnn_box_coder {{ y_scale: 10.0 x_scale: 10.0
                               height_scale: 5.0 width_scale: 5.0 }}
    }}
    matcher {{
      argmax_matcher {{ matched_threshold: 0.5 unmatched_threshold: 0.5
                        negatives_lower_than_unmatched: true
                        force_match_for_each_row: true }}
    }}
    similarity_calculator {{ iou_similarity {{ }} }}
    anchor_generator {{
      ssd_anchor_generator {{
        num_layers: 4 min_scale: 0.2 max_scale: 0.8
        aspect_ratios: 1.0 aspect_ratios: 2.0 aspect_ratios: 0.5
      }}
    }}
    box_predictor {{
      convolutional_box_predictor {{
        kernel_size: 3 box_code_size: 4
        conv_hyperparams {{
          op: CONV
          regularizer {{ l2_regularizer {{ weight: 0.0 }} }}
          initializer {{ truncated_normal_initializer {{ stddev: 0.03 }} }}
          activation: RELU_6
        }}
      }}
    }}
    loss {{
      classification_loss {{ weighted_sigmoid {{ }} }}
      localization_loss {{ weighted_smooth_l1 {{ }} }}
      hard_example_miner {{
        num_hard_examples: 512 iou_threshold: 0.99
        loss_type: CLASSIFICATION
        max_negatives_per_positive: 3 min_negatives_per_image: 3
      }}
      classification_weight: 1.0 localization_weight: 1.0
    }}
    normalize_loss_by_num_matches: true
    post_processing {{
      batch_non_max_suppression {{ score_threshold: 0.0 iou_threshold: 0.6
        max_detections_per_class: 10 max_total_detections: 20 }}
      score_converter: SIGMOID
    }}
  }}
}}
train_config {{
  batch_size: 8
  optimizer {{
    momentum_optimizer {{
      learning_rate {{
        cosine_decay_learning_rate {{ learning_rate_base: 0.05
          total_steps: {steps} warmup_learning_rate: 0.005 warmup_steps: 30 }}
      }}
      momentum_optimizer_value: 0.9
    }}
    use_moving_average: false
  }}
  gradient_clipping_by_norm: 10.0
  data_augmentation_options {{ random_horizontal_flip {{}} }}
  num_steps: {steps}
  save_checkpoints_steps: {steps}
  max_number_of_boxes: 6
}}
train_input_reader {{
  tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}"
}}
eval_config {{ num_examples: 24 num_visualizations: 2 }}
eval_input_reader {{
  tf_record_input_reader {{ input_path: "{record}" }}
  label_map_path: "{label_map}"
  shuffle: false
}}
"""


def make_dataset(path: str, n: int = 48, seed: int = 0) -> None:
    """n records of 128x128 JPEGs (quality 95): dark noise with 1-3
    rectangles, red (class 1) or green (class 2), from RandomState(seed)."""
    from PIL import Image

    from mtlx_torch.data import tfrecord
    from mtlx_torch.data.example_decoder import build_example

    rs = np.random.RandomState(seed)
    with tfrecord.TFRecordWriter(path) as w:
        for i in range(n):
            img = rs.randint(0, 60, (128, 128, 3), dtype=np.uint8)
            boxes, labels, texts = [], [], []
            for _ in range(rs.randint(1, 4)):
                h, wd = rs.randint(24, 56), rs.randint(24, 56)
                y = rs.randint(0, 128 - h)
                x = rs.randint(0, 128 - wd)
                cls = rs.randint(0, 2)
                img[y : y + h, x : x + wd] = [220, 30, 30] if cls == 0 else [30, 220, 30]
                boxes.append([y / 128, x / 128, (y + h) / 128, (x + wd) / 128])
                labels.append(cls + 1)
                texts.append(["red", "green"][cls])
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=95)
            w.write(build_example(buf.getvalue(), b"jpeg", 128, 128, f"syn{i}.jpg",
                                  np.asarray(boxes, np.float32), labels, texts))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--model", choices=("frcnn", "ssd"), default="frcnn")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--require_map", type=float, default=None,
                   help="default 0.5 for frcnn, 0.3 for ssd (single-shot from scratch on "
                        "48 images converges slower)")
    p.add_argument("--workdir", default=None)
    p.add_argument("--keep_aspect", action="store_true",
                   help="keep_aspect_ratio_resizer {96, 160} instead of a fixed 128x128")
    p.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = p.parse_args(argv)
    if args.require_map is None:
        args.require_map = 0.5 if args.model == "frcnn" else 0.3
    return args


def main(argv=None) -> Dict[str, float]:
    """Returns the eval metrics; raises AssertionError below the bar."""
    args = parse_args(argv)
    from mtlx_torch.builders import optimizer_builder
    from mtlx_torch.config import config_util
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.train import train as train_cli

    work = args.workdir or tempfile.mkdtemp(prefix="mtlx_torch_syn_")
    os.makedirs(work, exist_ok=True)
    record = os.path.join(work, "syn.record")
    label_map = os.path.join(work, "label_map.pbtxt")
    make_dataset(record)
    with open(label_map, "w") as f:
        f.write("item { id: 1 name: 'red' }\nitem { id: 2 name: 'green' }\n")
    pipeline = os.path.join(work, "pipeline.config")
    with open(pipeline, "w") as f:
        template = CONFIG if args.model == "frcnn" else SSD_CONFIG
        f.write(template.format(steps=args.steps, record=record, label_map=label_map,
                                resizer=KEEP_ASPECT_RESIZER if args.keep_aspect
                                else FIXED_RESIZER))

    train_config = config_util.get_configs_from_pipeline_file(pipeline)["train_config"]
    _, lr, _ = optimizer_builder.build(train_config.optimizer, train_config)
    counts = sorted({0, 30, args.steps - 1})
    print("[synthetic-e2e] learning rate at update " + json.dumps(
        {c: float(lr(c)) for c in counts}), flush=True)

    device = [] if args.device is None else ["--device", args.device]
    train_dir = os.path.join(work, "train")
    train_cli.main(["--pipeline_config_path", pipeline, "--train_dir", train_dir,
                    "--log_every", "50", *device])
    metrics = eval_cli.main(["--pipeline_config_path", pipeline, "--checkpoint_dir", train_dir,
                             "--eval_dir", os.path.join(work, "eval"), "--run_once", *device])
    print("[synthetic-e2e] " + json.dumps({k: round(float(v), 4) for k, v in metrics.items()}),
          flush=True)
    m = metrics["Precision/mAP@0.5IOU"]
    if not m >= args.require_map:
        raise AssertionError(f"mAP {m:.3f} < required {args.require_map}: the detector "
                             "failed to learn")
    print(f"[synthetic-e2e] PASSED: mAP@0.5 = {m:.3f} >= {args.require_map}", flush=True)
    return metrics


if __name__ == "__main__":
    main()

"""COCO instances JSON -> TFRecord (port of mtlx/data/coco.py): the same
Example schema as the VOC writer, from the standard library's JSON (no
pycocotools). No masks or keypoints, as in mtlx.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np

from mtlx_torch.data import tfrecord
from mtlx_torch.data.example_decoder import build_example


def create_coco_tf_record(annotations_file: str, image_dir: str, output_path: str,
                          include_crowd: bool = False,
                          max_examples: Optional[int] = None) -> int:
    """Write a TFRecord from a COCO instances JSON; returns the example
    count. Class labels are the original COCO category ids (1..90 with
    gaps, as mscoco_label_map.pbtxt); `iscrowd` goes in the difficult
    field, and crowd annotations are dropped unless include_crowd. An
    image whose file is missing is skipped. Boxes are clipped to [0, 1]."""
    with open(annotations_file) as f:
        data = json.load(f)
    images = {im["id"]: im for im in data["images"]}
    anns_by_image: Dict[int, list] = {}
    for ann in data["annotations"]:
        if ann.get("iscrowd", 0) and not include_crowd:
            continue
        anns_by_image.setdefault(ann["image_id"], []).append(ann)
    cat_names = {c["id"]: c["name"] for c in data["categories"]}

    count = 0
    with tfrecord.TFRecordWriter(output_path) as writer:
        for image_id, im in images.items():
            if max_examples is not None and count >= max_examples:
                break
            path = os.path.join(image_dir, im["file_name"])
            if not os.path.exists(path):
                continue
            with open(path, "rb") as f:
                image_bytes = f.read()
            h, w = im["height"], im["width"]
            boxes, labels, texts, crowd = [], [], [], []
            for ann in anns_by_image.get(image_id, []):
                x, y, bw, bh = ann["bbox"]
                boxes.append([y / h, x / w, (y + bh) / h, (x + bw) / w])
                labels.append(ann["category_id"])
                texts.append(cat_names.get(ann["category_id"], ""))
                crowd.append(int(ann.get("iscrowd", 0)))
            boxes_arr = (np.clip(np.asarray(boxes, np.float32), 0.0, 1.0) if boxes
                         else np.zeros((0, 4), np.float32))
            writer.write(build_example(
                encoded_image=image_bytes, image_format=b"jpeg", height=h, width=w,
                filename=im["file_name"], boxes_norm=boxes_arr, class_labels=labels,
                class_texts=texts, difficult=crowd,  # iscrowd plays the difficult role
            ))
            count += 1
    return count

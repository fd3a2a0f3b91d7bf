"""Pascal VOC devkit -> TFRecord (port of mtlx/data/voc.py; the TF OD
API's create_pascal_tf_record.py and dataset_util): the XML annotations
parsed with ElementTree, each image and its boxes written as one
tf.train.Example by the port's encoder (`example_decoder.build_example`,
`tfrecord.TFRecordWriter`). No masks or keypoints, as in mtlx. The CLI
is mtlx_torch/tools/create_pascal_tf_record.py.
"""

from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from typing import Dict, Optional

import numpy as np

from mtlx_torch.data import tfrecord
from mtlx_torch.data.example_decoder import build_example
from mtlx_torch.utils import label_map_util

VOC_CLASSES = (
    "aeroplane", "bicycle", "bird", "boat", "bottle", "bus", "car", "cat",
    "chair", "cow", "diningtable", "dog", "horse", "motorbike", "person",
    "pottedplant", "sheep", "sofa", "train", "tvmonitor",
)


def recursive_parse_xml_to_dict(node) -> Dict:
    """ElementTree node -> nested dict (dataset_util's helper; the
    repeated `object` children become a list)."""
    if len(node) == 0:
        return {node.tag: node.text}
    result: Dict = {}
    for child in node:
        child_dict = recursive_parse_xml_to_dict(child)
        if child.tag == "object":
            result.setdefault("object", []).append(child_dict["object"])
        else:
            result[child.tag] = child_dict[child.tag]
    return {node.tag: result}


def parse_annotation(xml_path: str) -> Dict:
    return recursive_parse_xml_to_dict(ET.parse(xml_path).getroot())["annotation"]


def objects_to_example(data: Dict, image_bytes: bytes, class_of, label_map: Dict[str, int],
                       ignore_difficult_instances: bool = False) -> bytes:
    """One serialized Example of a parsed annotation; `class_of(obj)` is
    each object's class name. Boxes are normalized by the annotated size;
    difficult objects are dropped with ignore_difficult_instances."""
    width = int(data["size"]["width"])
    height = int(data["size"]["height"])
    boxes, labels, texts, difficult, truncated, poses = [], [], [], [], [], []
    for obj in data.get("object", []):
        diff = int(obj.get("difficult", 0) or 0)
        if ignore_difficult_instances and diff:
            continue
        name = class_of(obj)
        bb = obj["bndbox"]
        boxes.append([float(bb["ymin"]) / height, float(bb["xmin"]) / width,
                      float(bb["ymax"]) / height, float(bb["xmax"]) / width])
        labels.append(label_map[name])
        texts.append(name)
        difficult.append(diff)
        truncated.append(int(obj.get("truncated", 0) or 0))
        poses.append((obj.get("pose", "Unspecified") or "Unspecified").encode())
    boxes = np.asarray(boxes, np.float32) if boxes else np.zeros((0, 4), np.float32)
    return build_example(
        encoded_image=image_bytes, image_format=b"jpeg", height=height, width=width,
        filename=data.get("filename", ""), boxes_norm=boxes, class_labels=labels,
        class_texts=texts, difficult=difficult, truncated=truncated, poses=poses,
    )


def annotation_to_example(data: Dict, image_bytes: bytes, label_map: Dict[str, int],
                          ignore_difficult_instances: bool = False) -> bytes:
    """The serialized Example of one VOC annotation (the class is each
    object's `name`)."""
    return objects_to_example(data, image_bytes, lambda obj: obj["name"], label_map,
                              ignore_difficult_instances)


def load_label_map(label_map_path: Optional[str], classes) -> Dict[str, int]:
    """name -> id from a label map file, or ids 1.. over `classes`."""
    if label_map_path:
        return label_map_util.get_label_map_dict(label_map_path)
    return {name: i + 1 for i, name in enumerate(classes)}


def read_ids(list_path: str):
    """The example ids of an ImageSets / annotations list (first column)."""
    with open(list_path) as f:
        return [line.strip().split()[0] for line in f if line.strip()]


def create_voc_tf_record(data_dir: str, output_path: str, split: str = "train",
                         year: str = "VOC2007", label_map_path: Optional[str] = None,
                         ignore_difficult_instances: bool = False) -> int:
    """Walk a VOCdevkit layout (`<data_dir>/<year>/ImageSets/Main/<split>.txt`,
    `Annotations/`, `JPEGImages/`) and write a TFRecord; returns the
    example count."""
    label_map = load_label_map(label_map_path, VOC_CLASSES)
    root = os.path.join(data_dir, year)
    count = 0
    with tfrecord.TFRecordWriter(output_path) as writer:
        for example_id in read_ids(os.path.join(root, "ImageSets", "Main", f"{split}.txt")):
            data = parse_annotation(os.path.join(root, "Annotations", f"{example_id}.xml"))
            with open(os.path.join(root, "JPEGImages", data["filename"]), "rb") as f:
                image_bytes = f.read()
            writer.write(annotation_to_example(data, image_bytes, label_map,
                                               ignore_difficult_instances))
            count += 1
    return count


def write_label_map(path: str, classes) -> None:
    """A label map text file with ids 1.. over `classes`."""
    with open(path, "w") as f:
        for i, name in enumerate(classes):
            f.write(f"item {{\n  id: {i + 1}\n  name: '{name}'\n}}\n\n")


def write_voc_label_map(path: str) -> None:
    write_label_map(path, VOC_CLASSES)

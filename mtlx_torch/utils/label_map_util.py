"""Label map utilities (port of mtlx/utils/label_map_util.py) on the port's
own text-format reader (config/text_format.py): no protobuf.

Label maps are StringIntLabelMap text protos; ids start at 1 (0 is the
background). Internally class indices are id - 1.
"""

from __future__ import annotations

from typing import Dict, List

from mtlx_torch.config import text_format

LABEL_MAP = "mtlx.protos.StringIntLabelMap"


def load_labelmap(path: str) -> text_format.Message:
    with open(path, "r") as f:
        label_map = text_format.parse(text_format.pipeline_schema(), f.read(), LABEL_MAP)
    for item in label_map.item:
        if item.id < 1:
            raise ValueError(f"label map ids must be >= 1, got {item.id}")
    return label_map


def get_label_map_dict(path: str, use_display_name: bool = False) -> Dict[str, int]:
    """name -> id (1-based)."""
    label_map = load_labelmap(path)
    return {
        (item.display_name if use_display_name else item.name): item.id
        for item in label_map.item
    }


def create_category_index(categories: List[dict]) -> Dict[int, dict]:
    return {cat["id"]: cat for cat in categories}


def convert_label_map_to_categories(
    label_map, max_num_classes: int, use_display_name: bool = True
) -> List[dict]:
    categories = []
    for item in label_map.item:
        if not 0 < item.id <= max_num_classes:
            continue
        name = (
            item.display_name
            if use_display_name and item.HasField("display_name")
            else item.name
        )
        categories.append({"id": item.id, "name": name})
    return categories


def create_category_index_from_labelmap(path: str) -> Dict[int, dict]:
    label_map = load_labelmap(path)
    max_id = max((item.id for item in label_map.item), default=0)
    return create_category_index(
        convert_label_map_to_categories(label_map, max_id)
    )

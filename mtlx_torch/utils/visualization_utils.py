"""Detection visualization (port of mtlx/utils/visualization_utils.py,
whole): boxes, class + score labels, instance masks and keypoints drawn
with PIL's ImageDraw (its default font) on uint8 [H, W, 3] arrays, for
the eval CLI's image summaries and PNG exports. numpy + PIL; PIL is
imported only inside the functions that draw, so importing this module
loads no PIL."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np

STANDARD_COLORS = [
    "AliceBlue", "Chartreuse", "Aqua", "Aquamarine", "Azure", "Beige",
    "Bisque", "BlanchedAlmond", "BlueViolet", "BurlyWood", "CadetBlue",
    "Crimson", "Cyan", "DarkOrange", "DeepPink", "DeepSkyBlue", "DodgerBlue",
    "FireBrick", "Gold", "GreenYellow", "HotPink", "IndianRed", "Khaki",
    "LawnGreen", "LightBlue", "LightCoral", "LightGreen", "LightPink",
    "LightSalmon", "LightSeaGreen", "LightSkyBlue", "Lime", "Magenta",
    "MediumOrchid", "MediumSpringGreen", "Orange", "OrangeRed", "Orchid",
    "PaleGreen", "Plum", "Red", "RoyalBlue", "Salmon", "SpringGreen",
    "Tomato", "Turquoise", "Violet", "Yellow", "YellowGreen",
]


def draw_bounding_box_on_image_array(
    image: np.ndarray,
    ymin: float,
    xmin: float,
    ymax: float,
    xmax: float,
    color: str = "red",
    thickness: int = 2,
    display_str: str = "",
    use_normalized_coordinates: bool = True,
) -> None:
    """Draw one box (in place) on a uint8 [H, W, 3] array."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    h, w = image.shape[:2]
    if use_normalized_coordinates:
        ymin, xmin, ymax, xmax = ymin * h, xmin * w, ymax * h, xmax * w
    draw.rectangle([(xmin, ymin), (xmax, ymax)], outline=color, width=thickness)
    if display_str:
        ty = max(ymin - 12, 0)
        draw.text((xmin + 2, ty), display_str, fill=color)
    np.copyto(image, np.asarray(pil))


def paste_instance_masks(
    masks: np.ndarray,
    boxes: np.ndarray,
    image_height: int,
    image_width: int,
    threshold: float = 0.5,
) -> np.ndarray:
    """Reframe [N, mh, mw] box-relative mask crops into [N, H, W] binary
    image-space masks (reference utils/ops.py
    reframe_box_masks_to_image_masks semantics, numpy/PIL for the eval
    visualization path). `boxes` are normalized [ymin, xmin, ymax, xmax]."""
    from PIL import Image

    n = len(masks)
    out = np.zeros((n, image_height, image_width), bool)
    for i in range(n):
        ymin, xmin, ymax, xmax = boxes[i]
        y0 = int(np.clip(round(ymin * image_height), 0, image_height))
        y1 = int(np.clip(round(ymax * image_height), 0, image_height))
        x0 = int(np.clip(round(xmin * image_width), 0, image_width))
        x1 = int(np.clip(round(xmax * image_width), 0, image_width))
        bh, bw = y1 - y0, x1 - x0
        if bh <= 0 or bw <= 0:
            continue
        resized = np.asarray(
            Image.fromarray((masks[i] * 255).astype(np.uint8), "L")
            .resize((bw, bh), Image.BILINEAR)
        )
        out[i, y0:y1, x0:x1] = resized > int(threshold * 255)
    return out


def draw_mask_on_image_array(
    image: np.ndarray,
    mask: np.ndarray,
    color: str = "red",
    alpha: float = 0.4,
) -> None:
    """Alpha-blend a binary instance mask onto a uint8 [H, W, 3] array in
    place (reference draw_mask_on_image_array). `mask` is [h, w] in {0, 1}
    (any resolution — resized to the image with nearest neighbor)."""
    from PIL import Image, ImageColor

    if mask.shape[:2] != image.shape[:2]:
        mask = np.asarray(
            Image.fromarray((np.asarray(mask) > 0.5).astype(np.uint8) * 255, "L")
            .resize((image.shape[1], image.shape[0]), Image.NEAREST)
        ) > 127
    rgb = np.asarray(ImageColor.getrgb(color), np.float32)
    m = (np.asarray(mask) > 0.5)[..., None].astype(np.float32)
    blended = image.astype(np.float32) * (1 - alpha * m) + rgb * (alpha * m)
    np.copyto(image, blended.astype(np.uint8))


def draw_keypoints_on_image_array(
    image: np.ndarray,
    keypoints: np.ndarray,
    color: str = "red",
    radius: int = 2,
    use_normalized_coordinates: bool = True,
) -> None:
    """Draw [P, 2] (y, x) keypoints as filled circles in place (reference
    draw_keypoints_on_image_array)."""
    from PIL import Image, ImageDraw

    pil = Image.fromarray(image)
    draw = ImageDraw.Draw(pil)
    h, w = image.shape[:2]
    for y, x in np.asarray(keypoints, np.float32):
        if use_normalized_coordinates:
            y, x = y * h, x * w
        draw.ellipse(
            [(x - radius, y - radius), (x + radius, y + radius)],
            fill=color, outline=color,
        )
    np.copyto(image, np.asarray(pil))


def visualize_boxes_and_labels_on_image_array(
    image: np.ndarray,
    boxes: np.ndarray,
    classes: np.ndarray,
    scores: Optional[np.ndarray],
    category_index: Dict[int, dict],
    instance_masks: Optional[np.ndarray] = None,
    keypoints: Optional[np.ndarray] = None,
    use_normalized_coordinates: bool = True,
    max_boxes_to_draw: int = 20,
    min_score_thresh: float = 0.5,
    line_thickness: int = 2,
) -> np.ndarray:
    """Reference-parity entry point: draws top boxes with class + score
    labels — and, when given, per-detection instance masks ([N, h, w]) and
    keypoints ([N, P, 2]) — onto `image` (modified in place, also
    returned)."""
    n = min(len(boxes), max_boxes_to_draw)
    for i in range(n):
        if scores is not None and scores[i] < min_score_thresh:
            continue
        cls = int(classes[i])
        name = category_index.get(cls, {}).get("name", f"id {cls}")
        label = name if scores is None else f"{name}: {int(100 * scores[i])}%"
        color = STANDARD_COLORS[cls % len(STANDARD_COLORS)]
        if instance_masks is not None:
            draw_mask_on_image_array(image, instance_masks[i], color=color)
        draw_bounding_box_on_image_array(
            image,
            *boxes[i],
            color=color,
            thickness=line_thickness,
            display_str=label,
            use_normalized_coordinates=use_normalized_coordinates,
        )
        if keypoints is not None:
            draw_keypoints_on_image_array(
                image, keypoints[i], color=color,
                use_normalized_coordinates=use_normalized_coordinates,
            )
    return image

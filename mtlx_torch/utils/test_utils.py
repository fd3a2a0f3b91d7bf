"""Mocks and fixtures for tests of the detectors' parts (port of
mtlx/utils/test_utils.py, the reference's utils/test_utils.py): a coder,
an anchor generator and a matcher whose outputs are trivial to compute by
hand, a deterministic image and seeded boxes."""

from __future__ import annotations

import numpy as np
import torch

from mtlx_torch.coders.box_coders import BoxCoder


def mock_box_coder() -> BoxCoder:
    """encode = box - anchor, decode = code + anchor."""
    return BoxCoder(encode=lambda boxes, anchors: boxes - anchors,
                    decode=lambda codes, anchors: codes + anchors, code_size=4)


class MockAnchorGenerator:
    """The same anchors for every feature map shape."""

    num_anchors_per_location = 1

    def __init__(self, anchors=None):
        if anchors is None:
            anchors = [[0.0, 0.0, 10.0, 10.0], [0.0, 10.0, 10.0, 20.0]]
        self._anchors = torch.as_tensor(anchors, dtype=torch.float32)

    def generate(self, feature_map_shape):
        return self._anchors


def mock_matcher(match_results):
    """A matcher that returns the given int32 match vector."""
    fixed = torch.as_tensor(match_results, dtype=torch.int32)

    def match(similarity, row_mask=None, **kw):
        return fixed

    return match


def create_diagonal_gradient_image(height: int, width: int, depth: int) -> np.ndarray:
    """A float32 [H, W, depth] image rising towards the top-left corner,
    channel d scaled by d + 1."""
    row = np.arange(width, 0, -1, dtype=np.float32)
    col = np.arange(height, 0, -1, dtype=np.float32)[:, None]
    base = (row + col) / (width + height)
    return np.stack([base * (d + 1) for d in range(depth)], axis=-1)


def create_random_boxes(num_boxes: int, max_height: float, max_width: float,
                        seed: int = 0) -> np.ndarray:
    """Seeded float32 [N, 4] boxes inside (max_height, max_width)."""
    rs = np.random.RandomState(seed)
    ymin = rs.uniform(0, max_height, num_boxes)
    xmin = rs.uniform(0, max_width, num_boxes)
    h = rs.uniform(1, max_height / 2, num_boxes)
    w = rs.uniform(1, max_width / 2, num_boxes)
    return np.stack([ymin, xmin, np.minimum(ymin + h, max_height),
                     np.minimum(xmin + w, max_width)], axis=1).astype(np.float32)

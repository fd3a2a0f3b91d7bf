"""Weight bridge: mtlx's flax variables -> the port's `state_dict`.

Takes `{"params": ..., "batch_stats": ...}` as nested dicts of numpy
arrays (what `mtlx.detector.faster_rcnn.FasterRCNN.init_variables`
returns, or a restored checkpoint) and returns a `state_dict` for
`FasterRCNNModules` (or `RFCNModules`, or `SSDModules`). The module paths
are the same on both sides, for the ResNet, both Inception trunks and
MobileNet alike (mtlx names every module), so the map is path to path:

  * conv `kernel` HWIO -> `weight` OIHW (a depthwise [3, 3, 1, C] kernel
    becomes the grouped conv's [C, 1, 3, 3]); the mask head's transpose
    conv (`mask_head/upsample`) HWIO -> IOHW, flipped in both spatial
    axes (flax's nn.ConvTranspose without transpose_kernel correlates
    with the kernel as it is, PyTorch's transpose conv with it flipped)
  * dense `kernel` [in, out] -> `weight` [out, in]
  * `bias` -> `bias`
  * batch-norm `scale`/`bias` (params) -> the FrozenBatchNorm (or
    LiveBatchNorm) parameters of the same names, and `mean`/`var`
    (batch_stats) -> its buffers
  * LayerNorm `scale`/`bias` (the aux heads) -> the same names

The MTL auxiliary heads (`fg_head`, `mo_head`, `cl_head`) exist in a
training model, and in a serving model on the MTL refine path (mtlx's
builder keeps them at eval when `mtl.refine` is set): they are mapped
with `training_heads=True` and skipped otherwise, so an MTL checkpoint
also loads into a serving model without refine. The box predictor's
kernels map at whatever width they have (wider on the refine path), and
a live batch norm's `batch_stats` as a frozen one's, in both trunks. Any
other leaf raises, so a variable tree the port cannot hold never loads
half-mapped.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# top-level flax modules of every model (serving and training); an R-FCN
# has rfcn_predictor where a Faster R-CNN has box_predictor, a Mask R-CNN
# also mask_head, and an SSD has extra and one box_predictor_{i} a
# feature map
INFERENCE_MODULES = ("backbone", "classifier_backbone", "rpn", "box_predictor",
                     "rfcn_predictor", "extra", "mask_head")
# flax nn.ConvTranspose modules, mapped to nn.ConvTranspose2d
TRANSPOSE_CONVS = ("mask_head/upsample",)
_SSD_PREDICTOR = re.compile(r"^box_predictor_\d+$")


def is_inference_module(top: str) -> bool:
    """Whether `top` is a top-level flax module of a serving model."""
    return top in INFERENCE_MODULES or bool(_SSD_PREDICTOR.match(top))
# top-level flax modules of a training model and of a refining serving
# model (the MTL auxiliary heads)
TRAINING_ONLY_MODULES = ("fg_head", "mo_head", "cl_head")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], object]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (key,))
        else:
            yield prefix + (key,), value


def flax_to_state_dict(variables: Mapping, training_heads: bool = False
                       ) -> Dict[str, torch.Tensor]:
    """Map flax variables to the port's state_dict (float32 CPU tensors);
    the aux heads' leaves only with training_heads (a training model, or
    a serving model whose config refines: `cfg.mtl.any` tells whether the
    port's model holds them)."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected variable collection {collection!r}")
        for path, leaf in _leaves(tree):
            top, name = path[0], path[-1]
            where = "/".join((collection,) + path)
            if top in TRAINING_ONLY_MODULES and not training_heads:
                continue
            if not is_inference_module(top) and top not in TRAINING_ONLY_MODULES:
                raise ValueError(f"no counterpart in the port for {where}")
            arr = np.asarray(leaf, dtype=np.float32)
            module = ".".join(path[:-1])
            if collection == "batch_stats":
                if name not in ("mean", "var"):
                    raise ValueError(f"unexpected batch statistic {where}")
            elif name == "kernel":
                name = "weight"
                if arr.ndim == 4 and "/".join(path[:-1]) in TRANSPOSE_CONVS:
                    arr = arr[::-1, ::-1].transpose(2, 3, 0, 1)  # HWIO -> IOHW, flipped
                elif arr.ndim == 4:  # conv HWIO -> OIHW
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:  # dense [in, out] -> [out, in]
                    arr = arr.T
                else:
                    raise ValueError(f"unexpected kernel rank {arr.ndim} at {where}")
            elif name not in ("bias", "scale"):
                raise ValueError(f"unexpected parameter {where}")
            out[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return out

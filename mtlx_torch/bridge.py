"""Weight bridge: mtlx's flax variables -> the port's `state_dict`.

Takes `{"params": ..., "batch_stats": ...}` as nested dicts of numpy
arrays (what `mtlx.detector.faster_rcnn.FasterRCNN.init_variables`
returns, or a restored checkpoint) and returns a `state_dict` for
`FasterRCNNModules`. The module paths are the same on both sides, so
the map is path to path:

  * conv `kernel` HWIO -> `weight` OIHW
  * dense `kernel` [in, out] -> `weight` [out, in]
  * `bias` -> `bias`
  * batch-norm `scale`/`bias` (params) -> the FrozenBatchNorm parameters
    of the same names, and `mean`/`var` (batch_stats) -> its buffers
  * LayerNorm `scale`/`bias` (the aux heads) -> the same names

The MTL auxiliary heads (`fg_head`, `mo_head`, `cl_head`) exist only in
a training model: they are mapped with `training_heads=True` and skipped
otherwise, so an MTL checkpoint also loads into a serving model. Any
other leaf raises, so a variable tree the port cannot hold never loads
half-mapped.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# top-level flax modules of every model (serving and training)
INFERENCE_MODULES = ("backbone", "classifier_backbone", "rpn", "box_predictor")
# top-level flax modules of a training model only (the MTL auxiliary heads)
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
    the aux heads' leaves only with training_heads."""
    out: Dict[str, torch.Tensor] = {}
    for collection, tree in variables.items():
        if collection not in ("params", "batch_stats"):
            raise ValueError(f"unexpected variable collection {collection!r}")
        for path, leaf in _leaves(tree):
            top, name = path[0], path[-1]
            where = "/".join((collection,) + path)
            if top in TRAINING_ONLY_MODULES and not training_heads:
                continue
            if top not in INFERENCE_MODULES + TRAINING_ONLY_MODULES:
                raise ValueError(f"no counterpart in the port for {where}")
            arr = np.asarray(leaf, dtype=np.float32)
            module = ".".join(path[:-1])
            if collection == "batch_stats":
                if name not in ("mean", "var"):
                    raise ValueError(f"unexpected batch statistic {where}")
            elif name == "kernel":
                name = "weight"
                if arr.ndim == 4:  # conv HWIO -> OIHW
                    arr = arr.transpose(3, 2, 0, 1)
                elif arr.ndim == 2:  # dense [in, out] -> [out, in]
                    arr = arr.T
                else:
                    raise ValueError(f"unexpected kernel rank {arr.ndim} at {where}")
            elif name not in ("bias", "scale"):
                raise ValueError(f"unexpected parameter {where}")
            out[f"{module}.{name}"] = torch.from_numpy(np.ascontiguousarray(arr))
    return out

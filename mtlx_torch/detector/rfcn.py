"""R-FCN (port of mtlx/detector/rfcn.py): Faster R-CNN with the second
stage replaced by position-sensitive score maps. The box classifier
features (ResNet block4 at stride 1) run once over the whole stride-16
map, the predictor's 1x1 convs make the class and box score maps, and
each proposal takes the position-sensitive crop of both
(mtlx_torch/heads/box_predictors.py RfcnBoxPredictor).

On the card the second stage is two launches of the crop kernel (the
class maps and the box maps, every spatial bin of every image in one
launch each) and, in training, two of its backward kernel. The RPN, the
proposal sampling, the losses, the MTL aux heads (mean-pooled windows of
the stride-16 map) and the postprocess are Faster R-CNN's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

from torch import Tensor

from mtlx_torch.detector.faster_rcnn import FasterRCNN, FasterRCNNConfig, FasterRCNNModules
from mtlx_torch.device import DeviceLike
from mtlx_torch.heads.box_predictors import RfcnBoxPredictor


@dataclasses.dataclass(frozen=True)
class RFCNConfig(FasterRCNNConfig):
    num_spatial_bins: Tuple[int, int] = (3, 3)
    rfcn_depth: int = 1024
    rfcn_crop_size: Tuple[int, int] = (12, 12)


class RFCNModules(FasterRCNNModules):
    """FasterRCNNModules with `rfcn_predictor` in place of the box
    predictor (mtlx's tree has no box_predictor for R-FCN)."""

    def _second_stage_head(self, cfg: RFCNConfig, width: int) -> None:
        self.rfcn_predictor = RfcnBoxPredictor(
            width, cfg.num_classes, cfg.num_spatial_bins, cfg.rfcn_depth,
            cfg.rfcn_crop_size, cfg.dtype,
        )

    def rfcn_predictions(self, feats: Tensor, norm_proposals: Tensor):
        """The box classifier features image-wide, then the predictor."""
        return self.rfcn_predictor(self.classifier_backbone(feats), norm_proposals)


class RFCN(FasterRCNN):
    modules_class = RFCNModules

    def __init__(self, cfg: RFCNConfig, device: DeviceLike = None):
        if cfg.mtl.refine:
            # the refine path fuses aux hidden features into the per-ROI
            # FC predictor; R-FCN has no per-ROI features to fuse into
            raise ValueError(
                "mtl.refine is not supported by the R-FCN meta-arch "
                "(no per-ROI feature stack to refine); disable refine "
                "or use faster_rcnn"
            )
        super().__init__(cfg, device)

    def _second_stage(self, feats: Tensor, proposals: Tensor,
                      canvas_hw: Optional[Tuple[int, int]] = None,
                      dropout: Optional[Tensor] = None):
        """Position-sensitive second stage, for training and (through
        `_predict_second_stage`) serving: (class_predictions [B, P, K+1],
        refined_box_encodings [B, P, K, 4], None), float32. R-FCN has no
        dropout (its config never sets second_stage_dropout) and no mask
        head."""
        cls, box = self.modules.rfcn_predictions(feats, self._normalized(proposals, canvas_hw))
        return cls, box, None

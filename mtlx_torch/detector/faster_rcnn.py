"""Faster R-CNN with the MTL-SSL auxiliary tasks (port of
mtlx/detector/faster_rcnn.py): serving (`predict`, `postprocess`) and
training (`predict_train`, `loss`).

Coordinate convention: absolute pixels on the compute canvas inside
predict; `postprocess` re-expresses detections normalized to each image's
true (pre-padding) extent, as in `mtlx`. The compute canvas is the input
extent (the 128-bucketed true-image region), and the anchor grid derives
from it.

On the card the RPN NMS and the postprocess NMS are one launch each of
the greedy NMS kernel, and the ROI crop is one launch of the crop kernel
(mtlx_torch/kernels). A training step adds three launches of the IoU
kernel (proposal sampling, and the RPN and second-stage target
assignments) and one of the crop's backward kernel.

Instance masks (predict_instance_masks, Mask R-CNN's mask head on the
box classifier's unpooled features): the postprocess carries each
proposal's per-class mask logits through the NMS as an extra field, and
the training step's mask loss adds one IoU launch (the proposals'
re-assignment) and one crop launch (the matched ground-truth masks cut
to 14x14, all B x P in one).

Serving runs under `torch.inference_mode()`; training keeps mtlx's
stop-gradients: the RPN outputs enter the proposal selection detached,
so NMS is never differentiated, and proposals, ground-truth windows,
labels and targets are constants.

The MTL refine path (mtl.refine with the multi-object or closeness
task): the aux heads also run on every proposal's window, mean-pooled
7x7 from the stride-16 map, and their hidden activations are
concatenated to the pooled box classifier features before the box
predictor, in serving and in training. It adds no kernel launch (the
mean pool is two contractions).

Training options: live batch norm (batch_norm_trainable) runs both
trunks on the batch's statistics, the second on the B x P ROI crops;
second-stage dropout drops the box predictor's input; the hard example
miner (losses.hard_example_mining_mask) keeps the hardest sampled ROIs
of each image in the second-stage loss, one more NMS launch a step
without a negatives cap, one more IoU launch with one.

Spatial partitioning (parallel/spatial.py): with `spatial` set to a
SpatialMesh, the images are this rank's H-slab, the trunk runs on it
with halo exchanges, and its output is gathered into the whole stride-16
map; everything after the trunk sees the whole canvas.

Randomness: mtlx draws `jax.random.uniform` inside the step. The port
takes the draws as a dict of tensors (`mtlx_torch.train.train_step
.make_draws` makes them; a test can inject JAX's):
  * "proposal_pos", "proposal_neg": [B, first_stage_max_proposals], the
    second-stage proposal sampler
  * "anchor_pos", "anchor_neg": [B, A], the RPN minibatch sampler
  * "window_scale", "window_offset": [B, G, 2], only with
    mtl.window_sampling
  * "dropout": [B * second_stage_batch_size, D], the box predictor's
    dropout, only with second_stage_dropout (D: `dropout_shape`)
"""

from __future__ import annotations

import dataclasses
import struct
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from mtlx_torch.anchors.grid import GridAnchorGenerator
from mtlx_torch.assign import matcher as matcher_lib
from mtlx_torch.assign import samplers, target_assigner
from mtlx_torch.backbones import inception_resnet_v2 as irv2
from mtlx_torch.backbones import inception_v2 as iv2
from mtlx_torch.backbones import resnet
from mtlx_torch.coders import box_coders
from mtlx_torch.device import DeviceLike, resolve_device
from mtlx_torch.geometry import box_ops
from mtlx_torch.heads import aux_heads, box_predictors
from mtlx_torch.labels import recycle
from mtlx_torch.losses import losses as loss_lib
from mtlx_torch.ops import nms as nms_lib
from mtlx_torch.ops import roi as roi_lib
from mtlx_torch.parallel import spatial as spatial_lib


@dataclasses.dataclass(frozen=True)
class MTLConfig:
    """MTL-SSL auxiliary task switches + loss weights."""

    multiobject: bool = False
    closeness: bool = False
    foreground: bool = False
    multiobject_weight: float = 1.0
    closeness_weight: float = 1.0
    foreground_weight: float = 1.0
    window_enlarge_factor: float = 2.0
    closeness_sigma: float = 0.5
    window_sampling: bool = False
    refine: bool = False  # paper's feature-refinement path

    @property
    def any(self) -> bool:
        return self.multiobject or self.closeness or self.foreground

    @property
    def refines(self) -> bool:
        """Whether the refine path runs: it fuses the multi-object and
        closeness heads' hidden activations, so it needs one of them."""
        return self.refine and (self.multiobject or self.closeness)


@dataclasses.dataclass(frozen=True)
class FasterRCNNConfig:
    """The fields of mtlx's FasterRCNNConfig. Initializers are specs, not
    functions: ("truncated_normal", stddev) or ("variance_scaling", scale,
    mode, distribution); None is flax's default (lecun_normal)."""

    num_classes: int = 20
    canvas_size: Tuple[int, int] = (1024, 1024)  # largest compute canvas
    backbone: str = "resnet50"
    feature_stride: int = 16
    # first stage (RPN)
    anchor_scales: Tuple[float, ...] = (0.25, 0.5, 1.0, 2.0)
    anchor_aspect_ratios: Tuple[float, ...] = (0.5, 1.0, 2.0)
    anchor_base_size: Tuple[float, float] = (256.0, 256.0)
    rpn_depth: int = 512
    first_stage_nms_score_threshold: float = 0.0
    first_stage_nms_iou_threshold: float = 0.7
    first_stage_pre_nms_top_k: int = 6000
    first_stage_max_proposals: int = 300
    first_stage_minibatch_size: int = 256
    first_stage_positive_balance_fraction: float = 0.5
    first_stage_localization_loss_weight: float = 2.0
    first_stage_objectness_loss_weight: float = 1.0
    # ROI pooling
    initial_crop_size: int = 14
    maxpool_kernel_size: int = 2
    maxpool_stride: int = 2
    # second stage
    second_stage_batch_size: int = 64
    second_stage_balance_fraction: float = 0.25
    second_stage_nms_score_threshold: float = 0.0
    second_stage_nms_iou_threshold: float = 0.6
    second_stage_max_detections_per_class: int = 100
    second_stage_max_total_detections: int = 300
    second_stage_localization_loss_weight: float = 2.0
    second_stage_classification_loss_weight: float = 1.0
    second_stage_dropout: bool = False
    second_stage_dropout_keep_prob: float = 1.0
    score_converter: str = "softmax"  # softmax | sigmoid | identity
    predict_instance_masks: bool = False
    mask_prediction_conv_depth: int = 256
    second_stage_mask_prediction_loss_weight: float = 1.0
    rpn_kernel_size: int = 3
    rpn_conv_initializer: Any = None
    rpn_atrous_rate: int = 1
    second_stage_fc_initializer: Any = None
    hard_example_miner: Any = None
    backbone_remat: bool = False  # ResNet trunks: recompute each bottleneck in backward
    conv0_space_to_depth: bool = False
    batch_norm_trainable: bool = False
    batch_norm_params: Any = None  # (decay, epsilon, center, scale) or None
    slim_stride_order: bool = False
    number_of_stages: int = 2  # 1 = RPN-only
    max_gt_boxes: int = 100
    dtype: Any = torch.bfloat16
    mtl: MTLConfig = dataclasses.field(default_factory=MTLConfig)

    @property
    def resnet_depth(self) -> int:
        return {"resnet10": 10, "resnet50": 50, "resnet101": 101,
                "resnet152": 152}.get(self.backbone, 50)


def _f32(x: float) -> float:
    """x as a float proto field holds it (rounded to float32)."""
    return struct.unpack("f", struct.pack("f", x))[0]


def flagship_config(dtype=torch.bfloat16) -> FasterRCNNConfig:
    """The FasterRCNNConfig that configs/faster_rcnn_resnet50_mtl_voc0712.config
    builds to at is_training=False (the MTL heads are training-only, so
    serving runs the detection-only R50). Needs no protobuf; a test holds
    it equal to the parsed file."""
    return FasterRCNNConfig(
        num_classes=20,
        canvas_size=(1024, 1024),
        backbone="resnet50",
        feature_stride=16,
        anchor_scales=(0.25, 0.5, 1.0, 2.0),
        anchor_aspect_ratios=(0.5, 1.0, 2.0),
        anchor_base_size=(256.0, 256.0),
        rpn_depth=512,
        rpn_kernel_size=3,
        rpn_atrous_rate=1,
        rpn_conv_initializer=("truncated_normal", _f32(0.01)),
        first_stage_nms_score_threshold=0.0,
        first_stage_nms_iou_threshold=_f32(0.7),
        first_stage_max_proposals=300,
        first_stage_minibatch_size=256,
        first_stage_positive_balance_fraction=0.5,
        first_stage_localization_loss_weight=2.0,
        first_stage_objectness_loss_weight=1.0,
        initial_crop_size=14,
        maxpool_kernel_size=2,
        maxpool_stride=2,
        second_stage_batch_size=64,
        second_stage_balance_fraction=0.25,
        second_stage_nms_score_threshold=0.0,
        second_stage_nms_iou_threshold=_f32(0.6),
        second_stage_max_detections_per_class=100,
        second_stage_max_total_detections=300,
        second_stage_localization_loss_weight=2.0,
        second_stage_classification_loss_weight=1.0,
        second_stage_dropout=False,
        second_stage_dropout_keep_prob=1.0,
        second_stage_fc_initializer=("variance_scaling", 1.0, "fan_avg", "uniform"),
        score_converter="softmax",
        number_of_stages=2,
        max_gt_boxes=100,
        dtype=dtype,
        mtl=MTLConfig(),
    )


def flagship_train_config(dtype=torch.bfloat16) -> FasterRCNNConfig:
    """The FasterRCNNConfig that configs/faster_rcnn_resnet50_mtl_voc0712.config
    builds to at is_training=True: the serving config plus the three MTL
    tasks (multi-object window 0.3, closeness 0.3, foreground mask 0.5).
    Needs no protobuf; a test holds it equal to the parsed file."""
    return dataclasses.replace(
        flagship_config(dtype),
        mtl=MTLConfig(
            multiobject=True, closeness=True, foreground=True,
            multiobject_weight=_f32(0.3), closeness_weight=_f32(0.3),
            foreground_weight=0.5, window_enlarge_factor=2.0, closeness_sigma=0.5,
        ),
    )


_F32_TINY = torch.finfo(torch.float32).tiny


def _flush_subnormal(p: Tensor) -> Tensor:
    """Zero the subnormal values of a non-negative score tensor, as XLA
    does on the CPU and the TPU: a score threshold of 0 must drop a
    probability that underflowed in mtlx, whatever device runs the port."""
    return torch.where(p < _F32_TINY, 0.0, p)


def softmax(logits: Tensor) -> Tensor:
    """jax.nn.softmax over the last axis as mtlx computes it:
    exp(x - max) / sum, subnormal results flushed to zero."""
    e = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    return _flush_subnormal(e / e.sum(dim=-1, keepdim=True))


def make_trunk(cfg: FasterRCNNConfig) -> Tuple[nn.Module, nn.Module]:
    """The backbone's proposal and box classifier features, as mtlx's
    FasterRCNNModules.setup dispatches on cfg.backbone; each carries its
    output width (`out_channels`)."""
    if cfg.backbone in ("inception_resnet_v2", "inception_v2"):
        bn = irv2.BNKnobs(cfg.batch_norm_trainable,
                          resnet.BNSpec(*cfg.batch_norm_params)
                          if cfg.batch_norm_params is not None else irv2.INCEPTION_BN)
        if cfg.backbone == "inception_resnet_v2":
            return (irv2.InceptionResnetV2ProposalFeatures(cfg.dtype, bn),
                    irv2.InceptionResnetV2BoxClassifierFeatures(cfg.dtype, bn))
        return (iv2.InceptionV2ProposalFeatures(dtype=cfg.dtype, bn=bn),
                iv2.InceptionV2BoxClassifierFeatures(dtype=cfg.dtype, bn=bn))
    # any other name builds the ResNet of resnet_depth (50 for an unknown
    # name), as mtlx's does
    bn = (resnet.BNSpec(*cfg.batch_norm_params)
          if cfg.batch_norm_params is not None else resnet.BNSpec())
    depth = cfg.resnet_depth
    return (resnet.ResNetProposalFeatures(depth, cfg.dtype, cfg.batch_norm_trainable,
                                          cfg.slim_stride_order, cfg.conv0_space_to_depth, bn,
                                          cfg.backbone_remat),
            resnet.ResNetBoxClassifierFeatures(depth, cfg.dtype, cfg.batch_norm_trainable,
                                               cfg.slim_stride_order, bn, cfg.backbone_remat))


class FasterRCNNModules(nn.Module):
    """All parameters of the detector, named as mtlx's flax modules:
    backbone, classifier_backbone, rpn, box_predictor, and the MTL heads
    fg_head, mo_head, cl_head when their tasks are on. The RPN and the
    aux heads read the backbone's stride-16 map, the box predictor the
    pooled box classifier features: their widths are the trunk's. On the
    refine path the box predictor's input also holds the multi-object and
    closeness heads' hidden activations (1024 each)."""

    def __init__(self, cfg: FasterRCNNConfig):
        super().__init__()
        self.refines = cfg.mtl.refines
        self.backbone, self.classifier_backbone = make_trunk(cfg)
        width = self.backbone.out_channels
        self.rpn = box_predictors.RPNHead(
            width, len(cfg.anchor_scales) * len(cfg.anchor_aspect_ratios),
            cfg.rpn_depth, cfg.rpn_kernel_size, cfg.rpn_atrous_rate, cfg.dtype,
        )
        aux_width = aux_heads.HIDDEN * (cfg.mtl.multiobject + cfg.mtl.closeness)
        self._second_stage_head(
            cfg, self.classifier_backbone.out_channels + (aux_width if self.refines else 0))
        # the aux heads read the stride-16 map and windows mean-pooled from it
        if cfg.mtl.foreground:
            self.fg_head = aux_heads.ForegroundHead(width, dtype=cfg.dtype)
        if cfg.mtl.multiobject:
            self.mo_head = aux_heads.MultiObjectHead(width, cfg.num_classes, dtype=cfg.dtype)
        if cfg.mtl.closeness:
            self.cl_head = aux_heads.ClosenessHead(width, cfg.num_classes, dtype=cfg.dtype)

    def _second_stage_head(self, cfg: FasterRCNNConfig, width: int) -> None:
        self.box_predictor = box_predictors.MaskRCNNBoxPredictor(
            width, cfg.num_classes, cfg.dtype, cfg.second_stage_dropout,
            cfg.second_stage_dropout_keep_prob,
        )
        if cfg.predict_instance_masks:  # on the unpooled box classifier features
            self.mask_head = box_predictors.MaskHead(
                self.classifier_backbone.out_channels, cfg.num_classes,
                cfg.mask_prediction_conv_depth, cfg.dtype)

    def classify_rois(self, roi_crops: Tensor, aux_hidden: Optional[Tensor] = None,
                      dropout: Optional[Tensor] = None):
        """[N, h, w, C] ROI crops -> box classifier features -> mean pool
        (-> the refine path's aux_hidden [N, D] concatenated) -> (class
        logits [N, K+1], box refinements [N, K, 4], mask logits [N, 2h',
        2w', K] of the mask head on the unpooled features, or None without
        one). dropout: the box predictor's draws, in training with
        second_stage_dropout."""
        x = self.classifier_backbone(roi_crops)
        pooled = x.float().mean(dim=(1, 2))
        if aux_hidden is not None:
            pooled = torch.cat([pooled, aux_hidden], dim=-1)
        cls, box = self.box_predictor(pooled, dropout)
        masks = self.mask_head(x) if hasattr(self, "mask_head") else None
        return cls, box, masks

    def aux_hidden_for_rois(self, pooled_rpn: Tensor) -> Tensor:
        """The refine vector of each ROI: the multi-object and closeness
        heads' hidden activations on its pooled window of the stride-16 map
        [N, C], in float32 and concatenated in that order -> [N, D]."""
        hiddens = []
        if hasattr(self, "mo_head"):
            hiddens.append(self.mo_head.hidden(pooled_rpn).float())
        if hasattr(self, "cl_head"):
            hiddens.append(self.cl_head.hidden(pooled_rpn).float())
        return torch.cat(hiddens, dim=-1)


def _init_(t: Tensor, spec, fan_in: int, fan_out: int, gen: torch.Generator) -> None:
    """Fill t in place as the flax initializer `spec` would (the same
    distribution, not the same numbers)."""
    if spec is None:
        spec = ("variance_scaling", 1.0, "fan_in", "truncated_normal")  # lecun_normal
    if spec[0] == "truncated_normal":
        std = spec[1]
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)
        return
    _, scale, mode, dist = spec
    n = {"fan_in": fan_in, "fan_out": fan_out, "fan_avg": (fan_in + fan_out) / 2}[mode]
    var = scale / max(n, 1.0)
    if dist == "uniform":
        lim = (3 * var) ** 0.5
        nn.init.uniform_(t, -lim, lim, generator=gen)
    else:  # truncated normal at +-2 std, variance corrected as in jax
        std = var ** 0.5 / 0.87962566103423978
        nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


class FasterRCNN:
    """Two-stage detector around FasterRCNNModules, on one device.
    `device=None` means the CUDA device (raises without one)."""

    modules_class = FasterRCNNModules
    spatial = None  # a parallel.spatial.SpatialMesh: the images are H-slabs

    def __init__(self, cfg: FasterRCNNConfig, device: DeviceLike = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.modules = self.modules_class(cfg).to(self.device).eval()
        if self.device.type == "cuda":
            self.modules.to(memory_format=torch.channels_last)
        self._anchor_gen = GridAnchorGenerator(
            scales=cfg.anchor_scales,
            aspect_ratios=cfg.anchor_aspect_ratios,
            base_anchor_size=cfg.anchor_base_size,
            anchor_stride=(float(cfg.feature_stride),) * 2,
        )
        self._anchor_cache: Dict[Tuple[int, int], Tensor] = {}
        self.box_coder = box_coders.make_faster_rcnn_coder()
        self._proposal_assigner = target_assigner.create_target_assigner(
            "FasterRCNN", "proposal"
        )
        self._detection_assigner = target_assigner.create_target_assigner(
            "FasterRCNN", "detection"
        )

    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights from `generator` (a CPU generator), drawn as
        mtlx's flax init draws them: convs and dense layers from their
        configured initializers (lecun_normal by default), biases 0, batch
        norm at scale 1, offset 0, mean 0, variance 1."""
        c = self.cfg
        state = {}
        for name, t in self.modules.state_dict().items():
            w = torch.empty(t.shape, dtype=torch.float32)
            if name.endswith("weight"):
                spec = None
                if name.startswith("rpn."):
                    spec = c.rpn_conv_initializer
                elif name.startswith("box_predictor."):
                    spec = c.second_stage_fc_initializer
                receptive = w[0, 0].numel() if w.dim() == 4 else 1
                fan_in, fan_out = w.shape[1] * receptive, w.shape[0] * receptive
                module = self.modules.get_submodule(name.rsplit(".", 1)[0])
                if isinstance(module, nn.ConvTranspose2d):  # weight [in, out, kh, kw]
                    fan_in, fan_out = fan_out, fan_in
                _init_(w, spec, fan_in, fan_out, generator)
            elif name.endswith((".scale", ".var")):
                w.fill_(1.0)
            else:
                w.zero_()
            state[name] = w
        self.modules.load_state_dict(state)

    def to(self, device: DeviceLike) -> "FasterRCNN":
        self.device = resolve_device(device)
        self.modules.to(self.device)
        if self.device.type == "cuda":
            self.modules.to(memory_format=torch.channels_last)
        self._anchor_cache.clear()
        return self

    def anchors_for(self, canvas_hw: Tuple[int, int]) -> Tensor:
        """Anchor grid for a compute canvas of (h, w) pixels, clipped to
        it; cached per canvas on the model's device. Made outside
        inference mode (and without autograd), so serving and training
        share the cache: an inference tensor could not be saved for a
        backward pass."""
        key = (int(canvas_hw[0]), int(canvas_hw[1]))
        hit = self._anchor_cache.get(key)
        if hit is None:
            with torch.inference_mode(False), torch.no_grad():
                s = self.cfg.feature_stride
                raw = self._anchor_gen.generate((-(-key[0] // s), -(-key[1] // s)))
                window = torch.tensor([0.0, 0.0, float(key[0]), float(key[1])])
                hit = box_ops.clip_to_window(raw, window).to(self.device)
            self._anchor_cache[key] = hit
        return hit

    # ---- DetectionModel API ----

    @staticmethod
    def preprocess(images: Tensor) -> Tensor:
        """Channel-mean subtraction; resize/pad happens in the data layer."""
        return resnet.preprocess_images(images)

    def _features(self, images: Tensor) -> Tuple[Tensor, Tuple[int, int]]:
        """The trunk's stride-16 map of the batch and the compute canvas
        (h, w). Under `spatial` the images are this rank's H-slab: the
        trunk runs on it with halo exchanges and its output is gathered."""
        hw = spatial_lib.canvas_hw(images, self.spatial)
        if self.spatial is None:
            return self.modules.backbone(images), hw
        feats = spatial_lib.trunk_slab(self.modules.backbone, images, self.spatial,
                                       self.cfg.feature_stride)
        return spatial_lib.gather_slabs(feats, self.spatial), hw

    @torch.inference_mode()
    def predict(self, images: Tensor, true_shapes: Tensor,
                training: bool = False) -> Dict[str, Tensor]:
        """Serve both stages. images: [B, H, W, 3] preprocessed on the
        compute canvas; true_shapes: [B, 2] (true h, w) of each image
        pre-padding. Training goes through `predict_train` (inference
        mode here would keep any gradient from flowing)."""
        if training:
            raise NotImplementedError(
                "predict is the serving entry; training predicts with "
                "predict_train(images, true_shapes, groundtruth, draws)"
            )
        c = self.cfg
        self.modules.eval()
        feats, canvas_hw = self._features(images)
        anchors = self.anchors_for(canvas_hw)
        obj_logits, box_enc = self.modules.rpn(feats)
        proposals, proposal_scores, proposal_mask = self._postprocess_rpn(
            obj_logits, box_enc, true_shapes, anchors
        )
        pred: Dict[str, Tensor] = {
            "rpn_features": feats,
            "rpn_objectness_logits": obj_logits,
            "rpn_box_encodings": box_enc,
            "anchors": anchors,
            "proposal_boxes": proposals,  # [B, P, 4] canvas px
            "proposal_mask": proposal_mask,
            "proposal_scores": proposal_scores,
        }
        if c.number_of_stages == 1:
            return pred
        cls_logits, box_refine, masks = self._predict_second_stage(feats, proposals, canvas_hw)
        pred["class_predictions"] = cls_logits
        pred["refined_box_encodings"] = box_refine
        if masks is not None:
            pred["mask_predictions"] = masks  # [B, P, mh, mw, K]
        return pred

    def predict_train(self, images: Tensor, true_shapes: Tensor,
                      groundtruth: Dict[str, Tensor],
                      draws: Dict[str, Tensor]) -> Dict[str, Tensor]:
        """The training forward (mtlx predict(training=True)): both stages
        on second_stage_batch_size proposals sampled against the ground
        truth, and the MTL aux heads. groundtruth: boxes [B, G, 4] canvas
        px, classes [B, G] (0-based), mask [B, G] bool; draws: see the
        module docstring. The modules run in training mode: a live batch
        norm normalizes by the batch and keeps its statistics for the
        train step to commit, and dropout drops."""
        c = self.cfg
        self.modules.train()
        feats, canvas_hw = self._features(images)
        anchors = self.anchors_for(canvas_hw)
        obj_logits, box_enc = self.modules.rpn(feats)
        with torch.no_grad():  # proposals are a constant of the second stage
            proposals, _, proposal_mask = self._proposals(
                obj_logits.detach(), box_enc.detach(), true_shapes, anchors
            )
            proposals, proposal_mask = self._sample_proposals(
                proposals, proposal_mask, groundtruth,
                (draws["proposal_pos"], draws["proposal_neg"]),
            )
        pred: Dict[str, Tensor] = {
            "rpn_features": feats,
            "rpn_objectness_logits": obj_logits,
            "rpn_box_encodings": box_enc,
            "anchors": anchors,
            "proposal_boxes": proposals,
            "proposal_mask": proposal_mask,
        }
        if c.number_of_stages == 1:
            return pred
        cls_logits, box_refine, masks = self._second_stage(
            feats, proposals, canvas_hw, draws.get("dropout") if c.second_stage_dropout else None)
        pred["class_predictions"] = cls_logits
        pred["refined_box_encodings"] = box_refine
        if masks is not None:
            pred["mask_predictions"] = masks
        if c.mtl.any:
            self._predict_aux(pred, feats, groundtruth, canvas_hw, draws)
        return pred

    def _normalized(self, proposals: Tensor, canvas_hw: Optional[Tuple[int, int]]) -> Tensor:
        """Canvas-pixel proposals [B, P, 4] -> normalized to the canvas."""
        ch, cw = canvas_hw if canvas_hw is not None else self.cfg.canvas_size
        canvas = torch.tensor([ch, cw, ch, cw], dtype=torch.float32, device=proposals.device)
        return (proposals / canvas).contiguous()

    def dropout_shape(self, batch_size: int) -> Tuple[int, int]:
        """The shape of the box predictor's dropout draws in a training
        step of `batch_size` images: [B * second_stage_batch_size, D]."""
        return (batch_size * self.cfg.second_stage_batch_size,
                self.modules.box_predictor.in_features)

    def _second_stage(self, feats: Tensor, proposals: Tensor,
                      canvas_hw: Optional[Tuple[int, int]] = None,
                      dropout: Optional[Tensor] = None):
        """ROI crop -> maxpool -> box classifier features (-> the refine
        vector of each proposal joined on) -> FC heads. Returns
        (class_predictions [B, P, K+1], refined_box_encodings
        [B, P, K, 4], mask_predictions [B, P, mh, mw, K] or None). A 1x1 /
        stride-1 maxpool is the identity and is skipped. dropout: the box
        predictor's draws [B * P, D]."""
        c = self.cfg
        b, p = proposals.shape[:2]
        norm_proposals = self._normalized(proposals, canvas_hw)
        crops = roi_lib.batch_crop_and_resize(
            feats.contiguous(), norm_proposals, (c.initial_crop_size, c.initial_crop_size)
        )  # [B, P, cs, cs, C]
        crops = crops.reshape((b * p,) + crops.shape[2:])
        if c.maxpool_kernel_size > 1 or c.maxpool_stride > 1:
            crops = F.max_pool2d(
                crops.permute(0, 3, 1, 2), c.maxpool_kernel_size, c.maxpool_stride
            ).permute(0, 2, 3, 1)
        aux_hidden = None
        if self.modules.refines:
            # each proposal's window mean-pooled 7x7 from the stride-16
            # map in the map's compute type, as the aux heads' windows are
            pooled_rpn = roi_lib.mean_pooled_crop(feats, norm_proposals, (7, 7)).float()
            aux_hidden = self.modules.aux_hidden_for_rois(pooled_rpn.reshape(b * p, -1))
        cls_logits, box_refine, masks = self.modules.classify_rois(crops, aux_hidden, dropout)
        if masks is not None:
            masks = masks.reshape((b, p) + masks.shape[1:])
        return cls_logits.reshape(b, p, -1), box_refine.reshape(b, p, -1, 4), masks

    @torch.inference_mode()
    def _predict_second_stage(self, feats: Tensor, proposals: Tensor,
                              canvas_hw: Optional[Tuple[int, int]] = None):
        """The serving second stage (`_second_stage` in inference mode)."""
        return self._second_stage(feats, proposals, canvas_hw)

    def _predict_aux(self, pred: Dict[str, Tensor], feats: Tensor,
                     gt: Dict[str, Tensor], canvas_hw: Tuple[int, int],
                     draws: Dict[str, Tensor]) -> None:
        """The aux heads on ground-truth-derived windows (annotation
        recycling), mean-pooled from the stride-16 map."""
        c = self.cfg
        ch, cw = canvas_hw
        canvas = torch.tensor([ch, cw, ch, cw], dtype=torch.float32, device=feats.device)
        if c.mtl.foreground:
            pred["foreground_logits"] = self.modules.fg_head(feats)

        def pool(boxes_norm):
            return roi_lib.mean_pooled_crop(feats, boxes_norm, (7, 7)).float()  # [B, G, C]

        if c.mtl.multiobject:
            if c.mtl.window_sampling:
                windows = recycle.sampled_windows(
                    gt["boxes"], c.mtl.window_enlarge_factor,
                    (draws["window_scale"], draws["window_offset"]),
                )
            else:
                windows = recycle.enlarged_windows(gt["boxes"], c.mtl.window_enlarge_factor)
            pred["multiobject_windows"] = windows
            pred["multiobject_logits"], _ = self.modules.mo_head(pool(windows / canvas))
        if c.mtl.closeness:
            pred["closeness_logits"], _ = self.modules.cl_head(pool(gt["boxes"] / canvas))

    def _proposals(self, obj_logits: Tensor, box_enc: Tensor,
                   true_shapes: Tensor, anchors: Optional[Tensor] = None):
        """Decode anchors -> clip to the true image -> top-K -> NMS, all
        images in one NMS launch."""
        c = self.cfg
        if anchors is None:
            anchors = self.anchors_for(c.canvas_size)
        b = obj_logits.shape[0]
        scores = softmax(obj_logits)[..., 1]  # [B, A]
        boxes = self.box_coder.decode(box_enc, anchors[None])
        window = torch.cat(
            [torch.zeros(b, 2, device=boxes.device), true_shapes.to(boxes.device).float()],
            dim=1,
        )
        boxes = box_ops.clip_to_window(boxes, window)
        # zero-area boxes (anchors outside the true image) must not compete
        # for the pre-NMS top-k slots
        scores = torch.where(box_ops.area(boxes) > 0, scores, float("-inf"))
        k = min(c.first_stage_pre_nms_top_k, boxes.shape[1])
        top_scores, top_idx = nms_lib.top_k(scores, k)
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))
        area_ok = box_ops.area(top_boxes) > 0
        top_scores = torch.where(area_ok, top_scores, 0.0)
        idx, keep = nms_lib.batched_non_max_suppression(
            top_boxes, top_scores,
            max_output_size=c.first_stage_max_proposals,
            iou_threshold=c.first_stage_nms_iou_threshold,
            score_threshold=c.first_stage_nms_score_threshold,
            valid_mask=area_ok,
        )
        idx = idx.long()
        proposals = torch.gather(top_boxes, 1, idx[..., None].expand(*idx.shape, 4))
        scores_out = torch.where(keep, torch.gather(top_scores, 1, idx), 0.0)
        return proposals, scores_out, keep

    @torch.inference_mode()
    def _postprocess_rpn(self, obj_logits: Tensor, box_enc: Tensor,
                         true_shapes: Tensor, anchors: Optional[Tensor] = None):
        """The serving RPN postprocess (`_proposals` in inference mode)."""
        return self._proposals(obj_logits, box_enc, true_shapes, anchors)

    def _sample_proposals(self, proposals: Tensor, proposal_mask: Tensor,
                          gt: Dict[str, Tensor], uniforms: Tuple[Tensor, Tensor]):
        """Balanced-sample second_stage_batch_size proposals per image and
        compact them to the front (stable: the sampled in their order)."""
        c = self.cfg
        res = self._detection_assigner.assign(proposals, gt["boxes"], gt_mask=gt["mask"])
        positive = (res.match >= 0) & proposal_mask
        indicator = proposal_mask & (res.match != matcher_lib.IGNORED)
        sampled = samplers.balanced_subsample(
            indicator, positive, c.second_stage_batch_size,
            c.second_stage_balance_fraction, uniforms,
        )
        order = torch.argsort((~sampled).to(torch.uint8), dim=-1, stable=True)
        idx = order[:, : c.second_stage_batch_size]
        return matcher_lib.take_rows(proposals, idx), torch.gather(sampled, 1, idx)

    # ---- losses ----

    def loss(self, pred: Dict[str, Tensor], gt: Dict[str, Tensor],
             draws: Dict[str, Tensor], replicas=None) -> Dict[str, Tensor]:
        """The joint loss: `Loss/*` terms and their sum `total_loss`.

        With `replicas` (parallel/distributed.py) the batch is this rank's
        rows of a global batch, and each term is scaled so that its mean
        over the ranks is mtlx's term on the global batch: the per-image
        and plain-mean terms already are, and the multi-object and
        closeness terms, which divide by the count of valid boxes of the
        whole batch, divide by the count summed over the ranks and are
        multiplied by the world size."""
        c = self.cfg
        out: Dict[str, Tensor] = {}
        out.update(self._first_stage_loss(pred, gt, (draws["anchor_pos"], draws["anchor_neg"])))
        if c.number_of_stages > 1:
            out.update(self._second_stage_loss(pred, gt))
            if (c.predict_instance_masks and "mask_predictions" in pred
                    and "instance_masks" in gt):
                out.update(self._mask_loss(pred, gt))
            if c.mtl.any:
                out.update(self._aux_loss(pred, gt, replicas))
        out["total_loss"] = sum(v for k, v in out.items() if k.startswith("Loss/"))
        return out

    def _first_stage_loss(self, pred, gt, uniforms):
        c = self.cfg
        res = self._proposal_assigner.assign(pred["anchors"], gt["boxes"], gt_mask=gt["mask"])
        indicator = res.cls_weights > 0  # drops ignored anchors
        positive = res.match >= 0
        sampled = samplers.balanced_subsample(
            indicator, positive, c.first_stage_minibatch_size,
            c.first_stage_positive_balance_fraction, uniforms,
        )
        weights = sampled.float()
        normalizer = torch.clamp_min(weights.sum(-1), 1.0)  # [B]
        t = res.cls_targets[..., 0]
        onehot = torch.stack([1.0 - t, t], dim=-1)
        obj_loss = loss_lib.weighted_softmax_classification_loss(
            pred["rpn_objectness_logits"], onehot, weights
        )
        loc_loss = loss_lib.weighted_smooth_l1_loss(
            pred["rpn_box_encodings"], res.reg_targets, res.reg_weights * sampled
        )
        return {
            "Loss/RPNLoss/objectness_loss": (obj_loss.sum(-1) / normalizer).mean()
            * c.first_stage_objectness_loss_weight,
            "Loss/RPNLoss/localization_loss": (loc_loss.sum(-1) / normalizer).mean()
            * c.first_stage_localization_loss_weight,
        }

    def _second_stage_loss(self, pred, gt):
        c = self.cfg
        k = c.num_classes
        onehot = recycle.one_hot(gt["classes"] + 1, k + 1)  # column 0 = background
        background = recycle.one_hot(torch.zeros((), dtype=torch.int64, device=onehot.device),
                                     k + 1)
        res = self._detection_assigner.assign(
            pred["proposal_boxes"], gt["boxes"], gt_labels=onehot, gt_mask=gt["mask"],
            unmatched_cls_target=background,
        )
        w = pred["proposal_mask"].float()
        cls_loss = loss_lib.weighted_softmax_classification_loss(
            pred["class_predictions"], res.cls_targets, res.cls_weights * w
        )
        # per-class box refinement: the target class's row
        box_refine = pred["refined_box_encodings"]  # [B, P, num_box, 4]
        num_box = box_refine.shape[2]
        if num_box == 1:
            row = torch.zeros(res.match.shape, dtype=torch.int64, device=w.device)
        else:
            row = torch.clamp(torch.argmax(res.cls_targets[..., 1:], dim=-1), 0, num_box - 1)
        enc = torch.take_along_dim(box_refine, row[..., None, None].expand(*row.shape, 1, 4),
                                   dim=2)[..., 0, :]
        loc_loss = loss_lib.weighted_smooth_l1_loss(enc, res.reg_targets, res.reg_weights * w)
        normalizer = torch.clamp_min(w.sum(-1), 1.0)
        if c.hard_example_miner is not None:
            # mtlx's normalisation: the kept ROIs' losses are summed and
            # divided by the proposal count, not averaged over the kept
            with torch.no_grad():
                keep = loss_lib.hard_example_mining_mask(
                    cls_loss.detach(), loc_loss.detach(), pred["proposal_boxes"], res.match,
                    c.hard_example_miner)
            keep = keep.float() * w
            cls_loss, loc_loss = cls_loss * keep, loc_loss * keep
        return {
            "Loss/BoxClassifierLoss/classification_loss": (cls_loss.sum(-1) / normalizer).mean()
            * c.second_stage_classification_loss_weight,
            "Loss/BoxClassifierLoss/localization_loss": (loc_loss.sum(-1) / normalizer).mean()
            * c.second_stage_localization_loss_weight,
        }

    def _mask_loss(self, pred, gt):
        """mtlx's per-proposal instance-mask loss: the sampled proposals are
        assigned again by the detection assigner (one IoU launch for the
        batch), each one's matched ground-truth mask (at the loader's
        canvas / mask_stride raster, in the compute canvas's frame) is
        cropped and resized to the prediction's 14x14 (one crop launch for
        all B x P proposals, each its own one-channel image), and the
        matched class's mask logits take the sigmoid cross-entropy against
        it, averaged over the pixels and the positive proposals of each
        image, then over the images."""
        c = self.cfg
        mask_pred = pred["mask_predictions"]  # [B, P, mh, mw, K]
        b, p, mh, mw, _ = mask_pred.shape
        s = c.feature_stride
        feats = pred["rpn_features"]
        norm = torch.tensor([feats.shape[1] * s, feats.shape[2] * s] * 2,
                            dtype=torch.float32, device=mask_pred.device)
        with torch.no_grad():  # the targets are constants
            props = pred["proposal_boxes"]
            res = self._detection_assigner.assign(props, gt["boxes"], gt_mask=gt["mask"])
            pos = ((res.match >= 0) & pred["proposal_mask"]).float()
            gt_masks = gt["instance_masks"]  # [B, G, gh, gw]
            g, gh, gw = gt_masks.shape[1:]
            midx = torch.clamp(res.match, 0, g - 1)
            sel = torch.gather(gt_masks, 1, midx[:, :, None, None].expand(b, p, gh, gw)).float()
            target = roi_lib.batch_crop_and_resize(
                sel.reshape(b * p, gh, gw, 1), (props / norm).reshape(b * p, 1, 4).contiguous(),
                (mh, mw)).reshape(b, p, mh, mw)
            cls = torch.clamp(torch.gather(gt["classes"], 1, midx), 0, c.num_classes - 1)
        logit = torch.take_along_dim(
            mask_pred, cls[:, :, None, None, None].expand(b, p, mh, mw, 1), dim=-1)[..., 0]
        per_prop = loss_lib.sigmoid_cross_entropy(logit, target).mean(dim=(2, 3))
        per_image = (per_prop * pos).sum(-1) / torch.clamp_min(pos.sum(-1), 1.0)
        return {"Loss/BoxClassifierLoss/mask_loss":
                per_image.mean() * c.second_stage_mask_prediction_loss_weight}

    def _aux_loss(self, pred, gt, replicas=None):
        c = self.cfg
        out = {}
        s = c.feature_stride
        feats = pred["rpn_features"]
        canvas_h, canvas_w = feats.shape[1] * s, feats.shape[2] * s
        mask = gt["mask"]
        if c.mtl.foreground and "foreground_logits" in pred:
            logits = pred["foreground_logits"]  # [B, Hf, Wf]
            norm = torch.tensor([canvas_h, canvas_w, canvas_h, canvas_w],
                                dtype=torch.float32, device=logits.device)
            target = recycle.foreground_mask(gt["boxes"] / norm, mask, tuple(logits.shape[1:]))
            ce = loss_lib.sigmoid_cross_entropy(logits, target)
            out["Loss/MTL/foreground_loss"] = ce.mean() * c.mtl.foreground_weight

        def soft_ce(logits, labels, weight):
            valid = mask & (labels.sum(-1) > 0)
            ce = loss_lib.softmax_cross_entropy(logits, labels)
            count = valid.float().sum()
            if replicas is not None:  # the batch-wide count is the global batch's
                count = replicas.sum(count)
                weight = weight * replicas.world_size
            return (ce * valid).sum() / torch.clamp_min(count, 1.0) * weight

        if c.mtl.multiobject and "multiobject_logits" in pred:
            labels = recycle.multiobject_labels(
                pred["multiobject_windows"], gt["boxes"], gt["classes"], mask, c.num_classes
            )
            out["Loss/MTL/multiobject_loss"] = soft_ce(
                pred["multiobject_logits"], labels, c.mtl.multiobject_weight
            )
        if c.mtl.closeness and "closeness_logits" in pred:
            labels = recycle.closeness_labels(
                gt["boxes"], gt["classes"], mask, c.num_classes, c.mtl.closeness_sigma
            )
            out["Loss/MTL/closeness_loss"] = soft_ce(
                pred["closeness_logits"], labels, c.mtl.closeness_weight
            )
        return out

    # ---- postprocess ----

    def _convert_scores(self, cls_logits: Tensor) -> Tensor:
        """Apply the configured score_converter to [..., K+1] class logits."""
        kind = self.cfg.score_converter
        if kind == "softmax":
            return softmax(cls_logits)
        if kind == "sigmoid":
            return _flush_subnormal(torch.sigmoid(cls_logits))
        if kind == "identity":
            return cls_logits
        raise ValueError(f"unknown score_converter {kind!r}")

    @torch.inference_mode()
    def postprocess(self, pred: Dict[str, Tensor], true_shapes: Tensor) -> Dict[str, Tensor]:
        """Second-stage decode + per-class NMS -> final detections:
        detection_boxes (normalized to the TRUE image), detection_scores,
        detection_classes (0-based), num_detections and, for a mask model,
        detection_masks [B, D, mh, mw] (the sigmoid of each detection's
        class's mask logits, carried through the NMS as an extra field;
        0.5 on padding, as in mtlx). In RPN-only mode the proposals are
        returned as class-agnostic detections."""
        c = self.cfg
        props = pred["proposal_boxes"]
        b = props.shape[0]
        window = torch.cat(
            [torch.zeros(b, 2, device=props.device), true_shapes.to(props.device).float()],
            dim=1,
        )
        if c.number_of_stages == 1:
            mask = pred["proposal_mask"]
            boxes = box_ops.change_coordinate_frame(props, window)
            return {
                "detection_boxes": torch.where(mask[..., None], boxes, 0.0),
                "detection_scores": torch.where(mask, pred["proposal_scores"], 0.0),
                "detection_classes": torch.zeros(mask.shape, dtype=torch.int32,
                                                 device=mask.device),
                "num_detections": mask.sum(-1).to(torch.int32),
            }
        scores = self._convert_scores(pred["class_predictions"])[..., 1:]  # [B, P, K]
        box_refine = pred["refined_box_encodings"]  # [B, P, num_box, 4]
        p = props.shape[1]
        anchors = props[:, :, None, :].expand(b, p, c.num_classes, 4)
        refine = box_refine.expand(anchors.shape)
        decoded = self.box_coder.decode(refine, anchors)  # [B, P, K, 4]
        res = nms_lib.batch_multiclass_non_max_suppression(
            decoded,
            scores,
            score_threshold=c.second_stage_nms_score_threshold,
            iou_threshold=c.second_stage_nms_iou_threshold,
            max_size_per_class=c.second_stage_max_detections_per_class,
            max_total_size=c.second_stage_max_total_detections,
            clip_window=window,
            change_coordinate_frame=True,
            valid_mask=pred["proposal_mask"],
            extra_fields={"masks": pred["mask_predictions"]} if "mask_predictions" in pred
            else None,
        )
        out = {
            "detection_boxes": res.boxes,
            "detection_scores": res.scores,
            "detection_classes": res.classes,
            "num_detections": res.num_valid,
        }
        if "masks" in res.extra_fields:
            per_class = res.extra_fields["masks"]  # [B, D, mh, mw, K]
            cls = res.classes.long()[:, :, None, None, None].expand(*per_class.shape[:4], 1)
            out["detection_masks"] = torch.sigmoid(
                torch.take_along_dim(per_class, cls, dim=-1)[..., 0])
        return out

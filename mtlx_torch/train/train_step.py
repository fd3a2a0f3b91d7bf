"""The train step and the optimizer (port of mtlx/train/train_step.py).

One step: preprocess -> `predict_train` (both stages + aux heads) ->
`loss` -> backward -> the optimizer's transforms -> in-place update of
the float32 parameters. The optimizer is optax's chain as mtlx builds
it, written out so the numbers match optax and not `torch.optim`:
  1. the bias gradient multiplier (train_config.bias_grad_multiplier)
  2. the freeze mask (train_config.freeze_variables regexes, matched
     against flax-style paths such as `backbone/conv1/kernel`)
  3. clip_by_global_norm: g if norm < max else g / norm * max, no epsilon
  4. sgd with momentum: trace = g + momentum * trace, update = -lr * trace,
     lr from a constant or a piecewise-constant schedule indexed by the
     optimizer's own count from 0

Every parameter of the detector trains (flax's `params` collection): the
convolutions, dense layers, the frozen batch norms' scale and bias and
the aux heads; the batch-norm statistics are buffers and never change.

Randomness: `make_draws` makes every uniform draw of a step from one
`torch.Generator` on the step's device, in this order: one [B] per
augmentation option (in option order), proposal_pos and proposal_neg
[B, first_stage_max_proposals], anchor_pos and anchor_neg [B, A], and
with mtl.window_sampling window_scale and window_offset [B, G, 2]. A
caller may pass its own draws (a test passes JAX's).

Exponential moving averages of the parameters (use_moving_average) are
not ported: ROADMAP.md queue 1 #13 (EMA).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from mtlx_torch.detector.faster_rcnn import FasterRCNN
from mtlx_torch.utils.bucketing import bucket_multiple


class PiecewiseConstantSchedule:
    """optax.piecewise_constant_schedule: init_value, multiplied by each
    boundary's scale from the count equal to that boundary on, evaluated
    in float32 in optax's operation order."""

    def __init__(self, init_value: float, boundaries_and_scales: Dict[int, float]):
        self.init_value = init_value
        self.boundaries_and_scales = dict(boundaries_and_scales)

    def __call__(self, count: int) -> np.float32:
        v = np.float32(self.init_value)
        for threshold, scale in sorted(self.boundaries_and_scales.items()):
            indicator = np.float32(max(0.0, np.sign(threshold - count)))
            v = v * indicator + (np.float32(1.0) - indicator) * np.float32(scale) * v
        return v


def flax_path(name: str) -> str:
    """The flax path of a port parameter name (`backbone.conv1.weight` ->
    `backbone/conv1/kernel`), which the freeze patterns match."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts[-1] = "kernel"
    return "/".join(parts)


@dataclasses.dataclass
class OptState:
    count: int
    names: List[str]  # the parameters, in the order of `trace`
    trace: List[Tensor]


class Optimizer:
    """The chain of make_optimizer over a dict of named parameters."""

    def __init__(self, learning_rate=1e-3, momentum: float = 0.9,
                 gradient_clipping_by_norm: float = 10.0,
                 bias_grad_multiplier: float = 0.0, freeze_variables: Sequence[str] = ()):
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.clip = gradient_clipping_by_norm if gradient_clipping_by_norm > 0 else 0.0
        self.bias_grad_multiplier = bias_grad_multiplier if bias_grad_multiplier > 0 else 0.0
        self.freeze = [re.compile(p) for p in freeze_variables if p]

    def init(self, params: Dict[str, Tensor]) -> OptState:
        return OptState(0, list(params), [torch.zeros_like(p, memory_format=torch.preserve_format)
                                          for p in params.values()])

    def lr(self, count: int) -> np.float32:
        if callable(self.learning_rate):
            return np.float32(self.learning_rate(count))
        return np.float32(self.learning_rate)

    def update(self, grads: Dict[str, Tensor], state: OptState
               ) -> Tuple[List[Tensor], OptState]:
        """(updates in the order of the state's names, the new state)."""
        names = state.names
        g = [grads[n] for n in names]
        if self.bias_grad_multiplier:
            g = [x * self.bias_grad_multiplier if "bias" in n.split(".") else x
                 for n, x in zip(names, g)]
        if self.freeze:
            g = [torch.zeros_like(x) if any(p.search(flax_path(n)) for p in self.freeze) else x
                 for n, x in zip(names, g)]
        if self.clip:
            norm = global_norm(g)
            if not bool(norm < self.clip):  # one host sync per step
                g = torch._foreach_mul(torch._foreach_div(g, norm), self.clip)
        trace = torch._foreach_mul(state.trace, self.momentum)
        torch._foreach_add_(trace, g)  # g + momentum * trace
        updates = torch._foreach_mul(trace, float(-self.lr(state.count)))
        return updates, OptState(state.count + 1, names, trace)


def global_norm(tensors: Sequence[Tensor]) -> Tensor:
    """optax.global_norm: the 2-norm of all the tensors together."""
    return torch.stack(torch._foreach_norm(list(tensors))).square().sum().sqrt()


def make_optimizer(learning_rate=1e-3, momentum: float = 0.9,
                   gradient_clipping_by_norm: float = 10.0,
                   bias_grad_multiplier: float = 0.0, freeze_variables=()) -> Optimizer:
    """Momentum SGD + clip (+ bias multiplier and frozen-variable
    patterns), as mtlx's make_optimizer chains them."""
    return Optimizer(learning_rate, momentum, gradient_clipping_by_norm,
                     bias_grad_multiplier, freeze_variables)


@dataclasses.dataclass
class TrainState:
    """The step count, the model (its parameters are the trained state)
    and the optimizer with its state."""

    step: int
    model: FasterRCNN
    tx: Optimizer
    opt_state: OptState

    @property
    def params(self) -> Dict[str, Tensor]:
        return dict(self.model.modules.named_parameters())


def create_train_state(model: FasterRCNN, tx: Optimizer) -> TrainState:
    """A state at step 0 around a model whose weights are set
    (`init_weights`, or a checkpoint through the bridge)."""
    return TrainState(0, model, tx, tx.init(dict(model.modules.named_parameters())))


def make_regularization_fn(scopes) -> Optional[Callable]:
    """Weight regularization from the Hyperparams protos: scopes
    [(top-level module prefix, 'l1_regularizer' | 'l2_regularizer',
    weight)]; l2 = weight * sum(w^2) / 2, l1 = weight * sum(|w|), on
    kernels only. None when every weight is 0 (the flagship)."""
    scopes = [s for s in (scopes or []) if s[2]]
    if not scopes:
        return None

    def reg_fn(params: Dict[str, Tensor]) -> Tensor:
        total = torch.zeros((), dtype=torch.float32,
                            device=next(iter(params.values())).device)
        for scope, kind, weight in scopes:
            for name, w in params.items():
                if not name.split(".")[0].startswith(scope) or not name.endswith(".weight"):
                    continue
                w32 = w.float()
                if kind == "l1_regularizer":
                    total = total + weight * w32.abs().sum()
                else:
                    total = total + weight * 0.5 * (w32 * w32).sum()
        return total

    return reg_fn


def pad_batch_to_bucket(batch: Dict[str, Tensor], canvas, multiple: int = 0) -> Dict:
    """Pad a batch's images (bottom and right, zeros) up to the next
    `multiple` of their extent, capped at the canvas: the detector
    computes on that bucket."""
    multiple = bucket_multiple(multiple)
    ch, cw = canvas
    img = batch["image"]
    h, w = img.shape[1], img.shape[2]
    if h > ch or w > cw:
        raise ValueError(f"image {tuple(img.shape)} exceeds canvas {canvas}")
    if "gt_instance_masks" in batch:
        raise NotImplementedError("instance masks are not ported: ROADMAP.md queue 1, "
                                  "masks and keypoints")
    bh = min(ch, -(-h // multiple) * multiple)
    bw = min(cw, -(-w // multiple) * multiple)
    out = dict(batch)
    if (h, w) != (bh, bw):
        out["image"] = F.pad(img, (0, 0, 0, bw - w, 0, bh - h))
    return out


def pad_for_model(model: FasterRCNN, batch: Dict[str, Tensor]) -> Dict:
    """Bucket padding (Faster R-CNN computes on any bucketed canvas)."""
    return pad_batch_to_bucket(batch, model.cfg.canvas_size)


def make_draws(model: FasterRCNN, batch_size: int, canvas_hw: Tuple[int, int],
               generator: torch.Generator, aug_options=(), num_gt: int = 0) -> Dict[str, Tensor]:
    """Every uniform draw of one step, in the documented order (module
    docstring), from `generator` on its own device."""
    c = model.cfg
    num_anchors = model.anchors_for(canvas_hw).shape[0]

    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    draws = {name: u(batch_size) for name, _ in aug_options}
    draws["proposal_pos"] = u(batch_size, c.first_stage_max_proposals)
    draws["proposal_neg"] = u(batch_size, c.first_stage_max_proposals)
    draws["anchor_pos"] = u(batch_size, num_anchors)
    draws["anchor_neg"] = u(batch_size, num_anchors)
    if c.mtl.multiobject and c.mtl.window_sampling:
        draws["window_scale"] = u(batch_size, num_gt, 2)
        draws["window_offset"] = u(batch_size, num_gt, 2)
    return draws


def make_train_step(model: FasterRCNN, regularization_fn: Optional[Callable] = None
                    ) -> Callable:
    """Returns step(state, batch, generator=None, draws=None) -> (state,
    metrics). batch: image [B, H, W, 3] (uint8 or float), true_shape
    [B, 2], gt_boxes [B, G, 4], gt_classes [B, G], gt_mask [B, G], all on
    the model's device. The draws not given come from `generator`.
    metrics: every loss term, total_loss and grad_norm (of the raw
    gradients), as tensors on the device."""

    def step(state: TrainState, batch: Dict[str, Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Tensor]] = None):
        m = state.model
        images = m.preprocess(batch["image"].float())
        gt = {"boxes": batch["gt_boxes"].float(), "classes": batch["gt_classes"].long(),
              "mask": batch["gt_mask"].bool()}
        draws = dict(draws or {})
        if generator is not None:
            made = make_draws(m, images.shape[0], tuple(images.shape[1:3]), generator,
                              num_gt=gt["boxes"].shape[1])
            draws = {**made, **draws}
        params = state.params
        for p in params.values():
            p.grad = None
        pred = m.predict_train(images, batch["true_shape"], gt, draws)
        losses = dict(m.loss(pred, gt, draws))
        if regularization_fn is not None:
            reg = regularization_fn(params)
            losses["Loss/regularization_loss"] = reg
            losses["total_loss"] = losses["total_loss"] + reg
        losses["total_loss"].backward()
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        grad_norm = global_norm(list(grads.values()))
        updates, opt_state = state.tx.update(grads, state.opt_state)
        with torch.no_grad():
            torch._foreach_add_([params[n] for n in opt_state.names], updates)
        metrics = {k: v.detach() for k, v in losses.items()}
        metrics["grad_norm"] = grad_norm
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    return step

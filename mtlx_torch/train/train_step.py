"""The train step and the optimizer (port of mtlx/train/train_step.py and
the optimizers of mtlx/builders/optimizer_builder.py).

One step: preprocess -> `predict_train` -> `loss` -> backward -> the
optimizer's transforms -> in-place update of the float32 parameters ->
the live batch norms' statistics committed -> the moving average of the
parameters. The optimizer is optax's chain as mtlx builds it, written
out so the numbers match optax and not `torch.optim`:
  1. the bias gradient multiplier (train_config.bias_grad_multiplier)
  2. the freeze mask (train_config.freeze_variables regexes, matched
     against flax-style paths such as `backbone/conv1/kernel`)
  3. clip_by_global_norm: g if norm < max else g / norm * max, no epsilon
  4. the optimizer, its learning rate a constant or a schedule
     (piecewise-constant, exponential or warm-up + cosine) indexed by the
     optimizer's own count from 0:
     * momentum (optax.sgd): trace = g + momentum * trace, update = -lr * trace
     * rmsprop (optax.rmsprop): nu = (1 - decay) * g^2 + decay * nu from 0,
       u = g * rsqrt(nu + eps) (eps inside the root), then -lr * u, then
       the momentum trace over that: trace = u + momentum * trace
     * adam (optax.adam, its defaults b1 0.9, b2 0.999, eps 1e-8): mu and
       nu as moving moments, bias-corrected by 1 - b ** count, update =
       -lr * mu_hat / (sqrt(nu_hat) + eps)

The exponential moving average of the parameters (use_moving_average)
follows each update: ema = ema * decay + param * (1 - decay), in float32.

Every parameter of the detector trains (flax's `params` collection). The
batch-norm statistics are buffers: a frozen batch norm never changes
them, and a live one (backbones/resnet.py LiveBatchNorm) folds the
batch's statistics into them after the update, as mtlx's step writes its
`updated_batch_stats`: every live batch norm of the model, in a
two-stage detector those of the backbone and of the box classifier
trunk (whose statistics are the ROI crops').

Randomness: `make_draws` makes every draw of a step from one
`torch.Generator` on the step's device, in this order: each
augmentation option's draws (in option order, keyed by the option's
position; data/preprocessor.py `make_draws` and `draw_key`), then for Faster R-CNN proposal_pos and proposal_neg [B,
first_stage_max_proposals], anchor_pos and anchor_neg [B, A], with
mtl.window_sampling window_scale and window_offset [B, G, 2], and with
second_stage_dropout dropout [B * second_stage_batch_size, D], the box
predictor's (D its input width); for SSD with use_dropout dropout_{i}
[B, h, w, depth], each box predictor's. A caller may pass its own draws
(a test passes JAX's).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

from mtlx_torch.data import preprocessor
from mtlx_torch.detector.faster_rcnn import FasterRCNN
from mtlx_torch.parallel.spatial import canvas_hw
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


class ExponentialDecaySchedule:
    """optax.exponential_decay (transition_begin 0, no end value):
    init_value * decay_rate ** (count / transition_steps), the exponent
    floored with `staircase`, evaluated in float32 in optax's operation
    order; constant where transition_steps <= 0 or decay_rate == 0."""

    def __init__(self, init_value: float, transition_steps: int, decay_rate: float,
                 staircase: bool = False):
        self.init_value = init_value
        self.transition_steps = transition_steps
        self.decay_rate = decay_rate
        self.staircase = staircase

    def __call__(self, count: int) -> np.float32:
        init = np.float32(self.init_value)
        if self.transition_steps <= 0 or self.decay_rate == 0 or count <= 0:
            return init
        p = np.float32(count) / np.float32(self.transition_steps)
        if self.staircase:
            p = np.floor(p)
        return init * np.power(np.float32(self.decay_rate), p)


class WarmupCosineDecaySchedule:
    """optax.warmup_cosine_decay_schedule (end value 0, exponent 1): a
    linear warm-up from init_value to peak_value over warmup_steps, then
    peak_value * 0.5 * (1 + cos(pi * t / (decay_steps - warmup_steps)))
    with t = count - warmup_steps capped at its end, evaluated in float32
    in optax's operation order."""

    def __init__(self, init_value: float, peak_value: float, warmup_steps: int,
                 decay_steps: int):
        if not decay_steps - warmup_steps > 0:
            raise ValueError("the cosine decay needs decay_steps > warmup_steps, got "
                             f"decay_steps={decay_steps}, warmup_steps={warmup_steps}")
        self.init_value = init_value
        self.peak_value = peak_value
        self.warmup_steps = warmup_steps
        self.decay_steps = decay_steps

    def __call__(self, count: int) -> np.float32:
        f = np.float32
        if count < self.warmup_steps:  # optax.linear_schedule
            frac = f(1) - f(max(count, 0)) / f(self.warmup_steps)
            return (f(self.init_value) - f(self.peak_value)) * frac + f(self.peak_value)
        span = self.decay_steps - self.warmup_steps
        t = f(min(count - self.warmup_steps, span))
        # the float32 cosine rounded from float64 (XLA's float32 cosine is
        # that in 98% of cases and an ulp off in the rest; numpy's is off
        # in 17%, which 1 + cos near -1 turns into a relative 4e-6)
        cos = f(np.cos(np.float64(f(np.pi) * t / f(span))))
        return f(self.peak_value) * (f(0.5) * (f(1) + cos))


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
    names: List[str]  # the parameters, in the order of the slots
    trace: List[Tensor]  # the momentum trace (momentum, rmsprop); Adam's mu
    nu: Optional[List[Tensor]] = None  # the second moment (rmsprop, adam)


OPTIMIZERS = ("momentum", "rmsprop", "adam")
# optax.adam's defaults, which mtlx's builder takes
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8


class Optimizer:
    """The chain of mtlx's optimizer over a dict of named parameters:
    `kind` is momentum, rmsprop or adam (module docstring)."""

    def __init__(self, learning_rate=1e-3, momentum: float = 0.9,
                 gradient_clipping_by_norm: float = 10.0,
                 bias_grad_multiplier: float = 0.0, freeze_variables: Sequence[str] = (),
                 kind: str = "momentum", decay: float = 0.9, epsilon: float = 1e-10):
        if kind not in OPTIMIZERS:
            raise ValueError(f"unknown optimizer {kind!r}")
        self.kind = kind
        self.learning_rate = learning_rate
        self.momentum = momentum
        self.decay, self.epsilon = decay, epsilon  # RMSProp's
        self.clip = gradient_clipping_by_norm if gradient_clipping_by_norm > 0 else 0.0
        self.bias_grad_multiplier = bias_grad_multiplier if bias_grad_multiplier > 0 else 0.0
        self.freeze = [re.compile(p) for p in freeze_variables if p]

    def init(self, params: Dict[str, Tensor]) -> OptState:
        zeros = lambda: [torch.zeros_like(p, memory_format=torch.preserve_format)
                         for p in params.values()]
        return OptState(0, list(params), zeros(), None if self.kind == "momentum" else zeros())

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
        step_size = float(-self.lr(state.count))
        nu = state.nu
        if self.kind == "momentum":
            trace = torch._foreach_mul(state.trace, self.momentum)
            torch._foreach_add_(trace, g)  # g + momentum * trace
            updates = torch._foreach_mul(trace, step_size)
        elif self.kind == "rmsprop":
            nu = torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.decay)
            torch._foreach_add_(nu, torch._foreach_mul(state.nu, self.decay))
            scaled = torch._foreach_mul(torch._foreach_rsqrt(torch._foreach_add(nu, self.epsilon)), g)
            scaled = torch._foreach_mul(scaled, step_size)
            trace = torch._foreach_mul(state.trace, self.momentum)
            torch._foreach_add_(trace, scaled)  # u + momentum * trace
            updates = trace
        else:  # adam
            trace = torch._foreach_mul(g, 1 - ADAM_B1)
            torch._foreach_add_(trace, torch._foreach_mul(state.trace, ADAM_B1))
            nu = torch._foreach_mul(torch._foreach_mul(g, g), 1 - ADAM_B2)
            torch._foreach_add_(nu, torch._foreach_mul(state.nu, ADAM_B2))
            f, count = np.float32, np.float32(state.count + 1)
            bc1 = float(f(1) - np.power(f(ADAM_B1), count))
            bc2 = float(f(1) - np.power(f(ADAM_B2), count))
            mu_hat = torch._foreach_div(trace, bc1)
            nu_hat = torch._foreach_div(nu, bc2)
            denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), ADAM_EPS)
            updates = torch._foreach_mul(torch._foreach_div(mu_hat, denom), step_size)
        return updates, OptState(state.count + 1, names, trace, nu)


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
    """The step count, the model (its parameters are the trained state),
    the optimizer with its state, and the moving average of the
    parameters (None when the config keeps none)."""

    step: int
    model: FasterRCNN
    tx: Optimizer
    opt_state: OptState
    ema: Optional[Dict[str, Tensor]] = None

    @property
    def params(self) -> Dict[str, Tensor]:
        return dict(self.model.modules.named_parameters())


def create_train_state(model: FasterRCNN, tx: Optimizer, keep_ema: bool = False) -> TrainState:
    """A state at step 0 around a model whose weights are set
    (`init_weights`, or a checkpoint through the bridge); with keep_ema the
    moving average starts at the parameters."""
    params = dict(model.modules.named_parameters())
    ema = {n: p.detach().clone() for n, p in params.items()} if keep_ema else None
    return TrainState(0, model, tx, tx.init(params), ema)


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
    computes on that bucket. Instance masks [B, G, CH / s, CW / s] are
    cut to the bucket's extent on their raster (s = CH over their rows)."""
    multiple = bucket_multiple(multiple)
    ch, cw = canvas
    img = batch["image"]
    h, w = img.shape[1], img.shape[2]
    if h > ch or w > cw:
        raise ValueError(f"image {tuple(img.shape)} exceeds canvas {canvas}")
    bh = min(ch, -(-h // multiple) * multiple)
    bw = min(cw, -(-w // multiple) * multiple)
    out = dict(batch)
    if (h, w) != (bh, bw):
        out["image"] = F.pad(img, (0, 0, 0, bw - w, 0, bh - h))
    if out.get("gt_instance_masks") is not None:
        m = out["gt_instance_masks"]
        ms = ch // m.shape[2]
        out["gt_instance_masks"] = m[:, :, : bh // ms, : bw // ms]
    return out


def pad_batch_to_canvas(batch: Dict[str, Tensor], canvas) -> Dict:
    """Pad a batch's images (bottom and right, zeros) to the whole canvas."""
    ch, cw = canvas
    img = batch["image"]
    h, w = img.shape[1], img.shape[2]
    if (h, w) == (ch, cw):
        return batch
    if h > ch or w > cw:
        raise ValueError(f"image {tuple(img.shape)} exceeds canvas {canvas}")
    return dict(batch, image=F.pad(img, (0, 0, 0, cw - w, 0, ch - h)))


def pad_for_model(model, batch: Dict[str, Tensor], multiple: int = 0) -> Dict:
    """Bucket padding where the detector computes on any bucketed canvas
    (Faster R-CNN, R-FCN), the whole canvas otherwise (SSD's anchors are
    fixed to it), as mtlx's pad_for_model."""
    if getattr(model, "supports_bucketed_compute", True):
        return pad_batch_to_bucket(batch, model.cfg.canvas_size, multiple)
    return pad_batch_to_canvas(batch, model.cfg.canvas_size)


def make_draws(model, batch_size: int, canvas_hw: Tuple[int, int],
               generator: torch.Generator, aug_options=(), num_gt: int = 0) -> Dict[str, Tensor]:
    """Every draw of one step, in the documented order (module
    docstring), from `generator` on its own device."""
    draws = {preprocessor.draw_key(i): preprocessor.make_draws(
        name, kwargs, batch_size, canvas_hw, num_gt, generator)
        for i, (name, kwargs) in enumerate(aug_options)}

    def u(*shape):
        return torch.rand(shape, generator=generator, device=generator.device)

    if not isinstance(model, FasterRCNN):  # SSD: its predictors' dropout
        for i, shape in enumerate(model.dropout_shapes(batch_size)):
            draws[f"dropout_{i}"] = u(*shape)
        return draws
    c = model.cfg
    num_anchors = model.anchors_for(canvas_hw).shape[0]

    draws["proposal_pos"] = u(batch_size, c.first_stage_max_proposals)
    draws["proposal_neg"] = u(batch_size, c.first_stage_max_proposals)
    draws["anchor_pos"] = u(batch_size, num_anchors)
    draws["anchor_neg"] = u(batch_size, num_anchors)
    if c.mtl.multiobject and c.mtl.window_sampling:
        draws["window_scale"] = u(batch_size, num_gt, 2)
        draws["window_offset"] = u(batch_size, num_gt, 2)
    if c.second_stage_dropout:
        draws["dropout"] = u(*model.dropout_shape(batch_size))
    return draws


def global_rows(rows: int, replicas=None) -> int:
    """The global batch's rows when each rank holds `rows` of them."""
    return rows if replicas is None else rows * replicas.batch_ranks


def rank_rows(draws: Dict, replicas=None) -> Dict:
    """This rank's rows of draws made for the global batch (an option's
    draws may be a dict of tensors)."""
    if replicas is None:
        return draws
    return {k: rank_rows(v, replicas) if isinstance(v, dict) else replicas.rows(v)
            for k, v in draws.items()}


def make_train_step(model, regularization_fn: Optional[Callable] = None,
                    replicas=None, ema_decay: Optional[float] = None) -> Callable:
    """Returns step(state, batch, generator=None, draws=None) -> (state,
    metrics). batch: image [B, H, W, 3] (uint8 or float), true_shape
    [B, 2], gt_boxes [B, G, 4], gt_classes [B, G], gt_mask [B, G] and,
    for a mask model, gt_instance_masks [B, G, h, w], all on the model's
    device. The draws not given come from `generator`.
    metrics: every loss term, total_loss and grad_norm (of the raw
    gradients), as tensors on the device.

    With `replicas` (parallel/distributed.py) the batch is this rank's
    rows of the global batch: draws made here are the global batch's,
    of which the rank takes its rows; the live batch norms sum their
    statistics over the ranks; after the backward the gradients and the
    loss terms are averaged over the ranks in one all-reduce, so the clip
    sees the global norm of the averaged gradient (as optax does under
    jit) and every rank takes the same update.

    `ema_decay` keeps the state's moving average of the parameters (the
    state must carry one: create_train_state(keep_ema=True)).

    `step.warm_up(state, batch, generator=None, draws=None)` runs the
    step's forward and backward at the batch's shape and commits nothing
    (the train CLI's --precompile_buckets)."""
    from mtlx_torch.backbones.resnet import live_batch_norms

    norms = live_batch_norms(model.modules)
    for norm in norms:
        norm.replicas = replicas

    def forward_backward(state: TrainState, batch: Dict[str, Tensor],
                         generator: Optional[torch.Generator], draws: Optional[Dict],
                         ranks) -> Dict[str, Tensor]:
        """The losses of the batch, their gradients left in the parameters'
        .grad (cleared first)."""
        m = state.model
        images = m.preprocess(batch["image"].float())
        gt = {"boxes": batch["gt_boxes"].float(), "classes": batch["gt_classes"].long(),
              "mask": batch["gt_mask"].bool()}
        if "gt_instance_masks" in batch:
            gt["instance_masks"] = batch["gt_instance_masks"]
        draws = dict(draws or {})
        if generator is not None:
            made = make_draws(m, global_rows(images.shape[0], ranks),
                              canvas_hw(images, getattr(m, "spatial", None)), generator,
                              num_gt=gt["boxes"].shape[1])
            draws = {**rank_rows(made, ranks), **draws}
        for p in state.params.values():
            p.grad = None
        pred = m.predict_train(images, batch["true_shape"], gt, draws)
        losses = dict(m.loss(pred, gt, draws, replicas=ranks))
        if regularization_fn is not None:
            reg = regularization_fn(state.params)
            losses["Loss/regularization_loss"] = reg
            losses["total_loss"] = losses["total_loss"] + reg
        losses["total_loss"].backward()
        return losses

    def warm_up(state: TrainState, batch: Dict[str, Tensor],
                generator: Optional[torch.Generator] = None,
                draws: Optional[Dict[str, Tensor]] = None) -> None:
        """One forward and backward at the batch's shape that commits
        nothing: the gradients and the live batch norms' statistics are
        dropped, the optimizer, the moving average and the step count are
        not touched, and no other rank takes part."""
        for norm in norms:
            norm.replicas = None
        try:
            forward_backward(state, batch, generator, draws, None)
        finally:
            for p in state.params.values():
                p.grad = None
            for norm in norms:
                norm.batch_stats = None
                norm.replicas = replicas

    def step(state: TrainState, batch: Dict[str, Tensor],
             generator: Optional[torch.Generator] = None,
             draws: Optional[Dict[str, Tensor]] = None):
        params = state.params
        losses = forward_backward(state, batch, generator, draws, replicas)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in params.items()}
        metrics = {k: v.detach() for k, v in losses.items()}
        if replicas is not None:
            replicas.average_(list(grads.values()) + list(metrics.values()))
        grad_norm = global_norm(list(grads.values()))
        updates, opt_state = state.tx.update(grads, state.opt_state)
        with torch.no_grad():
            torch._foreach_add_([params[n] for n in opt_state.names], updates)
            for norm in norms:
                norm.commit()
            if ema_decay is not None and state.ema is not None:
                d = np.float32(ema_decay)
                names = list(state.ema)
                ema = torch._foreach_mul([state.ema[n] for n in names], float(d))
                torch._foreach_add_(ema, torch._foreach_mul(
                    [params[n].detach() for n in names], float(np.float32(1) - d)))
                state = dataclasses.replace(state, ema=dict(zip(names, ema)))
        metrics["grad_norm"] = grad_norm
        return dataclasses.replace(state, step=state.step + 1, opt_state=opt_state), metrics

    step.warm_up = warm_up
    return step

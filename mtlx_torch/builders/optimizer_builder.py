"""optimizer_builder + learning schedules (port of
mtlx/builders/optimizer_builder.py): the momentum, RMSProp and Adam
optimizers (optax's sgd, rmsprop and adam, in mtlx's chain order:
bias multiplier, freeze, clip, then the optimizer) with a constant,
exponential-decay, manual-step or warm-up + cosine learning rate, each
the optax schedule mtlx builds, and the decay of the moving average of
the weights (use_moving_average, true by the proto's default).
"""

from __future__ import annotations

from mtlx_torch.train.train_step import (
    ExponentialDecaySchedule,
    Optimizer,
    PiecewiseConstantSchedule,
    WarmupCosineDecaySchedule,
    make_optimizer,
)


def build_learning_rate(lr_proto):
    """A LearningRate proto -> a float or a schedule(count)."""
    kind = lr_proto.WhichOneof("learning_rate")
    if kind is None or kind == "constant_learning_rate":
        return lr_proto.constant_learning_rate.learning_rate
    if kind == "exponential_decay_learning_rate":
        p = lr_proto.exponential_decay_learning_rate
        return ExponentialDecaySchedule(p.initial_learning_rate, p.decay_steps, p.decay_factor,
                                        p.staircase)
    if kind == "manual_step_learning_rate":
        p = lr_proto.manual_step_learning_rate
        boundaries_and_scales = {}
        prev = p.initial_learning_rate
        for s in p.schedule:
            boundaries_and_scales[int(s.step)] = s.learning_rate / prev
            prev = s.learning_rate
        return PiecewiseConstantSchedule(p.initial_learning_rate, boundaries_and_scales)
    if kind == "cosine_decay_learning_rate":
        p = lr_proto.cosine_decay_learning_rate
        return WarmupCosineDecaySchedule(p.warmup_learning_rate, p.learning_rate_base,
                                         p.warmup_steps, p.total_steps)
    raise ValueError(f"unknown learning rate {kind!r}")


def build(optimizer_proto, train_config=None):
    """Returns (optimizer, learning rate or schedule, ema_decay); ema_decay
    is the moving-average rate when use_moving_average is set (the
    proto's default), else None."""
    kind = optimizer_proto.WhichOneof("optimizer")
    ema_decay = (optimizer_proto.moving_average_decay
                 if optimizer_proto.use_moving_average else None)
    chain = dict(
        gradient_clipping_by_norm=train_config.gradient_clipping_by_norm if train_config else 0.0,
        bias_grad_multiplier=train_config.bias_grad_multiplier if train_config else 0.0,
        freeze_variables=tuple(train_config.freeze_variables) if train_config else (),
    )
    if kind == "momentum_optimizer":
        p = optimizer_proto.momentum_optimizer
        lr = build_learning_rate(p.learning_rate)
        return make_optimizer(learning_rate=lr, momentum=p.momentum_optimizer_value,
                              **chain), lr, ema_decay
    if kind == "rms_prop_optimizer":
        p = optimizer_proto.rms_prop_optimizer
        lr = build_learning_rate(p.learning_rate)
        return Optimizer(lr, momentum=p.momentum_optimizer_value, kind="rmsprop",
                         decay=p.decay, epsilon=p.epsilon, **chain), lr, ema_decay
    if kind == "adam_optimizer":
        p = optimizer_proto.adam_optimizer
        lr = build_learning_rate(p.learning_rate)
        return Optimizer(lr, kind="adam", **chain), lr, ema_decay
    raise ValueError(f"unknown optimizer {kind!r}")

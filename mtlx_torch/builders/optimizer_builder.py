"""optimizer_builder + learning schedules (port of
mtlx/builders/optimizer_builder.py, the momentum optimizer with a
constant or manual-step learning rate).

The exponential and cosine schedules, the RMSProp and Adam optimizers
and moving averages of the weights are not ported yet: ROADMAP.md
queue 1 #13.
"""

from __future__ import annotations

from mtlx_torch.train.train_step import PiecewiseConstantSchedule, make_optimizer


def build_learning_rate(lr_proto):
    """A LearningRate proto -> a float or a schedule(count)."""
    kind = lr_proto.WhichOneof("learning_rate")
    if kind is None or kind == "constant_learning_rate":
        return lr_proto.constant_learning_rate.learning_rate
    if kind == "manual_step_learning_rate":
        p = lr_proto.manual_step_learning_rate
        boundaries_and_scales = {}
        prev = p.initial_learning_rate
        for s in p.schedule:
            boundaries_and_scales[int(s.step)] = s.learning_rate / prev
            prev = s.learning_rate
        return PiecewiseConstantSchedule(p.initial_learning_rate, boundaries_and_scales)
    raise NotImplementedError(
        f"learning rate {kind!r} is not ported: ROADMAP.md queue 1 #13"
    )


def build(optimizer_proto, train_config=None):
    """Returns (optimizer, learning rate or schedule, ema_decay); ema_decay
    is None (moving averages are not ported and raise when asked for)."""
    kind = optimizer_proto.WhichOneof("optimizer")
    if kind != "momentum_optimizer":
        raise NotImplementedError(
            f"optimizer {kind!r} is not ported: ROADMAP.md queue 1 #13"
        )
    if optimizer_proto.use_moving_average:
        raise NotImplementedError(
            "use_moving_average (EMA of the weights) is not ported: ROADMAP.md "
            "queue 1 #13"
        )
    p = optimizer_proto.momentum_optimizer
    lr = build_learning_rate(p.learning_rate)
    tx = make_optimizer(
        learning_rate=lr,
        momentum=p.momentum_optimizer_value,
        gradient_clipping_by_norm=train_config.gradient_clipping_by_norm if train_config else 0.0,
        bias_grad_multiplier=train_config.bias_grad_multiplier if train_config else 0.0,
        freeze_variables=tuple(train_config.freeze_variables) if train_config else (),
    )
    return tx, lr, None

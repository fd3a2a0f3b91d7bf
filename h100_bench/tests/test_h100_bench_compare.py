"""The comparison that decides `correct`, driven through a whole run on
the CPU at a small size (the look for a card skipped): a sound run
passes; each fault a train cell can have, planted under the timed path,
fails it, and so do a wrong update and faults that act only in the
window; the control (control.py's float8 stand-in in the port's place)
fails the committed limits."""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from h100_bench import compare, control, drive_train


def run(spec, fault=None):
    return drive_train.run(spec, 2**31 + 11, 0.1, False, "cpu", fault=fault)


def test_sound_run_is_correct(tiny_spec):
    out = run(tiny_spec)
    assert out["correct"], out["values"]
    v = out["values"]
    assert set(v) == set(compare.NUMBERS) and v["proposal_mismatch"] == 0
    assert v["grad_gap"] < 1e-4 and v["change_gap"] < 1e-4 and v["rpn_l2"] < 1e-4
    assert v["window_rpn_l2"] < 1e-4 and v["window_loss_gap"] < 1e-5
    assert v["window_change_gap"] < 1e-4


def unchanged_state(step_fn):
    """A step that returns its state unchanged (it computes, commits
    nothing)."""
    def step(state, batch, draws=None, generator=None):
        snapshot = {n: p.detach().clone() for n, p in state.params.items()}
        new, metrics = step_fn(state, batch, draws=draws, generator=generator)
        with torch.no_grad():
            for n, p in state.params.items():
                p.copy_(snapshot[n])
        return state, metrics
    return step


def restored_params(step_fn):
    """A step that computes its update and hands on its new state (trace,
    count) but leaves the parameters as they were."""
    def step(state, batch, draws=None, generator=None):
        snapshot = {n: p.detach().clone() for n, p in state.params.items()}
        new, metrics = step_fn(state, batch, draws=draws, generator=generator)
        with torch.no_grad():
            for n, p in new.params.items():
                p.copy_(snapshot[n])
        return new, metrics
    return step


def scaled_lr(step_fn, scale=10.0, after=0):
    """The learning rate times `scale`, from the state's step `after` on."""
    def step(state, batch, draws=None, generator=None):
        if state.step >= after and not getattr(state.tx, "scaled", False):
            tx = copy.copy(state.tx)
            real = tx.lr
            tx.lr = lambda count: np.float32(scale * real(count))
            tx.scaled = True
            state = dataclasses.replace(state, tx=tx)
        return step_fn(state, batch, draws=draws, generator=generator)
    return step


def window_scaled_lr(step_fn):
    """The learning rate ten times over in the window's steps alone (after
    the set-up pass over the pool of four), as a path that the program
    took only once warm would."""
    return scaled_lr(step_fn, after=4)


def window_unchanged_state(step_fn):
    """The state returned unchanged in the window's steps alone."""
    frozen = unchanged_state(step_fn)

    def step(state, batch, draws=None, generator=None):
        return (frozen if state.step >= 4 else step_fn)(state, batch, draws=draws,
                                                        generator=generator)
    return step


def half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest."""
    def step(state, batch, draws=None, generator=None):
        n = batch["image"].shape[0] // 2
        return step_fn(state, {k: v[:n] for k, v in batch.items()},
                       draws={k: v[:n] for k, v in draws.items()}, generator=generator)
    return step


def altered_answer(step_fn):
    """One answer altered where it is produced: the RPN's objectness
    logits of the first image with their sign flipped."""
    def step(state, batch, draws=None, generator=None):
        rpn = state.model.modules.rpn
        real = rpn.forward

        def forward(features):
            obj, enc = real(features)
            obj = obj.clone()
            obj[0] = -obj[0]
            return obj, enc
        rpn.forward = forward
        try:
            return step_fn(state, batch, draws=draws, generator=generator)
        finally:
            del rpn.forward
    return step


@pytest.mark.parametrize("fault", [unchanged_state, half_batch, altered_answer, restored_params,
                                   scaled_lr, window_scaled_lr, window_unchanged_state])
def test_fault_is_not_correct(tiny_spec, fault):
    out = run(tiny_spec, fault)
    assert not out["correct"], out["values"]


@pytest.mark.parametrize("spec", ["tiny_spec", "tiny_serve_spec"])
def test_control_is_not_correct(spec, request):
    """The control's numbers, as control.py reads them, fail the cell's
    committed limits (the limits of the cell the tiny spec is cut from)."""
    spec = request.getfixturevalue(spec)
    got = {kind: values for kind, values, _ in
           control.readings(spec, 2**31 + 17, 0.1, "cpu", ["sound", "control"])}
    assert compare.verdict(got["sound"], spec["limits"]), got["sound"]
    assert not compare.verdict(got["control"], spec["limits"]), got["control"]


def serve(spec, fault=None):
    from h100_bench import drive_serve

    return drive_serve.run(spec, 2**31 + 13, 0.1, False, "cpu", fault=fault)


def test_sound_serving_is_correct(tiny_serve_spec):
    out = serve(tiny_serve_spec)
    assert out["correct"], out["values"]
    assert out["values"]["detection_mismatch"] == 0 and out["values"]["second_l2"] < 1e-4


def serve_half_batch(predict):
    """Half of the call's images served, their detections given twice."""
    def call(arrays):
        n = max(1, len(arrays) // 2)
        out = predict(arrays[:n])
        return {k: np.concatenate([v, v])[: len(arrays)] for k, v in out.items()}
    return call


def serve_altered_answer(predict):
    """One answer altered where it is produced: the first detection's
    score of each call raised by a tenth."""
    def call(arrays):
        out = dict(predict(arrays))
        scores = out["detection_scores"].copy()
        scores[:, 0] += 0.1
        out["detection_scores"] = scores
        return out
    return call


@pytest.mark.parametrize("fault", [serve_half_batch, serve_altered_answer])
def test_serving_fault_is_not_correct(tiny_serve_spec, fault):
    out = serve(tiny_serve_spec, fault)
    assert not out["correct"], out["values"]

"""Checkpoint / resume / warm start (port of mtlx/train/checkpoints.py),
torch-native: no orbax.

A checkpoint is one file, `<directory>/ckpt-<step>.pt`: a plain dict of
tensors, ints and strings that `torch.load(..., weights_only=True)` reads
(the step, the parameters, the batch-norm buffers (a live batch norm's
moving statistics among them), the optimizer's slots with their
parameter names and count: the momentum trace, and RMSProp's or Adam's
second moment, and the moving average of the parameters where the run
keeps one). Eval and export read the moving average in place of the
parameters when eval_config.use_moving_averages asks for it. It is written to a
temporary name on a background thread and renamed into place, so a
reader never sees half a file. Pruning keeps the newest `max_to_keep`;
with `keep_every_n_hours`, an older checkpoint also survives when it was
written at least that long after the last older one kept (the oldest
is kept as the first).

Warm start restores the matching tensors from a port checkpoint or from
an `.npz` of mtlx's flax variables (keys are `/`-joined flax paths such
as `params/backbone/conv1/kernel`, mapped through `bridge`), skipping
absent or shape-mismatched ones and counting both, as mtlx does; with
`from_detection_checkpoint` false only the backbone is restored.
"""

from __future__ import annotations

import dataclasses
import os
import re
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from mtlx_torch.train.train_step import OptState, TrainState

FORMAT = "mtlx_torch-checkpoint-v1"
_NAME = re.compile(r"^ckpt-(\d+)\.pt$")


def checkpoint_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"ckpt-{step}.pt")


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).contiguous()


def state_to_dict(state: TrainState) -> Dict:
    """The checkpoint dict of a train state, on the host."""
    modules = state.model.modules
    return {
        "format": FORMAT,
        "step": int(state.step),
        "params": {n: _host(p) for n, p in modules.named_parameters()},
        "buffers": {n: _host(b) for n, b in modules.named_buffers()},
        "opt_count": int(state.opt_state.count),
        "opt_names": list(state.opt_state.names),
        "opt_trace": [_host(t) for t in state.opt_state.trace],
        **({"opt_nu": [_host(t) for t in state.opt_state.nu]}
           if state.opt_state.nu is not None else {}),
        **({"ema": {n: _host(t) for n, t in state.ema.items()}}
           if state.ema is not None else {}),
    }


def load_checkpoint(path: str) -> Dict:
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    if not isinstance(ckpt, dict) or ckpt.get("format") != FORMAT:
        raise ValueError(f"{path} is not an mtlx_torch checkpoint")
    return ckpt


def _load_weights(model, tensors: Dict[str, torch.Tensor], where: str) -> None:
    """Copy every parameter and buffer of the model from `tensors` (extra
    entries, such as a training model's aux heads, are ignored)."""
    state = model.modules.state_dict()
    missing = [k for k in state if k not in tensors]
    if missing:
        raise KeyError(f"{where} lacks {len(missing)} tensors of the model, e.g. {missing[:3]}")
    bad = [k for k in state if tuple(tensors[k].shape) != tuple(state[k].shape)]
    if bad:
        raise ValueError(f"{where} has other shapes for {bad[:3]}")
    model.modules.load_state_dict({k: tensors[k] for k in state})


class CheckpointManager:
    """The checkpoints of one train directory."""

    def __init__(self, directory: str, max_to_keep: int = 5, keep_every_n_hours: float = 0.0):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.keep_every_n_hours = float(keep_every_n_hours or 0.0)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def all_steps(self) -> List[int]:
        if not os.path.isdir(self.directory):
            return []
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.directory)) if m)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def save(self, step: int, state: TrainState) -> None:
        """Copy the state to the host now and write it on a background
        thread (one write at a time)."""
        self.wait()
        ckpt = state_to_dict(state)
        ckpt["step"] = int(step)
        os.makedirs(self.directory, exist_ok=True)

        def write():
            try:
                path = checkpoint_path(self.directory, step)
                tmp = f"{path}.tmp{os.getpid()}"
                torch.save(ckpt, tmp)
                os.replace(tmp, path)
                self._prune()
            except BaseException as e:  # raised by the next wait()
                self._error = e

        self._writer = threading.Thread(target=write, daemon=True)
        self._writer.start()

    def wait(self) -> None:
        """Block until the last save is on disk; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self) -> None:
        steps = self.all_steps()
        interval = self.keep_every_n_hours * 3600.0
        last_kept = None
        for step in steps[:-self.max_to_keep] if self.max_to_keep else []:
            path = checkpoint_path(self.directory, step)
            written = os.path.getmtime(path)
            if interval and (last_kept is None or written - last_kept >= interval):
                last_kept = written
                continue
            os.remove(path)

    def restore(self, state: TrainState, step: Optional[int] = None,
                params_only: bool = False, use_ema: bool = False) -> Optional[TrainState]:
        """The state with the checkpoint's weights loaded into its model (in
        place) and, unless params_only, its step, optimizer state and
        moving average. With use_ema the model takes the checkpoint's
        moving average of the parameters where it has one (mtlx's eval and
        export with use_moving_averages)."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None
        path = checkpoint_path(self.directory, step)
        ckpt = load_checkpoint(path)
        params = ckpt["ema"] if use_ema and "ema" in ckpt else ckpt["params"]
        _load_weights(state.model, {**params, **ckpt["buffers"]}, path)
        if params_only:
            return dataclasses.replace(state, step=int(ckpt["step"]))
        if list(ckpt["opt_names"]) != list(state.opt_state.names):
            raise ValueError(f"{path}: the optimizer state is of other parameters")
        if ("opt_nu" in ckpt) != (state.opt_state.nu is not None):
            raise ValueError(f"{path}: the optimizer state is of another optimizer")
        live = state.params

        def slots(key):
            return [torch.empty_like(live[n]).copy_(t)
                    for n, t in zip(ckpt["opt_names"], ckpt[key])]

        opt_state = OptState(int(ckpt["opt_count"]), list(ckpt["opt_names"]), slots("opt_trace"),
                             slots("opt_nu") if "opt_nu" in ckpt else None)
        ema = state.ema
        if ema is not None:  # a checkpoint without one starts it at its weights
            source = ckpt.get("ema", ckpt["params"])
            ema = {n: torch.empty_like(live[n]).copy_(source[n]) for n in ema}
        return dataclasses.replace(state, step=int(ckpt["step"]), opt_state=opt_state, ema=ema)


def _npz_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The port's tensors of an `.npz` of flax variables."""
    from mtlx_torch import bridge

    tree: Dict = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if len(parts) < 3 or not (bridge.is_inference_module(parts[1])
                                      or parts[1] in bridge.TRAINING_ONLY_MODULES):
                continue  # no counterpart in the port: absent, so skipped
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return bridge.flax_to_state_dict(tree, training_heads=True)


def restore_warm_start(model, checkpoint_path_: str,
                       from_detection_checkpoint: bool = True) -> Tuple[int, int]:
    """Copy the matching tensors of a checkpoint into `model`; returns
    (restored, skipped). The checkpoint is a port checkpoint file, a
    directory of them (the latest is read) or an `.npz` of flax
    variables."""
    path = checkpoint_path_
    if path.endswith(".npz"):
        source = _npz_state_dict(path)
    else:
        if os.path.isdir(path):
            latest = CheckpointManager(path).latest_step()
            if latest is None:
                raise FileNotFoundError(f"no checkpoint in {path}")
            path = checkpoint_path(path, latest)
        ckpt = load_checkpoint(path)
        source = {**ckpt["params"], **ckpt["buffers"]}
    state = model.modules.state_dict()
    restored = skipped = 0
    updates = {}
    for name, dst in state.items():
        if not from_detection_checkpoint and not any("backbone" in p for p in name.split(".")):
            continue
        src = source.get(name)
        if src is None or tuple(src.shape) != tuple(dst.shape):
            skipped += 1
            continue
        updates[name] = src
        restored += 1
    model.modules.load_state_dict({**state, **updates})
    return restored, skipped


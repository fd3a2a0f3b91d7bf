"""mtlx_torch's torch-native checkpoints: a bit-exact round trip of the
train state, pruning by max_to_keep and keep_every_n_hours, and warm
start counts equal to mtlx's `restore_warm_start` on the same variables.

Tolerance: none (a checkpoint holds the tensors' bits; the warm start
copies them).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
from mtlx_torch.train import checkpoints as tckpt
from mtlx_torch.train import train_step as ts


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _model(seed: int) -> FasterRCNN:
    cfg = dataclasses.replace(flagship_train_config(torch.float32), backbone="resnet10",
                              canvas_size=(128, 128))
    model = FasterRCNN(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


@pytest.fixture(scope="module")
def models():
    return _model(0), _model(1)


def _state(model, seed: int) -> ts.TrainState:
    state = ts.create_train_state(model, ts.make_optimizer(learning_rate=0.01))
    gen = torch.Generator().manual_seed(seed)
    for t in state.opt_state.trace:
        t.copy_(torch.randn(t.shape, generator=gen))
    for b in model.modules.buffers():
        b.copy_(torch.rand(b.shape, generator=gen))
    return dataclasses.replace(state, step=7,
                               opt_state=dataclasses.replace(state.opt_state, count=7))


def test_round_trip_is_bit_exact(tmp_path, models):
    src, dst = models
    state = _state(src, 0)
    manager = tckpt.CheckpointManager(str(tmp_path))
    manager.save(7, state)
    manager.wait()
    assert manager.latest_step() == 7
    raw = torch.load(tckpt.checkpoint_path(str(tmp_path), 7), weights_only=True)
    assert raw["format"] == tckpt.FORMAT and raw["step"] == 7
    restored = manager.restore(ts.create_train_state(dst, ts.make_optimizer()))
    assert restored.step == 7 and restored.opt_state.count == 7
    for (n, a), (_, b) in zip(src.modules.state_dict().items(), dst.modules.state_dict().items()):
        assert torch.equal(a, b), n
    for a, b in zip(state.opt_state.trace, restored.opt_state.trace):
        assert torch.equal(a, b)
    # params_only leaves the optimizer state alone
    fresh = ts.create_train_state(dst, ts.make_optimizer())
    only = manager.restore(fresh, params_only=True)
    assert only.step == 7 and only.opt_state is fresh.opt_state


def test_pruning(tmp_path, models):
    state = _state(models[0], 1)
    manager = tckpt.CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in range(1, 6):
        manager.save(step, state)
    manager.wait()
    assert manager.all_steps() == [4, 5]
    # keep_every_n_hours: an old checkpoint survives when written at least
    # that long after the last old one kept (the oldest is the first kept)
    hourly = tckpt.CheckpointManager(str(tmp_path / "hourly"), max_to_keep=2,
                                     keep_every_n_hours=1.0)
    hours = {1: 0.0, 2: 0.5, 3: 1.2, 4: 1.5, 5: 2.5, 6: 2.6}
    os.makedirs(hourly.directory)
    for step, h in hours.items():
        path = tckpt.checkpoint_path(hourly.directory, step)
        open(path, "wb").close()
        os.utime(path, (1e9 + h * 3600, 1e9 + h * 3600))
    hourly._prune()
    assert hourly.all_steps() == [1, 3, 5, 6]


def _to_flax(state_dict):
    """mtlx's flax variables of a port state_dict (the bridge's inverse)."""
    out = {"params": {}, "batch_stats": {}}
    for name, t in state_dict.items():
        *path, leaf = name.split(".")
        arr = t.numpy()
        collection = "batch_stats" if leaf in ("mean", "var") else "params"
        if leaf == "weight":
            leaf = "kernel"
            arr = arr.transpose(2, 3, 1, 0) if arr.ndim == 4 else arr.T
        node = out[collection]
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = np.ascontiguousarray(arr)
    return out


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("from_detection", [True, False])
def test_warm_start_counts_equal_mtlx(tmp_path, models, from_detection):
    from mtlx.train import checkpoints as jckpt

    src_model, _ = models
    source = _to_flax(src_model.modules.state_dict())
    # absent and shape-mismatched leaves, in the backbone and outside it
    del source["params"]["backbone"]["conv1"]["kernel"]
    del source["params"]["rpn"]
    source["params"]["box_predictor"]["box_refinement"]["kernel"] = np.zeros((3, 3), np.float32)
    source["batch_stats"]["backbone"]["bn1"]["mean"] = np.zeros((5,), np.float32)
    jckpt.save_variables(str(tmp_path / "orbax"), source)
    npz = str(tmp_path / "variables.npz")
    np.savez(npz, **{"/".join(path): v for path, v in _flat(source)})

    target = _model(2)
    want_vars, want_restored, want_skipped = jckpt.restore_warm_start(
        _to_flax(target.modules.state_dict()), str(tmp_path / "orbax"), from_detection)
    restored, skipped = tckpt.restore_warm_start(target, npz, from_detection)
    assert (restored, skipped) == (want_restored, want_skipped)
    assert restored > 0 and skipped > 0
    got = _to_flax(target.modules.state_dict())
    want = dict(_flat(want_vars))
    for path, v in _flat(got):
        assert np.array_equal(v, np.asarray(want[path])), path


def test_warm_start_from_port_checkpoint(tmp_path, models):
    src, dst = models
    manager = tckpt.CheckpointManager(str(tmp_path))
    manager.save(3, _state(src, 2))
    manager.wait()
    total = len(dst.modules.state_dict())
    assert tckpt.restore_warm_start(dst, str(tmp_path), True) == (total, 0)
    backbone = sum(any("backbone" in p for p in n.split(".")) for n in dst.modules.state_dict())
    assert tckpt.restore_warm_start(dst, tckpt.checkpoint_path(str(tmp_path), 3), False) == \
        (backbone, 0)
    for (n, a), (_, b) in zip(src.modules.state_dict().items(), dst.modules.state_dict().items()):
        assert torch.equal(a, b), n

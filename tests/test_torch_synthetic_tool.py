"""The port's learnability tool (`mtlx_torch/tools/synthetic_e2e_check.py`)
against mtlx's (`tools/synthetic_e2e_check.py`) on the CPU, and the event
files its train and eval CLI runs write.

  * The dataset: the same 48 JPEG records (equal Examples, the same JPEG
    bytes), and the same CONFIG and SSD_CONFIG texts.
  * A short run end to end with `--device cpu --require_map 0`: 31 steps,
    the fewest the tool's schedule allows (its warm-up is 30 steps, and
    optax, so mtlx's tool too, refuses a cosine decay of total_steps <=
    warmup_steps; `--steps 2` raises in both).
  * The event files parse with mtlx's `event_pb2`: the train file holds
    every logged step's losses and learning_rate, the eval file the
    metrics. Tolerance: the scalars equal the float32 of what the CLIs
    returned or printed (learning_rate exactly; the losses within the
    4-decimal rounding of the printed line).
"""

import glob
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from mtlx_torch.tools import synthetic_e2e_check as ttool

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "mtlx_synthetic_e2e_check", os.path.join(_REPO, "tools", "synthetic_e2e_check.py"))
jtool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jtool)


def _events(directory):
    from mtlx.config.protos import event_pb2
    from mtlx.data.tfrecord import read_records

    (path,) = glob.glob(os.path.join(directory, "events.out.tfevents.*"))
    return [event_pb2.Event.FromString(r) for r in read_records(path)]


def test_dataset_and_config_equal_mtlx(tmp_path):
    """The same records: equal Example messages of the same length, with
    the same JPEG bytes. The files differ in the order of each Example's
    feature map only (protobuf writes a map in its own hash order, the
    port in insertion order)."""
    from mtlx.config.protos import example_pb2
    from mtlx.data.tfrecord import read_records

    assert ttool.CONFIG == jtool.CONFIG
    jtool.make_dataset(str(tmp_path / "mtlx.record"))
    ttool.make_dataset(str(tmp_path / "port.record"))
    want = list(read_records(str(tmp_path / "mtlx.record")))
    got = list(read_records(str(tmp_path / "port.record")))
    assert len(got) == len(want) == 48
    for g, w in zip(got, want):
        assert len(g) == len(w)
        g, w = example_pb2.Example.FromString(g), example_pb2.Example.FromString(w)
        assert g == w
        image = g.features.feature["image/encoded"].bytes_list.value[0]
        assert image == w.features.feature["image/encoded"].bytes_list.value[0]
        assert image[:3] == b"\xff\xd8\xff"


def test_unported_model_and_short_schedule_raise(tmp_path):
    # both models are ported: the SSD mode's config is mtlx's, an unknown
    # model is refused, and each mode's short schedule raises
    assert ttool.SSD_CONFIG == jtool.SSD_CONFIG
    with pytest.raises(SystemExit):
        ttool.parse_args(["--model", "yolo"])
    assert ttool.parse_args(["--model", "ssd"]).require_map == 0.3
    assert ttool.parse_args([]).require_map == 0.5
    for model in ("frcnn", "ssd"):
        with pytest.raises(ValueError, match="decay_steps > warmup_steps"):
            ttool.main(["--model", model, "--steps", "2", "--device", "cpu",
                        "--workdir", str(tmp_path / model)])


def test_short_run_end_to_end_writes_event_files(tmp_path, capsys):
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        metrics = ttool.main(["--steps", "31", "--device", "cpu", "--require_map", "0",
                              "--workdir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "[train] done at step 31" in out and "[synthetic-e2e] PASSED" in out
    assert np.isfinite(metrics["Precision/mAP@0.5IOU"])
    lr_line = next(ln for ln in out.splitlines() if ln.startswith("[synthetic-e2e] learning"))
    lrs = json.loads(lr_line.split("update ", 1)[1])
    assert set(lrs) == {"0", "30"} and lrs["0"] == pytest.approx(0.001, rel=1e-6)

    lines = [json.loads(ln[len("[train] "):]) for ln in out.splitlines()
             if ln.startswith("[train] {")]
    assert [ln["step"] for ln in lines] == [1]  # --log_every 50, and step 1
    events = _events(str(tmp_path / "train"))
    assert events[0].file_version == "brain.Event:2"
    scalars = {}
    for ev in events[1:]:
        for v in ev.summary.value:
            scalars[(ev.step, v.tag)] = v.simple_value
    for line in lines:
        step = line["step"]
        assert scalars[(step, "learning_rate")] == np.float32(line["learning_rate"])
        assert (step, "global_step/sec") in scalars
        for key, value in line.items():
            if key.startswith("Loss/") or key in ("total_loss", "grad_norm"):
                assert abs(scalars[(step, key)] - value) <= 5e-5 + 1e-6 * abs(value), key

    eval_events = _events(str(tmp_path / "eval"))
    got = {v.tag: v.simple_value for ev in eval_events[1:] for v in ev.summary.value}
    assert {ev.step for ev in eval_events[1:]} == {31}
    for key, value in metrics.items():
        if np.isfinite(value):
            assert got[key] == np.float32(value), key


def test_short_ssd_run_end_to_end(tmp_path, capsys):
    """`--model ssd`: SSD MobileNet-v1 x 0.5 with live batch norm on the
    128x128 canvas through the train and eval CLIs, 31 steps."""
    from mtlx_torch.train import checkpoints as ckpt_lib

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        metrics = ttool.main(["--model", "ssd", "--steps", "31", "--device", "cpu",
                              "--require_map", "0", "--workdir", str(tmp_path)])
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert "[train] done at step 31" in out and "[synthetic-e2e] PASSED" in out
    assert "canvas (128, 128)" in out
    assert np.isfinite(metrics["Precision/mAP@0.5IOU"])
    lines = [json.loads(ln[len("[train] "):]) for ln in out.splitlines()
             if ln.startswith("[train] {")]
    assert set(lines[0]) >= {"Loss/classification_loss", "Loss/localization_loss"}
    ckpt = ckpt_lib.load_checkpoint(os.path.join(tmp_path, "train", "ckpt-31.pt"))
    # the live batch norms moved their statistics; no moving average kept
    assert any(float(v.abs().sum()) > 0 for k, v in ckpt["buffers"].items()
               if k.endswith(".mean"))
    assert "ema" not in ckpt

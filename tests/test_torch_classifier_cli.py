"""The port's classifier pretraining CLI (mtlx_torch/train/train_classifier.py)
against mtlx's on the CPU.

  * the CLI's batches: the sampled record indices and the PIL decode and
    resize equal to mtlx's `_decode_batch`, bit for bit;
  * the CLI (`--device cpu`) for 2 steps at 32x32, batch 4, on records
    as tests/test_train_classifier.py writes them, for ResNet-50 and
    MobileNet-v1: finite losses at every logged step, the classifier
    checkpoint, and the exported backbone restored into a port Faster
    R-CNN ResNet-50 with from_detection_checkpoint false: every exported
    tensor restored, `backbone` and `classifier_backbone` both changed;
    without `--device` and without a card the CLI raises.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from mtlx.train import train_classifier as jcls
from mtlx_torch.data import tfrecord as ttfrecord
from mtlx_torch.train import train_classifier as tcls
from test_train_classifier import _write_cls_records


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def test_cli_batches_equal_mtlx(tmp_path):
    record = str(tmp_path / "cls.record")
    _write_cls_records(record, n=6, size=40)
    offsets = ttfrecord.record_index(record)
    indices = list(tcls.sample_indices(len(offsets), 3, 2))
    rng = np.random.RandomState(0)
    with open(record, "rb") as f:
        for idx in indices:
            assert np.array_equal(idx, rng.choice(len(offsets), 3))
            records = [ttfrecord.read_record_at(f, offsets[j]) for j in idx]
            for size in (24, 57):
                got = tcls.decode_batch(records, size)
                want = jcls._decode_batch(records, size)
                for g, w in zip(got, want):
                    assert g.dtype == w.dtype and np.array_equal(g, w)


def _cls_lines(out):
    return [json.loads(ln.split("[cls] ", 1)[1]) for ln in out.splitlines()
            if ln.startswith("[cls] {")]


@pytest.mark.parametrize("model", ["resnet50", "mobilenet_v1"])
def test_cli_trains_and_exports_a_warm_start(tmp_path, capsys, model):
    from mtlx_torch.detector.faster_rcnn import FasterRCNN, flagship_train_config
    from mtlx_torch.train import checkpoints as tckpt

    record = str(tmp_path / "cls.record")
    _write_cls_records(record)
    export = str(tmp_path / "warm_backbone.pt")
    argv = ["--model", model, "--train_record", record, "--train_dir",
            str(tmp_path / "cls_train"), "--num_classes", "3", "--image_size", "32",
            "--batch_size", "4", "--num_steps", "2", "--log_every", "1",
            "--export_backbone", export]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tcls.main(argv)
    last = tcls.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    lines = _cls_lines(out)
    assert [ln["step"] for ln in lines] == [1, 2] and last == lines[-1]
    assert all(np.isfinite(ln["loss"]) and 0 <= ln["accuracy"] <= 1 for ln in lines)
    assert "exported backbone warm-start checkpoint" in out and "[cls] done" in out
    assert tckpt.CheckpointManager(str(tmp_path / "cls_train" / "classifier")).all_steps() == [2]
    exported = tckpt.load_checkpoint(export)
    n = len(exported["params"]) + len(exported["buffers"])
    assert f"({n} tensors)" in out
    if model != "resnet50":
        assert all(k.startswith("backbone.") for k in exported["params"])
        return

    # the exported subtrees restore into the detector (classification
    # warm start: the backbone and block4 only)
    det = FasterRCNN(dataclasses.replace(flagship_train_config(torch.float32), num_classes=3),
                     device="cpu")
    det.init_weights(torch.Generator().manual_seed(0))
    before = {k: v.clone() for k, v in det.modules.state_dict().items()}
    restored, skipped = tckpt.restore_warm_start(det, export, from_detection_checkpoint=False)
    assert restored == n and skipped == 0
    after = det.modules.state_dict()
    for top in ("backbone.conv1.weight", "classifier_backbone.block4.unit1.conv1.weight"):
        assert not torch.equal(before[top], after[top])
        assert torch.equal(after[top], exported["params"][top])
    assert torch.equal(after["rpn.conv.weight"], before["rpn.conv.weight"])

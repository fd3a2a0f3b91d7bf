"""The port's CLI loop on the CPU, as tests/test_end_to_end.py runs
mtlx's: records -> train CLI -> checkpoints -> resume -> eval CLI ->
export -> InferenceModel.load -> predict, with `--device cpu`.

The config is tests/test_end_to_end.py's (a ResNet-50 MTL Faster R-CNN,
batch 2) at 64x64 instead of 96x96, to keep the CPU time down, with the
Pascal metrics only (the port has no COCO evaluator); the records are
PNG, so nothing here needs libjpeg or PIL.
Tolerance: with --deterministic (every epoch the same record order, as
a restart reads it) the resumed run must reproduce the uninterrupted
run's losses exactly: the checkpoint holds the weights and the momentum
bit for bit, and the draws of a step depend on the seed and the step.
"""

import ast
import json
import os
import shutil

import numpy as np
import pytest
import torch

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """Two intra-op threads: on a loaded CPU, torch's default (one a core)
    spends several times the CPU for the same wall time."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def _config() -> str:
    with open(os.path.join(_REPO, "tests", "test_end_to_end.py")) as f:
        tree = ast.parse(f.read())
    text = next(n.value.value for n in tree.body if isinstance(n, ast.Assign)
                and getattr(n.targets[0], "id", "") == "CONFIG")
    text = text.replace('  metrics_set: "coco_detection_metrics"\n', "")
    return text.replace("height: 96 width: 96", "height: 64 width: 64")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    from mtlx_torch.data import imgcodec, tfrecord
    from mtlx_torch.data.example_decoder import build_example

    tmp = tmp_path_factory.mktemp("cli")
    record = str(tmp / "train.record")
    rs = np.random.RandomState(0)
    with tfrecord.TFRecordWriter(record) as w:
        for i in range(4):
            arr = rs.randint(0, 255, (64, 64, 3), dtype=np.uint8)
            arr[8:28, 8:36] = [250, 30, 30]  # a "red object"
            boxes = np.asarray([[8 / 64, 8 / 64, 28 / 64, 36 / 64]], np.float32)
            w.write(build_example(imgcodec.encode_png(arr), b"png", 64, 64, f"im{i}.png",
                                  boxes, [1], ["a"]))
    label_map = str(tmp / "label_map.pbtxt")
    with open(label_map, "w") as f:
        for i, name in enumerate(["a", "b", "c"]):
            f.write(f"item {{ id: {i + 1} name: '{name}' }}\n")
    cfg = str(tmp / "pipeline.config")
    with open(cfg, "w") as f:
        f.write(_config().format(record=record, label_map=label_map))
    yield {"tmp": tmp, "config": cfg}
    # checkpoints and bundles of a full-width R50 (about a GiB): pytest
    # keeps each run's temporary directories
    shutil.rmtree(tmp, ignore_errors=True)


def _losses(out: str):
    return {json.loads(ln[8:])["step"]: json.loads(ln[8:])["total_loss"]
            for ln in out.splitlines() if ln.startswith("[train] {")}


def test_train_resume_eval_export_load_predict(workdir, capsys):
    from mtlx_torch.eval import eval as eval_cli
    from mtlx_torch.export.exporter import InferenceModel, export_inference_graph
    from mtlx_torch.train import checkpoints as ckpt_lib
    from mtlx_torch.train import train as train_cli

    cfg, tmp = workdir["config"], workdir["tmp"]
    common = ["--pipeline_config_path", cfg, "--device", "cpu", "--log_every", "1",
              "--deterministic"]
    # uninterrupted: 4 steps (num_steps of the config), checkpoints at 2 and 4
    train_cli.main(common + ["--train_dir", str(tmp / "straight")])
    out = capsys.readouterr().out
    assert "[train] done at step 4" in out
    straight = _losses(out)
    assert sorted(straight) == [1, 2, 3, 4]
    assert all(np.isfinite(v) for v in straight.values())
    assert os.path.exists(tmp / "straight" / "pipeline.config")
    assert ckpt_lib.CheckpointManager(str(tmp / "straight")).all_steps() == [2, 4]

    # interrupted after step 2, then resumed to step 4
    train_dir = str(tmp / "train")
    train_cli.main(common + ["--train_dir", train_dir, "--num_steps", "2"])
    capsys.readouterr()
    train_cli.main(common + ["--train_dir", train_dir])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "[train] done at step 4" in out
    resumed = _losses(out)
    assert resumed == {3: straight[3], 4: straight[4]}
    # a run at its last step takes none
    train_cli.main(common + ["--train_dir", train_dir])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "[train] done at step 4" in out
    assert not _losses(out)

    eval_dir = str(tmp / "eval")
    metrics = eval_cli.main(["--pipeline_config_path", cfg, "--checkpoint_dir", train_dir,
                             "--eval_dir", eval_dir, "--run_once", "--device", "cpu"])
    out = capsys.readouterr().out
    printed = json.loads(out.split("[eval] step 4: ")[1].splitlines()[0])
    assert np.isfinite(printed["Precision/mAP@0.5IOU"])
    assert printed["Precision/mAP@0.5IOU"] == round(metrics["Precision/mAP@0.5IOU"], 4)
    assert "PerformanceByCategory/AP@0.5IOU/a" in printed
    with open(os.path.join(eval_dir, "metrics.jsonl")) as f:
        assert json.loads(f.readline())["step"] == 4
    # --eval_training_data reads the train input: the same record here
    m_train = eval_cli.main(["--pipeline_config_path", cfg, "--checkpoint_dir", train_dir,
                             "--eval_dir", str(tmp / "eval_td"), "--run_once",
                             "--eval_training_data", "--device", "cpu",
                             "--eval_batch_size", "3"])
    capsys.readouterr()
    assert m_train["Precision/mAP@0.5IOU"] == metrics["Precision/mAP@0.5IOU"]

    export_dir = str(tmp / "export")
    export_inference_graph(cfg, train_dir, export_dir)
    infer = InferenceModel.load(export_dir, device="cpu")
    det = infer.predict_image_tensor(np.zeros((1, 64, 64, 3), np.uint8))
    assert det["detection_boxes"].shape == (1, 10, 4)
    assert (det["detection_classes"] >= 1).all()
    assert np.isfinite(det["detection_scores"]).all()


def test_unported_flags_raise():
    from mtlx_torch.train import train as train_cli

    base = ["--pipeline_config_path", "x", "--train_dir", "y"]
    # every flag of mtlx's CLI is ported: the input pipeline's flags parse
    # (tests/test_torch_host_geometry.py runs them)
    args = train_cli.parse_args(base + ["--grain_workers", "2", "--precompile_buckets",
                                        "--max_bucket_variants", "4"])
    assert (args.grain_workers, args.precompile_buckets, args.max_bucket_variants) == (2, True, 4)
    # data parallelism is ported: the flag parses
    assert train_cli.parse_args(base + ["--distributed"]).distributed
    args = train_cli.parse_args(base + ["--num_clones", "2", "--master", "grpc://x"])
    assert args.num_clones == 2
    # the profiler flags are ported: they parse
    args = train_cli.parse_args(base + ["--profile_from", "3"])
    assert (args.profile_from, args.profile_steps) == (3, 5)

"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""

import json
import os
import re

import pytest

from h100_bench import manifest

ROOT = manifest.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_keys_and_limits():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert b["paths"] == ["h100_bench"] and len(b["command"]) <= 32
    cells = len(b["workloads"])
    # a full check of 24 cells: two sets of runs a cell and its compiles within 43,200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert 1 <= cells <= 24
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]] + [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_metrics():
    b = bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in b["workloads"]}
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        assert callable(manifest.reader(m["name"]))


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_resolves(cell):
    b = bench()
    spec = manifest.load_cell(cell)
    w = spec["cell"]
    assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    from h100_bench import compare, drive_serve

    numbers = {"train": compare.NUMBERS, "serve": drive_serve.NUMBERS}[spec["traffic"]["kind"]]
    assert spec["limits"] and set(spec["limits"]) <= set(numbers)
    assert {m["name"] for m in spec["end_to_end"]} >= {"setup_s"}
    assert spec["per_layer"]
    config = next(c for c in b["configs"] if c["name"] == w["config"])
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("h100_bench/") and config["reduced"] == []


@pytest.mark.parametrize("name", [c["name"] for c in bench()["configs"]])
def test_config_is_what_the_builder_builds(name):
    """The configuration file's `model` block (the reference's sizes) is
    what the port's builder makes of its pipeline text."""
    import torch

    from mtlx_torch.builders import model_builder
    from mtlx_torch.config import config_util

    with open(os.path.join(ROOT, "h100_bench", "configs", name + ".json")) as f:
        config = json.load(f)
    pipeline = config_util.parse_pipeline_text("\n".join(config["pipeline"]))
    built = model_builder.build_config(pipeline.model, is_training=True, dtype=torch.bfloat16)
    m = config["model"]
    assert built.num_classes == m["num_classes"] and built.resnet_depth == m["resnet_depth"]
    assert list(built.canvas_size) == m["canvas_size"]
    for key in ("feature_stride", "rpn_depth", "rpn_kernel_size", "first_stage_pre_nms_top_k",
                "first_stage_max_proposals", "first_stage_minibatch_size",
                "initial_crop_size", "maxpool_kernel_size", "maxpool_stride",
                "second_stage_batch_size"):
        assert getattr(built, key) == m[key], key
    for key in ("anchor_scales", "anchor_aspect_ratios", "anchor_base_size"):
        assert list(getattr(built, key)) == pytest.approx(m[key]), key
    for key in ("first_stage_nms_iou_threshold", "first_stage_positive_balance_fraction",
                "first_stage_localization_loss_weight", "first_stage_objectness_loss_weight",
                "second_stage_balance_fraction", "second_stage_localization_loss_weight",
                "second_stage_classification_loss_weight"):
        assert getattr(built, key) == pytest.approx(m[key], rel=1e-7), key
    mtl = built.mtl
    assert (mtl.multiobject, mtl.closeness, mtl.foreground) == (True, True, True)
    assert mtl.multiobject_weight == pytest.approx(m["multiobject_weight"], rel=1e-7)
    assert mtl.closeness_weight == pytest.approx(m["closeness_weight"], rel=1e-7)
    assert mtl.foreground_weight == pytest.approx(m["foreground_weight"])
    assert not (mtl.window_sampling or mtl.refine or built.second_stage_dropout)
    assert not built.batch_norm_trainable and built.hard_example_miner is None


def test_same_parameters_on_both_sides():
    """One state dict loads into the port's detector and the reference."""
    import torch

    from h100_bench.drive_train import build_program
    from h100_bench.reference.detector import Config, Detector

    spec = manifest.load_cell("frcnn_r50_mtl_voc0712.train_b16")
    model = build_program(spec["config"], "cpu")[0]
    ref = Detector(Config.from_dict(spec["config"]["model"]))
    port = {n: tuple(p.shape) for n, p in model.modules.named_parameters()}
    mine = {n: tuple(p.shape) for n, p in ref.named_parameters()}
    assert port == mine
    assert {n for n, _ in model.modules.named_buffers()} == {n for n, _ in ref.named_buffers()}
    del torch

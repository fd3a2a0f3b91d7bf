"""The result line's schema, for both kinds of run."""

import json

from h100_bench import manifest, run


def fake_out(trace: bool):
    r = {"steps": 10, "images": 160, "window_s": 2.0, "model_flops": 1e14,
         "launches": {"nms": 10, "roi_crop": 10, "roi_crop_backward": 10, "iou": 30,
                      "paired_sums": 0, "bn_affine": 0}}
    if trace:
        r["trace"] = {"busy_s": 1.5, "window_s": 2.0, "device_ops": [["k", 1.0]],
                      "idle_gaps": [["aten::x", 0.1]],
                      "device_s_by_name": {"void iou_kernel<4>(float const*)": 0.001}}
        r["bounds"] = {"iou": 0.0005}
    return {"correct": True, "attempted": 10, "failed": 0, "setup_s": 20.0, "reference_s": 5.0,
            "peak_bytes": 2**34, "run": r, "values": {"grad_gap": 0.01},
            "compared": {"grad_gap": (0.01, 0.02)}}


def test_end_to_end_line():
    spec = manifest.load_cell("frcnn_r50_mtl_voc0712.train_b16")
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = json.loads(json.dumps(run.result_line(spec, fake_out(False), device, False)))
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "compared"
    assert set(line["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert line["metrics"]["train_img_per_s"]["value"] == 80.0
    assert line["metrics"]["peak_mem_gib"] == {"value": 16.0, "unit": "GiB"}
    assert line["device"]["memory_peak_bytes"] == 2**34
    assert line["compared"]["grad_gap"] == {"value": 0.01, "limit": 0.02}


def test_traced_line():
    spec = manifest.load_cell("frcnn_r50_mtl_voc0712.train_b16")
    device = {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 1}
    line = json.loads(json.dumps(run.result_line(spec, fake_out(True), device, True)))
    assert line["device"]["busy_s"] == 1.5 and line["device"]["window_s"] == 2.0
    m = line["metrics"]
    assert m["device_idle_share.train"]["value"] == 25.0
    assert m["launches_per_step.train"]["value"] == 6.0
    assert m["iou_roofline"]["value"] == 50.0
    assert "nms_roofline" not in m  # nothing to read: left out, not 0
    assert m["mfu.train"]["value"] == 100.0 * 1e14 / 2.0 / 989e12
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(line)[-1] == "compared"


def test_traced_run_on_the_cpu(tiny_spec):
    """A whole traced run at a small size: the profiler takes the window's
    last part, the line carries the trace's busy and window seconds and
    the per-layer metrics that find something to read."""
    from h100_bench import drive_train

    out = drive_train.run(tiny_spec, 2**31 + 19, 0.2, True, "cpu")
    assert out["correct"], out["values"]
    r = out["run"]
    assert 0 < r["trace"]["window_s"] <= r["window_s"] and r["trace"]["busy_s"] >= 0
    device = {"platform": "gpu", "kind": "cpu", "count": 1}
    line = json.loads(json.dumps(run.result_line(tiny_spec, out, device, True)))
    assert line["metrics"]["mfu.train"]["value"] > 0
    assert line["device"]["window_s"] == r["trace"]["window_s"]

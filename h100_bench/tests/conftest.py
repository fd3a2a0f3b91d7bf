"""The benchmark's own tests (`python -m pytest h100_bench/tests -q` from
the repo root; the tier-1 suite under tests/ does not collect them).
Tests marked `card` need a CUDA card and skip inside the test without
one; on a machine with the card: `python -m pytest h100_bench/tests -m card`."""

import copy
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card (skips inside the test without)")


@pytest.fixture
def tiny_spec():
    """Cell 1 at a size the CPU holds: two images on a 128x128 bucket,
    float32 compute (the reference's own precision, so a sound run reads
    round-off alone)."""
    from h100_bench import manifest

    spec = copy.deepcopy(manifest.load_cell("frcnn_r50_mtl_voc0712.train_b16"))
    spec["config"]["compute_dtype"] = "float32"
    spec["traffic"].update(batch_size=2, groups=[{"heights": [100, 128], "widths": [100, 128]}])
    return spec


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")


@pytest.fixture
def tiny_serve_spec():
    """The serve cell at a size the CPU holds: two images a call resized to
    at most 128, float32 compute."""
    from h100_bench import manifest

    spec = copy.deepcopy(manifest.load_cell("frcnn_r50_mtl_voc0712.serve_b8"))
    c = spec["config"]
    c["compute_dtype"] = "float32"
    c["pipeline"] = [line.replace("min_dimension: 600", "min_dimension: 64")
                     .replace("max_dimension: 1024", "max_dimension: 128") for line in c["pipeline"]]
    c["model"]["canvas_size"] = [128, 128]
    c["model"]["image_resizer"] = {"min_dimension": 64, "max_dimension": 128}
    spec["traffic"].update(batch_size=2, pool=2, sizes=[[60, 80], [80, 60]])
    return spec

"""On the card: one short run of each cell, as the benchmark command runs
it, and the control of each cell against its committed limits."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


from h100_bench.drive_train import COMPARED_AT

# long enough that the window's compared step is the one a run compares
SECONDS = 2 * COMPARED_AT


def cells():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_and_is_correct(card, cell):
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload", cell,
                          "--seed", str(2**31 + 5), "--seconds", str(SECONDS), "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"], out.stderr[-3000:]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", cells())
def test_control_fails_the_limits(card, cell):
    """At the cell's own size: a sound run passes the committed
    limits, and the control (control.py's float8 stand-in in the port's
    place, followed as a run follows the port) fails them."""
    from h100_bench import compare, control, manifest

    spec = manifest.load_cell(cell)
    got = {kind: values for kind, values, _ in
           control.readings(spec, 2**31 + 9, SECONDS, "cuda", ["sound", "control"])}
    assert compare.verdict(got["sound"], spec["limits"]), got["sound"]
    assert not compare.verdict(got["control"], spec["limits"]), got["control"]

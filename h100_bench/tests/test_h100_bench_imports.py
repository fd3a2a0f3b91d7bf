"""No process of the benchmark loads JAX or the JAX package, and the
reference loads nothing of the port: each module imported in a fresh
interpreter, top-level names compared whole (`mtlx_torch` is not
`mtlx`)."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "h100_bench")


def modules(sub):
    d = os.path.join(BENCH, sub) if sub else BENCH
    return sorted("h100_bench." + (sub + "." if sub else "") + f[:-3]
                  for f in os.listdir(d) if f.endswith(".py") and f != "__init__.py")


def loaded_after(code: str):
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        cwd=ROOT, capture_output=True, text=True, timeout=600,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"} | {"PYTHONPATH": ROOT})
    assert out.returncode == 0, out.stderr[-2000:]
    return set(out.stdout.split())


def test_harness_loads_no_jax():
    code = "\n".join(f"import {m}" for m in modules("") + modules("metrics"))
    code += "\nimport mtlx_torch.train.train, mtlx_torch.builders.model_builder"
    code += "\nfrom h100_bench import run; run.parse_args(['--workload', 'x', '--seed', '1', '--seconds', '1'])"
    found = loaded_after(code) & {"jax", "jaxlib", "flax", "mtlx"}
    assert not found


def test_reference_loads_nothing_of_the_port():
    code = "\n".join(f"import {m}" for m in modules("reference"))
    found = loaded_after(code) & {"jax", "jaxlib", "flax", "mtlx", "mtlx_torch"}
    assert not found


def test_run_refuses_without_card_or_port(tmp_path):
    """Without a card the run exits non-zero and prints no result; in a
    directory that holds only BENCHMARK.json and h100_bench, likewise."""
    import shutil

    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "h100_bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    out = subprocess.run([sys.executable, "-m", "h100_bench.run", "--workload",
                          "frcnn_r50_mtl_voc0712.train_b16", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=600, env={k: v for k, v in os.environ.items()
                                           if k != "PYTHONPATH"})
    assert out.returncode != 0 and not out.stdout.strip()

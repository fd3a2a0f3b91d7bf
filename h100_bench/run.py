"""Runs one cell of BENCHMARK.json once and prints its result:

    python -m h100_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits non-zero without a result where there
is no CUDA card, fewer cards than the cell asks for, or where a module of
JAX or of the JAX package is loaded once the window has closed. The last
line of standard output is the result (JSON); the numbers compared with
the reference, each beside its limit, are the last lines of standard
error and the result's last key."""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level module names that no process of the benchmark may load
FORBIDDEN = ("jax", "jaxlib", "flax", "mtlx")
# build and kernel caches inside the checkout, at fixed paths
CACHE = os.path.join(ROOT, ".h100_bench_cache")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def card(chips: int):
    """The card's name, count and power limit, or exit without a result."""
    import subprocess

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"h100_bench: the cell needs {chips} CUDA card(s), this machine has {n}",
              file=sys.stderr)
        sys.exit(2)
    try:
        limit = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader",
                                "-i", "0"], capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        limit = "unread"
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit": limit}


def result_line(spec, out, device, trace: bool):
    """The result object: the cell's end-to-end metrics (trace 0) or its
    per-layer metrics (trace 1), the device, the breakdown, the numbers
    compared."""
    if trace:
        metrics = {}
        for m in spec["per_layer"]:
            from h100_bench.manifest import reader

            value = reader(m["name"])(out["run"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        t = out["run"]["trace"]
        device = dict(device, busy_s=t["busy_s"], window_s=t["window_s"])
    else:
        rate = out["run"]["images"] / out["run"]["window_s"]
        readings = {"setup_s": out["setup_s"], "train_img_per_s": rate, "serve_img_per_s": rate,
                    "peak_mem_gib": out["peak_bytes"] / 2**30}
        if "latencies" in out["run"]:
            readings["serve_p95_ms"] = 1e3 * float(np.percentile(out["run"]["latencies"], 95))
        metrics = {m["name"]: {"value": readings[m["name"]], "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    line = {"correct": bool(out["correct"]), "attempted": out["attempted"],
            "failed": out["failed"], "metrics": metrics,
            "device": dict(device, memory_peak_bytes=out["peak_bytes"])}
    if trace:
        line["breakdown"] = {"device_ops": out["run"]["trace"]["device_ops"],
                             "idle_gaps": out["run"]["trace"]["idle_gaps"]}
    line["compared"] = {k: {"value": v, "limit": lim} for k, (v, lim) in out["compared"].items()}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    os.makedirs(CACHE, exist_ok=True)
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from h100_bench import manifest

    import torch

    # the host's share of a step is Python and launches: few threads keep
    # the load of one process steady
    torch.set_num_threads(2)
    spec = manifest.load_cell(args.workload)
    device = card(spec["cell"]["chips"])
    import mtlx_torch  # noqa: F401  (fails in a checkout without the port)
    from h100_bench import compare, drive_serve, drive_train

    drive = {"train": drive_train, "serve": drive_serve}[spec["traffic"]["kind"]]
    out = drive.run(spec, args.seed, args.seconds, bool(args.trace), "cuda", t0=T0)
    found = forbidden_modules()
    if found:
        print(f"h100_bench: modules of JAX or of the JAX package are loaded: {found}",
              file=sys.stderr)
        return 3
    line = result_line(spec, out, device, bool(args.trace))
    values = {k: v for k, (v, _) in out["compared"].items()}
    limits = {k: lim for k, (_, lim) in out["compared"].items()}
    marks = out["run"].get("step_marks") or list(np.cumsum(out["run"]["latencies"]))
    quarter = [round(1000 * float(b - a) / max(1, len(q) - 1), 2) for q in
               (marks[i * len(marks) // 4:(i + 1) * len(marks) // 4 + 1] for i in range(4))
               if len(q) > 1 for a, b in [(q[0], q[-1])]]
    print(f"host ms a step or call by quarter of the window {quarter}; setup_s "
          f"{out['setup_s']:.3f}; reference {out['reference_s']:.3f} s; card {device['kind']}, "
          f"{device['power_limit']}", file=sys.stderr)
    print(f"attempted {out['attempted']} steps, failed {out['failed']}, correct {line['correct']}",
          file=sys.stderr)
    print("worked out " + " ".join(f"{k} {v!r}" for k, v in out["values"].items()),
          file=sys.stderr)
    for text in compare.lines(values, limits):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

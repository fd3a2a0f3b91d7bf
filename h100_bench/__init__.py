"""The H100 benchmark of the PyTorch / CUDA port (`mtlx_torch`).

`python -m h100_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once. A cell names a
configuration (`configs/<name>.json`), a traffic mix (`traffic/<name>.json`)
and its comparison limits (`limits/<cell>.json`); each per-layer metric is
read by `metrics/<name>.py`. See README.md."""

"""mfu.serve: the model operations of the window's served batches
(work.py's count from the configuration's layer shapes and the calls'
bucket) over the window's time, as a share of the card's bf16 dense peak."""

from h100_bench.metrics.mfu_train import read  # noqa: F401  (the same reading)

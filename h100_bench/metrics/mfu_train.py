"""mfu.train: the model operations of the window's train steps (work.py's
count from the configuration's layer shapes and each batch's canvas) over
the window's time, as a share of the card's bf16 dense peak."""

from h100_bench.work import BF16_FLOP_PER_S


def read(run):
    if run.get("steps", 0) < 1 or run["window_s"] <= 0:
        return None
    return 100.0 * run["model_flops"] / run["window_s"] / BF16_FLOP_PER_S

"""roi_crop_backward_roofline: the roi_crop_backward kernel's least time (work.py, from each
recorded call's inputs) over its device time in the traced window."""

from h100_bench.metrics import roofline


def read(run):
    return roofline(run, ["roi_crop_backward"])

"""kernel_roofline.train: the four detection kernels' summed least time
over their summed device time in the traced window."""

from h100_bench.metrics import roofline


def read(run):
    return roofline(run, ["nms", "roi_crop", "roi_crop_backward", "iou"])

"""kernel_roofline.serve: the two NMS calls' and the crop's summed least
time over their summed device time in the traced serving window."""

from h100_bench.metrics import roofline


def read(run):
    return roofline(run, ["nms", "roi_crop"])

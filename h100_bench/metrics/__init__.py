"""One reader a per-layer metric: metrics/<name>.py, the metric's name
with '.' as '_', holds `read(run) -> float | None`. `run` is what
drive_train.run measured in a traced window: steps, images, window_s,
launches (each hand-written kernel's launches in the window), model_flops,
trace (trace.reduce) and bounds (the detection kernels' least seconds, by
kernel). A reader that finds nothing to read returns None, and the
metric is left out of the result."""

# the profiler's names of each detection kernel's device functions
KERNEL_FUNCTIONS = {
    "nms": ["nms_small_kernel", "order_kernel", "rank_kernel", "mask_kernel", "scan_kernel"],
    "roi_crop": ["roi_crop_fwd_kernel"],
    "roi_crop_backward": ["roi_crop_bwd_kernel"],
    "iou": ["iou_kernel"],
}


def roofline(run, kernels) -> "float | None":
    """The kernels' summed least time over their summed device time, in
    percent; None without a trace or a device time to read."""
    from h100_bench.trace import device_seconds

    if "trace" not in run:
        return None
    names = [f for k in kernels for f in KERNEL_FUNCTIONS[k]]
    device = device_seconds(run["trace"]["device_s_by_name"], names)
    bound = sum(run["bounds"].get(k, 0.0) for k in kernels)
    if device <= 0 or bound <= 0:
        return None
    return 100.0 * bound / device

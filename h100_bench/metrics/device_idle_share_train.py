"""device_idle_share.train: the share of the traced window in which no
operation ran on the card (one minus the union of the device's busy
intervals, by the profiler)."""


def read(run):
    t = run.get("trace")
    if not t or t["busy_s"] <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - t["busy_s"] / t["window_s"])

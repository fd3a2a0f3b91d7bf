"""device_idle_share.serve: the share of the traced serving window in
which no operation ran on the card (one minus the union of the device's
busy intervals, by the profiler)."""

from h100_bench.metrics.device_idle_share_train import read  # noqa: F401

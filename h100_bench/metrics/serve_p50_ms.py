"""serve_p50_ms: the median call latency in the traced window, from the
call until the host has the detections (host clock), beside the tail."""

import numpy as np


def read(run):
    lat = run.get("latencies")
    if not lat:
        return None
    return 1e3 * float(np.median(lat))

"""Reduces a torch.profiler trace, in memory, to what the per-layer
metrics read: the union of the device's busy intervals over the traced
window, the device time by operation name, and the longest idle gaps
named by the innermost host operation open across each gap's middle."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np


def _events(prof):
    """[(is_device, name, start_us, end_us)] of the trace."""
    out = []
    try:
        for e in prof.profiler.kineto_results.events():
            on_device = "cuda" in str(e.device_type()).lower()
            start = e.start_ns() / 1e3
            out.append((on_device, e.name(), start, start + e.duration_ns() / 1e3))
        return out
    except (AttributeError, RuntimeError):
        pass
    for e in prof.events():
        on_device = "cuda" in str(e.device_type).lower()
        out.append((on_device, e.name, e.time_range.start, e.time_range.end))
    return out


def reduce(prof, window_s: float) -> Dict:
    """{'busy_s', 'window_s', 'device_ops' [(name, s)] (largest 10),
    'idle_gaps' [(host op, s)] (largest 10), 'device_s_by_name'}."""
    events = _events(prof)
    dev = sorted((s, e, n) for d, n, s, e in events if d and e > s)
    by_name: Dict[str, float] = {}
    for s, e, n in dev:
        by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
    busy, gaps = 0.0, []
    if dev:
        cur_s, cur_e = dev[0][0], dev[0][1]
        for s, e, _ in dev[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    host = [(s, e, n) for d, n, s, e in events if not d and e > s]
    starts = np.array([h[0] for h in host]) if host else np.zeros(0)
    ends = np.array([h[1] for h in host]) if host else np.zeros(0)
    named: Dict[str, float] = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = 0.5 * (g0 + g1)
        open_ = np.nonzero((starts <= mid) & (ends >= mid))[0]
        name = "no host op" if not len(open_) else host[
            open_[np.argmin(ends[open_] - starts[open_])]][2]
        named[name] = named.get(name, 0.0) + (g1 - g0) / 1e6
    top = lambda d: sorted(([k[:120], v] for k, v in d.items()), key=lambda kv: -kv[1])[:10]
    return {"busy_s": busy / 1e6, "window_s": window_s, "device_ops": top(by_name),
            "idle_gaps": top(named), "device_s_by_name": by_name}


def device_seconds(by_name: Dict[str, float], patterns: List[str]) -> float:
    """Device seconds of the operations whose name holds one of `patterns`
    as a word (also inside a mangled name: after a length, before `I`)."""
    import re

    rx = re.compile(r"(^|[^A-Za-z_])(" + "|".join(patterns) + r")($|[^a-z0-9_])")
    return sum(v for k, v in by_name.items() if rx.search(k))

"""Spans around each call into a layer, and the reading of the device
trace.

With ``--trace 1`` a ``torch.profiler`` window is started first in the
process (the profiler has been seen to drop device events when started
late in a long process) and stopped when the measured window closes.
Each call into a layer is a ``record_function`` range named
``bench.<layer>`` on the host; the whole window is ``bench.window``.
Nothing else runs in the window: the requests' least times are worked
out after it closes.

From the exported trace, inside ``bench.window``:

- the device's busy time is the union of its kernels, copies and fills;
- a layer's device time is the union of the device operations that the
  host launched inside its ``bench.<layer>`` range (the launch found by
  the operation's correlation id), so the host's launch gaps between
  them are not counted;
- an idle gap is named by the innermost ``bench.*`` range the host was
  in at the gap's middle (``host`` outside any).
"""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import shutil
import tempfile
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
TOP = 10


class Spans:
    """``bench.<layer>`` ranges around the calls into each layer (off: none)."""

    def __init__(self, on: bool):
        self.on = on
        self.calls = defaultdict(int)

    @contextlib.contextmanager
    def layer(self, name: str):
        if not self.on:
            yield
            return
        import torch

        with torch.profiler.record_function(f"bench.{name}"):
            yield
        self.calls[name] += 1


def start_profiler():
    import torch

    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
    )
    prof.start()
    return prof


def stop_and_read(prof) -> dict:
    """Stop the profiler and reduce its trace (``summarise``)."""
    prof.stop()
    tmp = tempfile.mkdtemp(prefix="bench-trace-")
    try:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as fh:
            events = json.load(fh).get("traceEvents", [])
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return summarise(events)


def _merge(intervals):
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."


class _Ranges:
    """The host's ``bench.*`` ranges, for the innermost one open at a time."""

    def __init__(self, events: list):
        # by start, and of two that start together the outer first
        self.host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith("bench.") and e["name"] != "bench.window"),
            key=lambda h: (h[0], -h[1]),
        )
        self.starts = [h[0] for h in self.host]

    def at(self, t: float, outside: str = "host") -> str:
        # the ranges nest, so the latest-starting one still open is the
        # innermost; its earlier siblings are few
        last = bisect.bisect_right(self.starts, t) - 1
        for j in range(last, max(-1, last - 16), -1):
            if self.host[j][1] >= t:
                return self.host[j][2]
        return outside


def summarise(events: list) -> dict:
    """``window_s``, ``busy_s``, each layer's device seconds, the top
    device operations by time and the idle gaps by host activity, inside
    ``bench.window``."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == "bench.window"
              and e.get("cat") != "gpu_user_annotation"]
    if not window:
        return {"window_s": 0.0, "busy_s": 0.0, "layers_s": {}, "device_ops": [], "idle_gaps": [],
                "device_events": 0, "unattributed": 0}
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    ranges = _Ranges(events)
    launched = {}  # correlation id -> the host time of the launch
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    dev, by_name, by_layer = [], defaultdict(float), defaultdict(list)
    unattributed = 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        dev.append((s, t))
        by_name[_short(e.get("name", "?"))] += (t - s) * 1e-6
        at = launched.get((e.get("args") or {}).get("correlation"))
        if at is None:
            unattributed += 1
            continue
        by_layer[ranges.at(at).removeprefix("bench.")].append((s, t))
    merged = _merge(dev)
    busy = sum(t - s for s, t in merged) * 1e-6
    layers_s = {name: sum(t - s for s, t in _merge(iv)) * 1e-6 for name, iv in by_layer.items()}
    gaps = defaultdict(float)
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for i in range(0, len(edges), 2):
        s, t = edges[i], edges[i + 1]
        if t > s:
            gaps[ranges.at((s + t) / 2)] += (t - s) * 1e-6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy, "layers_s": layers_s,
            "device_ops": top(by_name), "idle_gaps": top(gaps), "device_events": len(dev),
            "unattributed": unattributed}

"""The port's own spans in the device trace, and a traced run that reads
them.

While a profiler records, the port opens ``awfm.*`` ranges on its device
path (``avxwindowfmindex_tpu_torch/utils/metrics.span``): ``awfm.ranges``
around ``search_ranges`` / ``ngram_ranges``, ``awfm.counts`` around
``range_counts``, ``awfm.locate`` around ``locate_flat_device`` and, in
it, ``awfm.enumerate`` and ``awfm.backtrace``, and
``awfm.launch.<kernel>`` around the C call of each kernel launch.
:func:`summarise` reads them inside ``bench.window`` by the rules of
``trace.py``: a device operation belongs to the host time of its launch
(found by the correlation id), and a time is a union of intervals.

    python3 -m benchmark.harness.port_trace --workload <cell> --seed <n> --seconds <s>

is a ``--trace 1`` run of ``run.py`` that reads the spans too: the
result line gains the per-layer metrics of ``METRICS`` that the cell
reports, and ``breakdown["port_gaps"]``. ``run.py`` itself reads no
``awfm.*`` span, and ``BENCHMARK.json`` lists none of ``METRICS``.
"""

from __future__ import annotations

import bisect
import json
import sys
import time
from collections import defaultdict

from . import trace

PREFIX = "awfm."
LOCATE_CELLS = ["nt-chr1.locate25", "aa-sprot.peptides", "nt-chr1.locate11"]
# the per-layer metrics that read the spans, as BENCHMARK.json's entries
METRICS = [
    {"name": "k3_roofline.locate", "unit": "%", "better": "higher", "source": "program_span",
     "layer": "hits", "moves": "locate_qps", "workloads": LOCATE_CELLS},
    {"name": "enumerate_ms.locate", "unit": "ms", "better": "lower", "source": "program_span",
     "layer": "hits", "moves": "locate_qps", "workloads": LOCATE_CELLS},
    {"name": "port_idle.locate", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "device", "moves": "locate_qps", "workloads": LOCATE_CELLS},
    {"name": "port_idle.count", "unit": "%", "better": "lower", "source": "program_span",
     "layer": "device", "moves": "count_qps", "workloads": ["nt-chr1.count25"]},
]


class _Nest:
    """The host's ``awfm.*`` ranges and how they nest, for the ranges
    open at a time."""

    def __init__(self, events: list):
        # by start, and of two that start together the outer first
        self.host = sorted(
            ((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e["name"])
             for e in events
             if e.get("ph") == "X" and e.get("cat") == "user_annotation"
             and str(e.get("name", "")).startswith(PREFIX)),
            key=lambda h: (h[0], -h[1]),
        )
        self.starts = [h[0] for h in self.host]
        self.parent, stack = [], []
        for i, (s, _, _) in enumerate(self.host):
            while stack and self.host[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def open_at(self, t: float) -> list:
        """The indices of the ranges open at ``t``, innermost first: the
        latest-starting range before ``t`` or, where it has closed, its
        nearest enclosing range still open, and those around it."""
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.host[j][1] < t:
            j = self.parent[j]
        chain = []
        while j >= 0:
            chain.append(j)
            j = self.parent[j]
        return chain


def summarise(events: list) -> dict:
    """``spans`` (each ``awfm.*`` name: the ``calls`` opened in the window,
    the union of the device operations launched inside one of them,
    nested ranges included, in ``device_s``, and those operations'
    count, ``ops``), ``idle_s`` (the device's idle time intersected with
    the host's ``awfm.*`` ranges) and ``gaps`` (that time by the
    innermost range, the largest ``trace.TOP``), inside ``bench.window``."""
    window = [e for e in events if e.get("ph") == "X" and e.get("name") == "bench.window"
              and e.get("cat") != "gpu_user_annotation"]
    if not window:
        return {"spans": {}, "idle_s": 0.0, "gaps": []}
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    nest = _Nest(events)
    launched = {}  # correlation id -> the host time of the launch
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in trace.LAUNCH_CATS:
            corr = (e.get("args") or {}).get("correlation")
            if corr is not None:
                launched[corr] = float(e["ts"])
    calls, ops, inside = defaultdict(int), defaultdict(int), defaultdict(list)
    for s, _, name in nest.host:
        if w0 <= s <= w1:
            calls[name] += 1
    dev = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in trace.DEVICE_CATS:
            continue
        s = max(float(e["ts"]), w0)
        t = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
        if t <= s:
            continue
        dev.append((s, t))
        at = launched.get((e.get("args") or {}).get("correlation"))
        if at is None:
            continue
        for name in {nest.host[j][2] for j in nest.open_at(at)}:
            inside[name].append((s, t))
            ops[name] += 1
    # the idle time, cut at every range's start and end: each piece lies
    # in one innermost range or in none
    cuts = sorted({x for s, t, _ in nest.host for x in (s, t) if w0 < x < w1})
    edges = [w0] + [x for iv in trace._merge(dev) for x in iv] + [w1]
    gaps = defaultdict(float)
    for i in range(0, len(edges), 2):
        a, b = edges[i], edges[i + 1]
        lo, hi = bisect.bisect_right(cuts, a), bisect.bisect_left(cuts, b)
        points = [a] + cuts[lo:hi] + [b]
        for x, y in zip(points, points[1:]):
            chain = nest.open_at((x + y) / 2) if y > x else []
            if chain:
                gaps[nest.host[chain[0]][2]] += (y - x) * 1e-6
    spans = {name: {"calls": calls[name], "ops": ops[name],
                    "device_s": sum(t - s for s, t in trace._merge(inside[name])) * 1e-6}
             for name in sorted(set(calls) | set(inside))}
    top = [[k, v] for k, v in sorted(gaps.items(), key=lambda kv: -kv[1])[:trace.TOP]]
    return {"spans": spans, "idle_s": sum(gaps.values()), "gaps": top}


def run_traced(m: dict, cell_name: str, seed: int, seconds: float, *, device, t0: float, prof,
               control=None, **paths):
    """``main.run_cell`` traced, with the trace's summary holding
    :func:`summarise`'s under ``port`` and the cell's ``METRICS`` read:
    (result with ``breakdown["port_gaps"]``, checks, the port's summary)."""
    from . import main

    names = {p["name"] for p in m["per_layer"]}
    m = dict(m, per_layer=m["per_layer"] + [p for p in METRICS if p["name"] not in names])
    port = {}
    read = trace.summarise

    def both(events):
        port.update(summarise(events))
        return dict(read(events), port=port)

    trace.summarise = both
    try:
        result, checks = main.run_cell(m, cell_name, seed, seconds, True, device=device, t0=t0,
                                       prof=prof, control=control, **paths)
    finally:
        trace.summarise = read
    result.setdefault("breakdown", {})["port_gaps"] = port.get("gaps", [])
    return result, checks, port


def run(argv, t0: float) -> int:
    from . import main, manifest

    args = main.parse_args(argv)
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"[bench] refused: cell {args.workload} needs {cell['chips']} CUDA card(s)",
              file=sys.stderr, flush=True)
        return 2
    prof = trace.start_profiler()
    result, checks, port = run_traced(m, args.workload, args.seed, args.seconds,
                                      device=torch.device("cuda:0"), t0=t0, prof=prof,
                                      control=args.control)
    main._log(f"port spans: {json.dumps(port.get('spans', {}))}; device idle in them "
              f"{port.get('idle_s', 0.0):.6f}s")
    return main.finish(result, checks)


if __name__ == "__main__":
    sys.exit(run(sys.argv[1:], time.perf_counter()))

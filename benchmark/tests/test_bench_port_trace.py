"""The reading of the port's ``awfm.*`` spans (``harness/port_trace.py``):
a span's device time is the union of the operations launched anywhere
inside it, nested spans included; the port's idle time is the device's
idle time intersected with the spans, split by the innermost one; the
harness's own reading is the same with the spans in the trace; and each
reader of a span reads nothing where the span is absent."""

import os
import time
import types

import pytest
import torch

from benchmark.harness import manifest, port_trace, trace
from benchmark.tests.helpers import run_tiny
from benchmark.tests.test_bench_trace import EVENTS, _host

# EVENTS (test_bench_trace.py): window 100-200; launches 1 at 102, 2 at 105
# (device 103-108, 106-120), 3 at 131 (145-160), 4 at 135 (160-170), 5 at
# 141 (170-180); the device idle over 120-145, 180-190 and 195-200. The
# order of the two spans in awfm.locate does not matter to the reading.
PORT_EVENTS = EVENTS + [
    _host("awfm.ranges", 60, 10),  # before the window: not a call of it
    _host("awfm.ranges", 101, 8),
    _host("awfm.launch.k4_ngram_ranges", 101.5, 1),  # launch 1 alone
    _host("awfm.counts", 118, 7),  # idle over 120-125
    _host("awfm.locate", 130, 8),
    _host("awfm.backtrace", 130.5, 1.5),
    _host("awfm.launch.k3_backtrace_resolve", 130.8, 0.7),  # launch 3
    _host("awfm.enumerate", 134, 3),  # launch 4
]


def test_the_harness_reads_the_same_with_the_spans_in_the_trace():
    assert trace.summarise(PORT_EVENTS) == trace.summarise(EVENTS)


def test_a_span_holds_what_was_launched_inside_it_nested_spans_included():
    spans = port_trace.summarise(PORT_EVENTS)["spans"]
    want = {  # calls, operations, device seconds
        "awfm.ranges": (1, 2, 17e-6),  # 103-120, counted once
        "awfm.launch.k4_ngram_ranges": (1, 1, 5e-6),
        "awfm.counts": (1, 0, 0.0),
        "awfm.locate": (1, 2, 25e-6),  # 145-170 through its two inner spans
        "awfm.backtrace": (1, 1, 15e-6),
        "awfm.launch.k3_backtrace_resolve": (1, 1, 15e-6),
        "awfm.enumerate": (1, 1, 10e-6),
    }
    assert {n: (s["calls"], s["ops"]) for n, s in spans.items()} == {
        n: w[:2] for n, w in want.items()}
    assert {n: s["device_s"] for n, s in spans.items()} == pytest.approx(
        {n: w[2] for n, w in want.items()})


def test_the_port_idle_time_is_idle_within_spans_by_the_innermost():
    s = port_trace.summarise(PORT_EVENTS)
    # idle 120-145 meets counts 118-125 and locate 130-138; 180-200 meets none
    assert s["idle_s"] == pytest.approx(13e-6)
    assert dict(s["gaps"]) == pytest.approx({
        "awfm.counts": 5e-6,
        "awfm.locate": 3.5e-6,  # 130-130.5, 132-134, 137-138
        "awfm.enumerate": 3e-6,
        "awfm.backtrace": 0.8e-6,  # 130.5-130.8, 131.5-132
        "awfm.launch.k3_backtrace_resolve": 0.7e-6,
    })
    whole = trace.summarise(PORT_EVENTS)
    assert s["idle_s"] <= whole["window_s"] - whole["busy_s"]


def test_a_trace_without_a_window_or_spans_reads_nothing():
    s = port_trace.summarise([e for e in PORT_EVENTS if e["name"] != "bench.window"])
    assert s == {"spans": {}, "idle_s": 0.0, "gaps": []}
    s = port_trace.summarise(EVENTS)
    assert s == {"spans": {}, "idle_s": 0.0, "gaps": []}


def _ctx(events, hits_least_ms=0.5):
    summary = trace.summarise(events)
    summary["port"] = port_trace.summarise(events)
    layers = {"hits": {"device_ms": 1e3 * summary["layers_s"].get("hits", 0.0),
                       "least_ms": hits_least_ms, "bound_by": {}}}
    return types.SimpleNamespace(layers=layers, trace=summary)


def _read(name, ctx):
    return manifest.load_reader(name)(ctx)


def test_each_reader_reads_its_span():
    ctx = _ctx(PORT_EVENTS, hits_least_ms=0.003)
    assert _read("k3_roofline.locate", ctx) == pytest.approx(100 * 0.003 / 0.015)
    assert _read("enumerate_ms.locate", ctx) == pytest.approx(0.010)
    assert _read("port_idle.locate", ctx) == pytest.approx(13.0)
    assert _read("port_idle.count", ctx) <= _read("device_idle.count", ctx)


@pytest.mark.parametrize("name", ["k3_roofline.locate", "enumerate_ms.locate",
                                  "port_idle.locate", "port_idle.count"])
def test_a_reader_reads_nothing_without_its_span(name):
    no_port = _ctx(EVENTS)  # a program without the spans
    assert _read(name, no_port) is None
    del no_port.trace["port"]  # a harness that does not read them
    assert _read(name, no_port) is None
    assert _read(name, types.SimpleNamespace(layers={}, trace=None)) is None
    no_window = _ctx([e for e in PORT_EVENTS if e["name"] != "bench.window"])
    assert _read(name, no_window) is None


def test_every_proposed_metric_has_a_reader_and_no_entry_yet():
    m = manifest.load()
    assert not {p["name"] for p in port_trace.METRICS} & {p["name"] for p in m["per_layer"]}
    for p in port_trace.METRICS:
        assert manifest.reader_path(p["name"]) is not None
        assert set(p["workloads"]) <= {c["name"] for c in m["workloads"]}
    assert not manifest.validate(dict(m, per_layer=m["per_layer"] + port_trace.METRICS))


def test_a_traced_run_through_the_spans_is_correct_on_the_cpu(tiny):
    m, root = tiny
    read = trace.summarise
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    res, checks, port = port_trace.run_traced(
        m, "nt-tiny.l10", 2**31 + 11, 0.05, device=torch.device("cpu"), t0=time.perf_counter(),
        prof=prof, root=root, bench=os.path.join(root, "benchmark"),
        cache_root=os.path.join(root, "cache-cpu"))
    assert all(v <= lim for _, v, lim in checks), checks
    # every request opened its spans; on the CPU nothing ran on a device
    requests = res["attempted"]
    calls = {name: s["calls"] for name, s in port["spans"].items()}
    assert calls == {"awfm.ranges": requests, "awfm.counts": 2 * requests,
                     "awfm.locate": requests, "awfm.enumerate": requests,
                     "awfm.backtrace": requests}
    assert all(s["device_s"] == 0 for s in port["spans"].values())
    assert res["metrics"] == {} and "port_gaps" in res["breakdown"]
    assert trace.summarise is read
    # the tiny run without the spans read answers the same
    plain, _ = run_tiny(tiny, "nt-tiny.l10")
    assert plain["correct"]


@pytest.mark.card
def test_on_a_card_a_traced_tiny_run_reads_every_span_metric(tiny, cuda_device):
    m, root = tiny
    m = dict(m, per_layer=m["per_layer"] + [dict(p, workloads=["nt-tiny.l10"])
                                           for p in port_trace.METRICS if "locate" in p["name"]])
    res, checks, port = port_trace.run_traced(
        m, "nt-tiny.l10", 2**31 + 11, 0.5, device=torch.device(cuda_device),
        t0=time.perf_counter(), prof=trace.start_profiler(), root=root,
        bench=os.path.join(root, "benchmark"), cache_root=os.path.join(root, "cache-cuda0"))
    assert all(v <= lim for _, v, lim in checks), checks
    for name in ("k3_roofline.locate", "enumerate_ms.locate", "port_idle.locate"):
        assert res["metrics"][name]["value"] > 0, name
    value = {name: v["value"] for name, v in res["metrics"].items()}
    assert value["port_idle.locate"] <= value["device_idle.locate"]
    assert port["spans"]["awfm.launch.k3_backtrace_resolve"]["ops"] >= res["attempted"]

"""The reading of the device trace: a layer's device time is the union of
the operations launched inside its range, idle time is named by the host's
range, and nothing outside ``bench.window`` counts."""

import pytest

from benchmark.harness import trace


def _host(name, ts, dur):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}


def _launch(corr, ts):
    return {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 1,
            "args": {"correlation": corr}}


def _device(name, ts, dur, corr=None, cat="kernel"):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


EVENTS = [
    _host("bench.window", 100, 100),
    _host("bench.request", 100, 100),
    _host("bench.ranges", 100, 10), _launch(1, 102), _launch(2, 105),
    _host("bench.hits", 130, 10), _launch(3, 131), _launch(4, 135),
    _host("bench.readback", 140, 60), _launch(5, 141),
    _device("k4", 103, 5, 1), _device("k4b", 106, 14, 2),  # overlapping: counted once
    _device("k3", 145, 15, 3), _device("enum", 160, 10, 4),  # run while the host reads back
    _device("Memcpy DtoH", 170, 10, 5, cat="gpu_memcpy"),
    _device("orphan", 190, 5),  # no launch found
    _device("warm-up", 50, 60, None),  # starts before the window: only its part inside counts
]


def test_layers_are_the_union_of_what_they_launched():
    s = trace.summarise(EVENTS)
    assert s["window_s"] == pytest.approx(100e-6)
    assert s["layers_s"] == pytest.approx({"ranges": 17e-6, "hits": 25e-6, "readback": 10e-6})
    assert s["unattributed"] == 2
    # busy: 100-120 (warm-up tail and both K4s), 145-180, 190-195
    assert s["busy_s"] == pytest.approx(60e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps == pytest.approx({"bench.hits": 25e-6, "bench.readback": 15e-6})
    assert dict(s["device_ops"])["warm-up"] == pytest.approx(10e-6)


def test_a_trace_without_a_window_reads_nothing():
    s = trace.summarise([e for e in EVENTS if e["name"] != "bench.window"])
    assert s["busy_s"] == 0 and s["layers_s"] == {} and s["device_events"] == 0

"""Lightweight operational metrics: a process-local registry of counters
and timers, and named spans on the device path.

Copied from ``avxwindowfmindex_tpu/utils/metrics.py``. Counters and
timers are updated from the host-driven layers only (the engine entry
points). The differences: the JAX package reads ``AWFM_METRICS`` from the
environment on every update, here the switch is :func:`set_enabled`; and
the port's device counters (:func:`device_counts`), which a kernel adds
to on the card while a profiler records and :func:`snapshot` reads.

Spans (:func:`span`) are the port's own: ``torch.profiler`` ranges named
``awfm.<name>`` around the batched search functions of the device path
and around each kernel's launch (``awfm.launch.<kernel>``). They exist
only while a profiler records in the process (``torch.profiler.profile``,
or ``torch.autograd.profiler.emit_nvtx()`` for Nsight Systems) and the
registry is on; then they sit on the profiler's clock, and the device
operations launched inside one are found through their correlation ids.
Otherwise a span costs a flag check and builds nothing.

Usage:
    from avxwindowfmindex_tpu_torch.utils import metrics
    metrics.counter("search.queries").add(1024)
    with metrics.timer("search.count_seconds"):
        ...
    with metrics.span("ranges"):  # "awfm.ranges" under a profiler
        ...
    metrics.snapshot()  # -> {"search.queries": 1024, ...} (and the device counters)
    metrics.set_enabled(False)  # every update becomes a no-op, every span null
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager, nullcontext
from typing import Dict, Optional, Tuple

import torch

try:
    from torch._C._autograd import _profiler_enabled as _profiling
except ImportError:  # a torch without the flag: every span is entered
    def _profiling() -> bool:
        return True


_lock = threading.Lock()
_counters: Dict[str, float] = {}
_device: Dict[tuple, torch.Tensor] = {}  # (names, device) -> its int64 counts there
_on = True
_NULL = nullcontext()


def set_enabled(enabled: bool) -> None:
    """Turn every counter and timer update, and every span, on or off
    (default on)."""
    global _on
    _on = bool(enabled)


class _Counter:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def add(self, value: float = 1) -> None:
        if not _on:
            return
        with _lock:
            _counters[self.name] = _counters.get(self.name, 0) + value

    inc = add


def counter(name: str) -> _Counter:
    return _Counter(name)


@contextmanager
def timer(name: str):
    """Accumulates elapsed wall seconds under ``name`` and counts calls
    under ``name + ".calls"``."""
    if not _on:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _lock:
            _counters[name] = _counters.get(name, 0) + dt
            _counters[name + ".calls"] = _counters.get(name + ".calls", 0) + 1


def span(name: str):
    """A ``torch.profiler.record_function`` range ``awfm.<name>`` while a
    profiler records in the process and the registry is on; else one
    shared null context, with no range made and no name formatted (a
    ``record_function`` entered with no profiler still costs some 10 µs)."""
    if _on and _profiling():
        return torch.profiler.record_function(f"awfm.{name}")
    return _NULL


def device_counts(names: Tuple[str, ...], device) -> Optional[torch.Tensor]:
    """The (len(names),) int64 tensor on ``device`` that a kernel adds the
    counts ``names`` to, made zero at first use, while a profiler records
    in the process and the registry is on, as :func:`span` is gated; else
    None, and the kernel is handed a null pointer. :func:`snapshot` reads
    it, with one sync."""
    if not (_on and _profiling()):
        return None
    with _lock:
        counts = _device.get((names, device))
        if counts is None:
            counts = _device[(names, device)] = torch.zeros(len(names), dtype=torch.int64,
                                                            device=device)
    return counts


def snapshot() -> Dict[str, float]:
    """Point-in-time copy of every metric; the device counters summed over
    their devices, each tensor read back once (a sync: never call it
    inside a request)."""
    with _lock:
        out = dict(_counters)
        device = list(_device.items())
    for (names, _), counts in device:
        for name, value in zip(names, counts.tolist()):
            out[name] = out.get(name, 0) + value
    return out


def reset() -> None:
    with _lock:
        _counters.clear()
        _device.clear()

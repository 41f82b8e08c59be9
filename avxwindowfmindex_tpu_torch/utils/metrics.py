"""Lightweight operational metrics: a process-local registry of counters
and timers.

Copied from ``avxwindowfmindex_tpu/utils/metrics.py``. It is updated from
the host-driven layers only (the engine entry points), never inside a
kernel, so the device path is untouched. The one difference: the JAX
package reads ``AWFM_METRICS`` from the environment on every update;
here the switch is :func:`set_enabled`.

Usage:
    from avxwindowfmindex_tpu_torch.utils import metrics
    metrics.counter("search.queries").add(1024)
    with metrics.timer("search.count_seconds"):
        ...
    metrics.snapshot()  # -> {"search.queries": 1024, ...}
    metrics.set_enabled(False)  # every update becomes a no-op
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict


_lock = threading.Lock()
_counters: Dict[str, float] = {}
_on = True


def set_enabled(enabled: bool) -> None:
    """Turn every counter and timer update on or off (default on)."""
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


def snapshot() -> Dict[str, float]:
    """Point-in-time copy of every metric."""
    with _lock:
        return dict(_counters)


def reset() -> None:
    with _lock:
        _counters.clear()

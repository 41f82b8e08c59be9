"""Batch search API — the awFmParallelSearch* surface.

Counterpart of ``avxwindowfmindex_tpu/parallel/api.py``. The reference's
throughput API is an OpenMP parallel-for over 8-kmer chunks with
lock-step query interleaving (AwFmParallelSearch.c:95-220). Here the
whole batch is one engine call on ``device`` (K2, then enumerate and K3
for locate, on the card); ``num_threads`` is accepted for signature
parity and ignored.

A :class:`KmerSearchList` mirrors struct AwFmKmerSearchList
(AwFmIndex.h:111-123) for callers porting from the C API; the
list-in/list-out functions are the idiomatic surface.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.index import FmIndex, resolve_device
from ..search import SearchEngine

# engines keyed by (index identity, device), LRU-bounded: an engine holds
# a strong reference to its index (engine.host_index) and its device
# tables, so an unbounded cache would pin every index's host arrays and
# device memory for the life of the process
_ENGINE_CACHE: "OrderedDict[Tuple[int, torch.device], SearchEngine]" = OrderedDict()
_ENGINE_CACHE_MAX = 4


def _engine_for(index: FmIndex, device=None) -> SearchEngine:
    device = resolve_device(device)
    key = (id(index), device)
    eng = _ENGINE_CACHE.get(key)
    # to_device's view at its default width and in the installed layout
    view = index.to_device(device)
    # host_index identity guards against id() reuse after an evicted index
    # was garbage collected; the view check guards against a view
    # replaced since the engine was built (an index holds one cached
    # view: attach_seed_table, densify_device_sa or a view on another
    # device replace it)
    if eng is None or eng.host_index is not index or eng.dev is not view:
        eng = SearchEngine(index, device=device)
        _ENGINE_CACHE[key] = eng
    _ENGINE_CACHE.move_to_end(key)
    while len(_ENGINE_CACHE) > _ENGINE_CACHE_MAX:
        _ENGINE_CACHE.popitem(last=False)
    return eng


def parallel_search_count(index: FmIndex, kmers: Sequence[Union[str, bytes]],
                          num_threads: int = 0, *, device=None) -> np.ndarray:
    """Count occurrences of each kmer (awFmParallelSearchCount,
    AwFmParallelSearch.c:159-220). ``device=None`` means the card."""
    del num_threads  # one batched engine call; kept for API parity
    if not len(kmers):
        # the reference's loop over 0 entries is a no-op, not an error
        return np.empty(0, dtype=np.uint64)
    return _engine_for(index, device).count(kmers)


def parallel_search_locate(index: FmIndex, kmers: Sequence[Union[str, bytes]],
                           num_threads: int = 0, *, device=None) -> List[np.ndarray]:
    """Locate every occurrence of each kmer (awFmParallelSearchLocate,
    AwFmParallelSearch.c:95-157). Returns one position array per kmer,
    ordered like the reference's positionList."""
    del num_threads
    if not len(kmers):
        return []
    return _engine_for(index, device).locate(kmers)


# ---------------------------------------------------------------------------
# struct-style compatibility shim
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class KmerSearchData:
    """Mirror of struct AwFmKmerSearchData (AwFmIndex.h:111-117)."""

    kmer_string: Union[str, bytes] = ""
    kmer_length: int = 0
    position_list: Optional[np.ndarray] = None
    count: int = 0

    @property
    def capacity(self) -> int:
        return 0 if self.position_list is None else len(self.position_list)


class KmerSearchList:
    """Mirror of struct AwFmKmerSearchList (AwFmIndex.h:119-123).

    Usage parity with awFmCreateKmerSearchList: allocate with a capacity,
    fill ``kmer_search_data[i].kmer_string`` and set ``count``, then call
    :meth:`search_locate` / :meth:`search_count`.
    """

    def __init__(self, capacity: int):
        self.capacity = capacity
        self.count = 0
        self.kmer_search_data = [KmerSearchData() for _ in range(capacity)]

    def set_kmers(self, kmers: Sequence[Union[str, bytes]]):
        if len(kmers) > self.capacity:
            raise ValueError("more kmers than list capacity")
        self.count = len(kmers)
        for i, kmer in enumerate(kmers):
            data = self.kmer_search_data[i]
            data.kmer_string = kmer
            data.kmer_length = len(kmer)

    def _active_kmers(self):
        return [d.kmer_string for d in self.kmer_search_data[: self.count]]

    def search_count(self, index: FmIndex, num_threads: int = 0, *, device=None) -> None:
        counts = parallel_search_count(index, self._active_kmers(), num_threads, device=device)
        for i in range(self.count):
            self.kmer_search_data[i].count = int(counts[i])

    def search_locate(self, index: FmIndex, num_threads: int = 0, *, device=None) -> None:
        hits = parallel_search_locate(index, self._active_kmers(), num_threads, device=device)
        for i in range(self.count):
            self.kmer_search_data[i].position_list = hits[i]
            self.kmer_search_data[i].count = len(hits[i])


def create_kmer_search_list(capacity: int) -> KmerSearchList:
    """awFmCreateKmerSearchList parity (AwFmParallelSearch.c:36-84)."""
    return KmerSearchList(capacity)

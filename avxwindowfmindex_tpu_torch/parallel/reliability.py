"""Failure handling: deterministic retry of query shards + index reload.

Counterpart of ``avxwindowfmindex_tpu/parallel/reliability.py``. The
reference's failure story is a return-code enum and an OpenMP atomic
aggregate (AwFmIndex.h:132-138, AwFmParallelSearch.c:125-128): on any
worker's disk-read failure the whole batch aborts. Search is a pure
function of (index, queries), so a failed shard can be run again —
optionally after reloading the index from its backing file — with
bit-identical results.

On the card a CUDA error surfaces from the kernel launchers as a
``RuntimeError`` (``ops/kernels.py:_check``), which is retried; a tensor
on the wrong device or of the wrong dtype raises ``ValueError`` /
``TypeError`` there, which fail fast. A retry runs the same engine kind
on the same device again: never a plain version, never the CPU.
"""

from __future__ import annotations

import functools
import logging
import time
from typing import Callable, List, Optional, Sequence, Union

import numpy as np

from ..models.index import FmIndex, resolve_device
from ..search import SearchEngine

logger = logging.getLogger("avxwindowfmindex_tpu_torch.reliability")


#: Exception classes that indicate a deterministic caller error — a bad
#: kmer, a wrong type, a misuse of the API. Retrying these is pure waste
#: (and the backoff + index reload makes a bad input slow), so they fail
#: fast. This mirrors the reference's split between fatal codes and the
#: retry-worthy AwFmFileReadFail (AwFmParallelSearch.c:356-359): only
#: environmental faults (I/O, device/runtime) are retried.
NON_RETRYABLE = (ValueError, TypeError, KeyError, IndexError, AssertionError,
                 NotImplementedError)


def is_retryable(err: BaseException) -> bool:
    """True for environmental faults worth retrying (OSError, RuntimeError
    such as a CUDA error); False for deterministic input/usage errors."""
    if isinstance(err, NON_RETRYABLE):
        return False
    return isinstance(err, Exception)


class RetryPolicy:
    def __init__(
        self,
        max_attempts: int = 3,
        backoff_seconds: float = 0.5,
        reload_index_on_failure: bool = True,
        retryable: Callable[[BaseException], bool] = is_retryable,
    ):
        if max_attempts < 1:
            raise ValueError("max_attempts must be >= 1")
        self.max_attempts = max_attempts
        self.backoff_seconds = backoff_seconds
        self.reload_index_on_failure = reload_index_on_failure
        self.retryable = retryable


class ReliableSearchEngine:
    """A search engine wrapper that retries failed query shards.

    Splits each batch into ``shard_size`` query shards; a shard that
    raises is retried up to the policy's attempt budget, optionally
    reloading the index from its `.awfmi` file first (the recovery path
    for a poisoned device or a transient file error). Results are exact:
    search is deterministic in (index, queries).

    ``engine_factory(index)`` makes the engine (and makes it again after
    a reload); by default ``SearchEngine(index, device=device)``, with
    ``device=None`` meaning the card. A factory brings its own device,
    e.g. ``functools.partial(DigramSearchEngine, device="cuda:0")``.
    """

    def __init__(
        self,
        index: FmIndex,
        shard_size: int = 1 << 16,
        policy: Optional[RetryPolicy] = None,
        engine_factory: Optional[Callable[[FmIndex], SearchEngine]] = None,
        *,
        device=None,
    ):
        if engine_factory is None:
            engine_factory = functools.partial(SearchEngine, device=resolve_device(device))
        self.index = index
        self.shard_size = shard_size
        self.policy = policy or RetryPolicy()
        self._engine_factory = engine_factory
        self.engine = engine_factory(index)
        self.stats = {"shards": 0, "retries": 0, "reloads": 0}

    def _reload_index(self) -> None:
        if self.index.file_path is None:
            return
        from ..io import awfmi

        logger.warning("reloading index from %s", self.index.file_path)
        self.index = awfmi.read_index(
            self.index.file_path,
            self.index.config.keep_suffix_array_in_memory,
        )
        self.engine = self._engine_factory(self.index)
        self.stats["reloads"] += 1

    def _run_shard(self, op_name: str, shard: Sequence):
        policy = self.policy
        last_err = None
        for attempt in range(policy.max_attempts):
            try:
                return getattr(self.engine, op_name)(shard)
            except Exception as err:
                if not policy.retryable(err):
                    # deterministic input/usage error: no amount of
                    # retrying or index reloading changes the outcome
                    raise
                last_err = err
                self.stats["retries"] += 1
                logger.warning(
                    "%s shard failed (attempt %d/%d): %s",
                    op_name, attempt + 1, policy.max_attempts, err,
                )
                if attempt + 1 == policy.max_attempts:
                    break  # no recovery work for a result that is discarded
                if policy.reload_index_on_failure:
                    try:
                        self._reload_index()
                    except Exception as reload_err:
                        # a failed reload must not consume the retry
                        # budget or mask the shard error: keep retrying
                        # with the current engine
                        logger.warning("index reload failed: %s", reload_err)
                time.sleep(policy.backoff_seconds * (attempt + 1))
        raise last_err

    def _sharded(self, op_name: str, kmers: Sequence[Union[str, bytes]]):
        results = []
        for lo in range(0, len(kmers), self.shard_size):
            self.stats["shards"] += 1
            results.append(self._run_shard(op_name, kmers[lo : lo + self.shard_size]))
        return results

    def count(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        if not kmers:
            return np.empty(0, dtype=np.uint64)
        return np.concatenate(self._sharded("count", kmers))

    def locate(self, kmers: Sequence[Union[str, bytes]]) -> List[np.ndarray]:
        out: List[np.ndarray] = []
        for part in self._sharded("locate", kmers):
            out.extend(part)
        return out

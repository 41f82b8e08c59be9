"""Chunked-corpus indexing: one corpus as overlapping sub-indexes.

Counterpart of ``avxwindowfmindex_tpu/parallel/chunked.py``. A corpus is
split into overlapping sub-indexes that behave like one big index:

  - chunk i covers [i*chunk_bases, i*chunk_bases + chunk_bases
    + overlap), with overlap >= max query length - 1 so matches that
    straddle a boundary are found in the earlier chunk;
  - a hit is attributed to the chunk where it STARTS inside the
    non-overlap span, so nothing is double-counted;
  - count/locate fan out over the sub-indexes and merge with global
    offsets.

The port's wide view serves positions >= 2^32 in one index; chunking is
the road that keeps the n-gram engine (narrow-only) on such a corpus:
``engine_factory=functools.partial(DigramSearchEngine, device=d)``.

Matching semantics are identical to one big index except that matches
may not span more than ``overlap + 1`` positions across a chunk boundary
— choose ``overlap`` >= your longest query.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Union

import numpy as np

from ..build import create_index
from ..models.config import IndexConfiguration
from ..models.index import resolve_device
from ..search import SearchEngine


def _flat_hits(engine, kmers):
    """(every kmer's hits in one flat uint64 array, the hits per kmer).
    This package's engines hand them over unsplit; any other engine
    needs only ``locate``."""
    if isinstance(engine, SearchEngine):
        flat, per_kmer = engine._locate_flat(kmers)
        return flat.astype(np.uint64), per_kmer
    per = engine.locate(kmers)
    flat = np.concatenate(per).astype(np.uint64) if per else np.empty(0, np.uint64)
    return flat, np.array([len(h) for h in per], dtype=np.int64)


class ChunkedCorpusIndex:
    """A list of overlapping sub-indexes behaving like one big index."""

    def __init__(self, engines: List[SearchEngine], chunk_bases: int,
                 overlap: int, total_bases: int):
        self.engines = engines
        self.chunk_bases = chunk_bases
        self.overlap = overlap
        self.total_bases = total_bases
        # raw text of each junction (the first `overlap` bases of chunks
        # 1..C-1); enables the O(1)-per-kmer count() correction
        self.junction_texts: List[bytes] = []
        # lazily-built tiny sub-engines over each junction
        self._junction_engines: Optional[List[SearchEngine]] = None

    @classmethod
    def build(
        cls,
        sequence: Union[bytes, np.ndarray],
        config: Optional[IndexConfiguration] = None,
        chunk_bases: int = (1 << 31),
        overlap: int = 255,
        engine_factory=None,
        *,
        device=None,
    ) -> "ChunkedCorpusIndex":
        """Build every chunk's index on ``device`` (``None``: the card)
        and wrap it with ``engine_factory`` (default: ``SearchEngine`` on
        ``device``)."""
        device = resolve_device(device)
        if engine_factory is None:
            engine_factory = functools.partial(SearchEngine, device=device)
        if isinstance(sequence, np.ndarray):
            sequence = sequence.tobytes()
        total = len(sequence)
        if chunk_bases < 1 or overlap < 0:
            raise ValueError("chunk_bases must be >=1 and overlap >= 0")
        engines = []
        junctions = []
        for start in range(0, total, chunk_bases):
            chunk = sequence[start : start + chunk_bases + overlap]
            engines.append(engine_factory(create_index(chunk, config, device=device)))
            if start > 0:
                junctions.append(sequence[start : start + overlap])
        out = cls(engines, chunk_bases, overlap, total)
        out.junction_texts = junctions
        return out

    @property
    def num_chunks(self) -> int:
        return len(self.engines)

    def _check_query_lengths(self, kmers) -> None:
        max_len = max((len(k) for k in kmers), default=0)
        if max_len > self.overlap + 1 and self.num_chunks > 1:
            raise ValueError(
                f"query length {max_len} exceeds chunk overlap + 1 "
                f"({self.overlap + 1}); rebuild with a larger overlap"
            )

    def locate(self, kmers: Sequence[Union[str, bytes]]) -> List[np.ndarray]:
        """Global hit positions per kmer, merged across chunks."""
        self._check_query_lengths(kmers)
        qids, positions = [], []
        for i, engine in enumerate(self.engines):
            flat, per_kmer = _flat_hits(engine, kmers)
            qid = np.repeat(np.arange(len(kmers)), per_kmer)
            # attribute a hit to the chunk where it starts inside the
            # non-overlap span (the overlap's copies belong to the NEXT
            # chunk's head)
            keep = flat < self.chunk_bases
            qids.append(qid[keep])
            positions.append(flat[keep] + np.uint64(i * self.chunk_bases))
        qid, pos = np.concatenate(qids), np.concatenate(positions)
        order = np.lexsort((pos, qid))  # by query, each query's hits ascending
        counts = np.bincount(qid, minlength=len(kmers))
        return np.split(pos[order], np.cumsum(counts)[:-1])

    def _junctions(self) -> List[SearchEngine]:
        """Tiny single-step sub-engines over each junction string, built
        on demand on the device of the first chunk's engine.

        A junction is <= `overlap` bases, so these indexes are a few KB;
        the seed table is shrunk accordingly (seed k capped at 6) and the
        SA is irrelevant (count never backtraces).
        """
        if self._junction_engines is None:
            base = self.engines[0].dev
            cfg = IndexConfiguration(
                suffix_array_compression_ratio=1,
                kmer_length_in_seed_table=min(base.kmer_length_in_seed_table, 6),
                alphabet_type=base.alphabet,
            )
            self._junction_engines = [
                SearchEngine(create_index(text, cfg, device=base.device), device=base.device)
                for text in self.junction_texts
            ]
        return self._junction_engines

    def count(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """Occurrence counts per kmer — O(1) per kmer per chunk.

        Sum of per-chunk range lengths, minus the double-counted matches.
        A match is counted by both chunk i (in its overlap tail) and
        chunk i+1 (at its head) exactly when it fits wholly within the
        first `overlap` bases of chunk i+1 — chunk i's window ends there,
        so any match extending past it exists only in chunk i+1. That
        correction is an exact count over a FIXED tiny string (the
        junction), answered by a sub-index range length: no locate
        anywhere (the reference's count is likewise range arithmetic
        only, AwFmParallelSearch.c:187-190).
        """
        self._check_query_lengths(kmers)
        if (
            self.num_chunks > 1
            and self.overlap > 0
            and len(self.junction_texts) != self.num_chunks - 1
        ):
            # constructed without junction texts (direct __init__): the
            # locate-derived count, the JAX package's own semantics
            return np.array([len(h) for h in self.locate(kmers)], dtype=np.uint64)
        total = np.zeros(len(kmers), dtype=np.uint64)
        for engine in self.engines:
            total += engine.count(kmers)
        if self.num_chunks > 1 and self.overlap > 0:
            for jeng in self._junctions():
                total -= jeng.count(kmers)
        return total

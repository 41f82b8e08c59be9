"""Port parity: the chunked corpus (parallel/chunked.py).

Every case of tests/test_chunked.py runs through both packages — JAX on
the CPU, the port on ``device="cpu"`` — and the chunked answers are held
to the JAX package's chunked and monolithic answers, with tolerance 0.
Added: chunks served by the port's n-gram engine
(``functools.partial(DigramSearchEngine, device=...)``) and the device
rule of ``build``.
"""

import functools

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.parallel.chunked import ChunkedCorpusIndex as JChunked
from avxwindowfmindex_tpu_torch.parallel.chunked import ChunkedCorpusIndex as PChunked

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, configs

DNA = jx.AlphabetType.DNA


def _cfgs():
    return configs(4, 3, DNA)


def build_both(seq, **kw):
    """(JAX chunked, port chunked, JAX monolithic engine) of one text."""
    jcfg, pcfg = _cfgs()
    return (
        JChunked.build(seq, jcfg, **kw),
        PChunked.build(seq, pcfg, device="cpu", **kw),
        jx.SearchEngine(jx.create_index(seq, jcfg)),
    )


def assert_answers(j, p, mono, kmers, locate=True):
    np.testing.assert_array_equal(p.count(kmers), j.count(kmers))
    np.testing.assert_array_equal(p.count(kmers), mono.count(kmers))
    if locate:
        got = p.locate(kmers)
        assert_locates_equal(got, j.locate(kmers))
        assert_locates_equal(got, [np.sort(h.astype(np.uint64)) for h in mono.locate(kmers)])
        assert all(h.dtype == np.uint64 for h in got)


def test_chunked_matches_monolithic(rng):
    seq = random_sequence(rng, 3000, DNA)
    j, p, mono = build_both(seq, chunk_bases=1000, overlap=15)
    assert p.num_chunks == j.num_chunks == 3
    kmers = [random_kmer(rng, int(rng.integers(3, 13)), DNA) for _ in range(120)]
    assert_answers(j, p, mono, kmers)


def test_boundary_straddling_matches(rng):
    marker = b"GATTACAGATTA"  # placed across every chunk boundary
    seq = bytearray(random_sequence(rng, 2500, DNA))
    for boundary in (1000, 2000):
        seq[boundary - 6 : boundary + 6] = marker
    j, p, mono = build_both(bytes(seq), chunk_bases=1000, overlap=15)
    assert_answers(j, p, mono, [marker])


def test_overlong_query_rejected(rng):
    seq = random_sequence(rng, 2000, DNA)
    jcfg, pcfg = _cfgs()
    for chunked in (PChunked.build(seq, pcfg, chunk_bases=1000, overlap=7, device="cpu"),
                    JChunked.build(seq, jcfg, chunk_bases=1000, overlap=7)):
        with pytest.raises(ValueError, match="overlap"):
            chunked.count([b"ACGTACGTACGT"])  # 12 > overlap + 1


def test_single_chunk_passthrough(rng):
    seq = random_sequence(rng, 500, DNA)
    j, p, mono = build_both(seq, chunk_bases=10_000, overlap=0)
    assert p.num_chunks == 1
    assert_answers(j, p, mono, [random_kmer(rng, 30, DNA)])  # long is fine in 1 chunk


def test_high_frequency_kmer_count(rng):
    """Kmers that occur thousands of times and straddle every boundary:
    count stays exact through the junction correction and agrees with the
    locate-derived value."""
    seq = bytearray(random_sequence(rng, 4000, DNA))
    for i in range(0, 4000, 7):
        seq[i] = ord("A")
    seq = bytes(seq).replace(b"C", b"A")
    j, p, mono = build_both(seq, chunk_bases=900, overlap=12)
    kmers = [b"AA", b"AAA", b"AAAAA", b"AT", b"TAA", b"GA", b"A" * 13]
    assert_answers(j, p, mono, kmers, locate=False)
    np.testing.assert_array_equal(
        p.count(kmers), np.array([len(h) for h in p.locate(kmers)], dtype=np.uint64)
    )
    assert len(p._junctions()) == p.num_chunks - 1
    assert all(type(e) is pt.SearchEngine and e.dev.kmer_length_in_seed_table == 3
               and e.dev.ratio == 1 for e in p._junctions())


def test_count_without_junction_texts_falls_back(rng):
    """A ChunkedCorpusIndex made without junction texts counts through
    locate (the JAX package's own semantics), to the same answers."""
    seq = random_sequence(rng, 2000, DNA)
    j, p, mono = build_both(seq, chunk_bases=800, overlap=10)
    bare = PChunked(p.engines, p.chunk_bases, p.overlap, p.total_bases)
    jbare = JChunked(j.engines, j.chunk_bases, j.overlap, j.total_bases)
    kmers = [random_kmer(rng, 6, DNA) for _ in range(20)]
    np.testing.assert_array_equal(bare.count(kmers), p.count(kmers))
    np.testing.assert_array_equal(bare.count(kmers), jbare.count(kmers))
    assert bare._junction_engines is None  # no junction index was built


def test_chunked_empty_query_list(rng):
    seq = random_sequence(rng, 2500, DNA)
    jcfg, pcfg = _cfgs()
    for chunked in (PChunked.build(seq, pcfg, chunk_bases=1000, overlap=15, device="cpu"),
                    JChunked.build(seq, jcfg, chunk_bases=1000, overlap=15)):
        with pytest.raises(ValueError, match="non-empty"):
            chunked.count([])
        with pytest.raises(ValueError, match="non-empty"):
            chunked.locate([])


# ---------------------------------------------------------------------------
# the n-gram engine serves chunks; the device rule
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kmer_len", [6, 11, 16])
def test_chunked_with_digram_engines(rng, kmer_len):
    """Chunks served by DigramSearchEngine (uniform clean batches longer
    than the seed take its n-gram steps) answer as the JAX package's
    single-step chunks and its monolithic engine; junctions stay
    single-step."""
    seq = bytearray(random_sequence(rng, 3000, DNA, clean=True))
    for boundary in (1000, 2000):
        seq[boundary - 5 : boundary + 5] = b"GATTACAGAT"
    seq = bytes(seq)
    jcfg, pcfg = _cfgs()
    j = JChunked.build(seq, jcfg, chunk_bases=1000, overlap=15)
    mono = jx.SearchEngine(jx.create_index(seq, jcfg))
    p = PChunked.build(seq, pcfg, chunk_bases=1000, overlap=15, device="cpu",
                       engine_factory=functools.partial(pt.DigramSearchEngine, device="cpu"))
    assert all(type(e) is pt.DigramSearchEngine for e in p.engines)
    starts = list(rng.integers(0, len(seq) - kmer_len, 60))
    starts += [b - d for b in (1000, 2000) for d in range(1, kmer_len)]  # across boundaries
    kmers = [seq[s : s + kmer_len] for s in starts]
    assert_answers(j, p, mono, kmers)
    assert all(type(e) is pt.SearchEngine for e in p._junctions())


class LocateOnly:
    """An engine that offers only ``count``, ``locate`` and its view, as a
    caller's own factory may."""

    def __init__(self, index):
        self._eng = pt.SearchEngine(index, device="cpu")
        self.dev = self._eng.dev

    def count(self, kmers):
        return self._eng.count(kmers)

    def locate(self, kmers):
        return self._eng.locate(kmers)


def test_chunked_with_locate_only_engines(rng):
    """A factory's engine needs no more than ``locate`` (and ``count``):
    the merge falls back to joining its per-kmer hits, to the same
    answers as the port's own engines and the JAX package's."""
    seq = random_sequence(rng, 1500, DNA)
    jcfg, pcfg = _cfgs()
    p = PChunked.build(seq, pcfg, chunk_bases=600, overlap=9, device="cpu",
                       engine_factory=LocateOnly)
    j = JChunked.build(seq, jcfg, chunk_bases=600, overlap=9)
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), DNA) for _ in range(30)]
    got = p.locate(kmers)
    assert all(h.dtype == np.uint64 for h in got)
    assert_locates_equal(got, j.locate(kmers))
    np.testing.assert_array_equal(p.count(kmers), j.count(kmers))


def test_chunked_corpus_index_top_level(rng):
    seq = random_sequence(rng, 1500, DNA)
    jcfg, pcfg = _cfgs()
    p = pt.chunked_corpus_index(seq, pcfg, chunk_bases=600, overlap=9, device="cpu")
    j = jx.chunked_corpus_index(seq, jcfg, chunk_bases=600, overlap=9)
    assert isinstance(p, PChunked) and p.num_chunks == j.num_chunks == 3
    assert p.junction_texts == j.junction_texts
    kmers = [random_kmer(rng, 7, DNA) for _ in range(30)]
    np.testing.assert_array_equal(p.count(kmers), j.count(kmers))
    if not torch.cuda.is_available():  # device=None means the card
        with pytest.raises(RuntimeError, match="device="):
            pt.chunked_corpus_index(seq, pcfg, chunk_bases=600, overlap=9)

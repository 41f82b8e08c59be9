"""Port parity: the awFmParallelSearch* batch API and the search-list shim
(parallel/api.py).

Every case of tests/test_parallel_api.py runs through both packages — JAX
on the CPU, the port on ``device="cpu"`` — with tolerance 0. Added: the
engine cache's key (index identity and device) and its guard against a
device view replaced since the engine was built.
"""

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu.parallel.api as japi
import avxwindowfmindex_tpu_torch as pt
import avxwindowfmindex_tpu_torch.parallel.api as papi
from avxwindowfmindex_tpu_torch.build import attach_seed_table

from oracle import count_occurrences, random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both

DNA = jx.AlphabetType.DNA


@pytest.fixture
def built(rng):
    seq = random_sequence(rng, 1000, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    return seq, j, p


def test_parallel_search_count_and_locate(built, rng):
    seq, j, p = built
    kmers = [random_kmer(rng, 5, DNA) for _ in range(40)]
    counts = pt.parallel_search_count(p, kmers, num_threads=4, device="cpu")
    hits = pt.parallel_search_locate(p, kmers, num_threads=4, device="cpu")
    np.testing.assert_array_equal(counts, jx.parallel_search_count(j, kmers, num_threads=4))
    assert counts.dtype == np.uint64
    assert_locates_equal(hits, jx.parallel_search_locate(j, kmers, num_threads=4))
    for kmer, c, h in zip(kmers, counts, hits):
        assert c == count_occurrences(seq, kmer, DNA)
        assert len(h) == c


def test_kmer_search_list_shim(built, rng):
    # the reference's usage pattern (AwFmIndex.h:330-346): allocate, fill,
    # search, read counts and position lists, reuse
    seq, j, p = built
    plist, jlist = papi.create_kmer_search_list(capacity=16), japi.create_kmer_search_list(16)
    kmers = [random_kmer(rng, 4, DNA) for _ in range(10)]
    plist.set_kmers(kmers)
    jlist.set_kmers(kmers)
    assert plist.count == jlist.count == 10

    plist.search_count(p, num_threads=2, device="cpu")
    jlist.search_count(j, num_threads=2)
    for i, kmer in enumerate(kmers):
        assert plist.kmer_search_data[i].count == jlist.kmer_search_data[i].count
        assert plist.kmer_search_data[i].count == count_occurrences(seq, kmer, DNA)

    plist.search_locate(p, device="cpu")
    jlist.search_locate(j)
    for pd, jd in zip(plist.kmer_search_data[:10], jlist.kmer_search_data[:10]):
        np.testing.assert_array_equal(pd.position_list, jd.position_list)
        assert pd.count == jd.count and pd.capacity == jd.capacity
        assert pd.kmer_length == jd.kmer_length

    plist.set_kmers(kmers[:3])  # reuse with a different count
    plist.search_count(p, device="cpu")
    assert plist.count == 3
    with pytest.raises(ValueError):
        plist.set_kmers([b"A"] * 17)  # beyond capacity


def test_parallel_api_empty_batch_noop(built):
    """The reference's loop over 0 entries is a no-op, not an error."""
    _, j, p = built
    assert pt.parallel_search_count(p, [], device="cpu").shape == (0,)
    assert pt.parallel_search_count(p, [], device="cpu").dtype == np.uint64
    assert pt.parallel_search_locate(p, [], device="cpu") == [] == jx.parallel_search_locate(j, [])
    sl = papi.create_kmer_search_list(capacity=4)  # count 0 before the first fill
    sl.search_count(p, device="cpu")
    sl.search_locate(p, device="cpu")


def test_engine_cache_is_bounded(rng):
    """The cache must not pin every index ever searched (an engine holds
    its index and its device tables)."""
    cfg = pt.IndexConfiguration(4, 3, pt.AlphabetType.DNA)
    indexes = [
        pt.create_index(random_sequence(rng, 400, DNA), cfg, device="cpu")
        for _ in range(papi._ENGINE_CACHE_MAX + 3)
    ]
    for index in indexes:
        pt.parallel_search_count(index, [b"ACGT"], device="cpu")
    assert papi._ENGINE_CACHE_MAX == japi._ENGINE_CACHE_MAX == 4
    assert len(papi._ENGINE_CACHE) <= papi._ENGINE_CACHE_MAX
    eng = papi._engine_for(indexes[-1], "cpu")
    assert papi._engine_for(indexes[-1], "cpu") is eng


def test_engine_cache_key_and_view_guard(rng):
    """The key is (index identity, device): spellings of one CPU device
    share one engine; a view replaced since the engine was built (a seed
    table attached, a view of another width) gets a new engine, whose
    answers equal the JAX package's."""
    seq = random_sequence(rng, 700, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    kmers = [random_kmer(rng, 5, DNA) for _ in range(30)]
    want = jx.SearchEngine(j).count(kmers)
    eng = papi._engine_for(p, "cpu")
    assert papi._engine_for(p, torch.device("cpu")) is eng
    assert papi._engine_for(p, "cpu:0") is eng
    assert (id(p), torch.device("cpu")) in papi._ENGINE_CACHE

    attach_seed_table(p, "cpu")  # replaces the index's one cached view
    fresh = papi._engine_for(p, "cpu")
    assert fresh is not eng and fresh.dev is p._device_cache
    np.testing.assert_array_equal(pt.parallel_search_count(p, kmers, device="cpu"), want)

    p.to_device("cpu", wide=True)  # another view evicts the narrow one
    again = papi._engine_for(p, "cpu")
    assert again is not fresh and again.dev is p._device_cache and not again.dev.wide
    np.testing.assert_array_equal(pt.parallel_search_count(p, kmers, device="cpu"), want)
    assert_locates_equal(pt.parallel_search_locate(p, kmers, device="cpu"),
                         jx.parallel_search_locate(j, kmers))


def test_parallel_api_without_device_targets_the_card(built):
    """``device=None`` means the card; without one the call raises naming
    device= rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would use it")
    _, _, p = built
    for call in (pt.parallel_search_count, pt.parallel_search_locate):
        with pytest.raises(RuntimeError, match="device="):
            call(p, [b"ACGT"])

"""Port parity: the single-query API (AwFmSearch.c's per-query functions).

Each function of ``avxwindowfmindex_tpu_torch.search`` against its JAX
counterpart (``avxwindowfmindex_tpu/search.py:1879-2023``) on the same
index, for DNA and amino, on the narrow view and on a forced-wide one.
The JAX functions take their view from ``FmIndex.to_device()``, so the
wide cases patch that method to ask for the wide view, as
``tests/test_parity_divergences.py`` does; the port's functions take
``wide=True``. Every quantity is an integer: tolerance 0.
"""

import numpy as np
import pytest

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.models.index import FmIndex as JaxFmIndex

from oracle import random_kmer, random_sequence
from torch_helpers import build_both

CASES = [(jx.AlphabetType.DNA, 4, 3, 3000), (jx.AlphabetType.AMINO, 8, 2, 2500)]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0].name)
def both(request):
    alphabet, ratio, k, n = request.param
    rng = np.random.default_rng(0x51C + n)
    seq = random_sequence(rng, n, alphabet)
    j, p = build_both(seq, ratio, k, alphabet)
    return j, p, seq, alphabet


@pytest.fixture(params=[False, True], ids=["narrow", "wide"])
def width(request, monkeypatch, both):
    """False or True; for True the JAX index hands out its wide view."""
    j = both[0]
    j._device_cache = None
    if request.param:
        orig = JaxFmIndex.to_device
        monkeypatch.setattr(
            JaxFmIndex, "to_device",
            lambda self, refresh=False, wide=None: orig(self, refresh=refresh, wide=True),
        )
    yield request.param
    j._device_cache = None


def _kw(width):
    return dict(device="cpu", wide=True if width else None)


def _queries(seq, alphabet, rng):
    present = [seq[s : s + int(rng.integers(1, 11))] for s in rng.integers(0, len(seq) - 11, 12)]
    drawn = [random_kmer(rng, int(rng.integers(2, 9)), alphabet) for _ in range(12)]
    amb = b"X" if alphabet == jx.AlphabetType.AMINO else b"N"
    absent = b"W" * 9 if alphabet == jx.AlphabetType.AMINO else b"ACGTACGTACGTACGTACGTA"
    return present + drawn + [seq[40:44] + amb, amb, absent]


def test_find_search_range_and_kmer_exists(both, width):
    j, p, seq, alphabet = both
    rng = np.random.default_rng(1)
    seen = set()
    for kmer in _queries(seq, alphabet, rng):
        want = jx.find_search_range_for_string(j, kmer)
        got = pt.find_search_range_for_string(p, kmer, **_kw(width))
        assert got == want and all(type(v) is int for v in got), kmer
        exists = pt.single_kmer_exists(p, kmer, **_kw(width))
        assert exists == jx.single_kmer_exists(j, kmer) == (want[0] <= want[1]), kmer
        assert pt.search_range_is_valid(*got) == jx.search_range_is_valid(*want) == exists
        seen.add(exists)
    assert seen == {True, False}  # present k-mers and an absent one
    # a str query is taken as its bytes
    kmer = seq[10:16]
    assert pt.find_search_range_for_string(p, kmer.decode(), **_kw(width)) == (
        jx.find_search_range_for_string(j, kmer)
    )


def test_find_search_range_never_uses_the_seed_table(both, width):
    j, p, seq, alphabet = both
    kmer = seq[100:107]
    want = pt.find_search_range_for_string(p, kmer, **_kw(width))
    # the same index with a wrecked seed table gives the same range
    dev = p.to_device("cpu", wide=True if width else None)
    saved = dev.seed_table.clone()
    try:
        dev.seed_table.zero_()
        assert pt.find_search_range_for_string(p, kmer, **_kw(width)) == want
    finally:
        dev.seed_table.copy_(saved)
    assert want == jx.find_search_range_for_string(j, kmer)


def test_iterative_step_backward_search(both, width):
    j, p, seq, alphabet = both
    rng = np.random.default_rng(2)
    card = pt.NUCLEOTIDE_CARDINALITY if alphabet == jx.AlphabetType.DNA else pt.AMINO_CARDINALITY
    for kmer in [seq[s : s + 3] for s in rng.integers(0, len(seq) - 3, 6)]:
        rng_j = jx.create_initial_query_range(j, kmer)
        rng_p = pt.create_initial_query_range(p, kmer)
        assert rng_p == rng_j
        for letter in rng.integers(0, card + 1, 4):  # the ambiguity letter too
            want = jx.iterative_step_backward_search(j, *rng_j, int(letter))
            got = pt.iterative_step_backward_search(p, *rng_p, int(letter), **_kw(width))
            assert got == want, (kmer, letter)
    # the step is unconditional: an invalid range is stepped all the same
    want = jx.iterative_step_backward_search(j, 700, 20, 1)
    assert pt.iterative_step_backward_search(p, 700, 20, 1, **_kw(width)) == want


def test_letter_by_letter_loop_equals_the_range_search(both, width):
    j, p, seq, alphabet = both
    kmer = seq[200:207]
    letters = pt.models.alphabet.ascii_to_index(np.frombuffer(kmer, np.uint8), p.alphabet)
    s, e = pt.create_initial_query_range(p, kmer)
    for letter in letters[-2::-1]:
        if not pt.search_range_is_valid(s, e):
            break
        s, e = pt.iterative_step_backward_search(p, s, e, int(letter), **_kw(width))
    assert (s, e) == pt.find_search_range_for_string(p, kmer, **_kw(width))
    assert (s, e) == jx.find_search_range_for_string(j, kmer)


def test_find_database_hit_positions(both, width):
    j, p, seq, alphabet = both
    rng = np.random.default_rng(3)
    for kmer in [seq[s : s + int(rng.integers(1, 6))] for s in rng.integers(0, len(seq) - 6, 6)]:
        s, e = jx.find_search_range_for_string(j, kmer)
        want = jx.find_database_hit_positions(j, s, e)
        got = pt.find_database_hit_positions(p, s, e, **_kw(width))
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, want)
        assert len(got) == e - s + 1 >= 1
    # an invalid range has no hits
    assert len(pt.find_database_hit_positions(p, 9, 8, **_kw(width))) == 0
    assert len(jx.find_database_hit_positions(j, 9, 8)) == 0


def test_find_database_hit_position_single(both, width):
    j, p, seq, alphabet = both
    rng = np.random.default_rng(4)
    for pos in [0, 1, p.bwt_length - 1] + rng.integers(0, p.bwt_length, 8).tolist():
        want = jx.find_database_hit_position_single(j, int(pos))
        got = pt.find_database_hit_position_single(p, int(pos), **_kw(width))
        assert got == want and type(got) is int, pos


def test_backtrace_return_previous_letter_index(both, width):
    j, p, seq, alphabet = both
    rng = np.random.default_rng(5)
    sentinel_pos = int(np.flatnonzero(p.bwt_letters == p.sentinel_index)[0])
    for pos in [0, 37, sentinel_pos, p.bwt_length - 1] + rng.integers(0, p.bwt_length, 12).tolist():
        want = jx.backtrace_return_previous_letter_index(j, int(pos))
        got = pt.backtrace_return_previous_letter_index(p, int(pos), **_kw(width))
        assert got == want, pos
    # the sentinel's early-out: letter 0 and the position as it was
    assert pt.backtrace_return_previous_letter_index(p, sentinel_pos, **_kw(width)) == (
        0, sentinel_pos
    )


def test_query_can_use_kmer_table(both):
    j, p, seq, alphabet = both
    amb = b"X" if alphabet == jx.AlphabetType.AMINO else b"N"
    k = p.config.kmer_length_in_seed_table
    for kmer in [seq[5 : 5 + k], seq[5 : 4 + k], seq[5 : 9 + k], seq[5 : 5 + k] + amb,
                 amb + seq[5 : 5 + k], seq[5:7] + amb + seq[7 : 6 + k], (seq[5 : 5 + k]).decode()]:
        assert pt.query_can_use_kmer_table(p, kmer) == jx.query_can_use_kmer_table(j, kmer), kmer
    assert pt.query_can_use_kmer_table(p, b"A" * k)
    assert not pt.query_can_use_kmer_table(p, b"A" * (k - 1))


def test_create_initial_query_range(both):
    j, p, seq, alphabet = both
    amb = b"X" if alphabet == jx.AlphabetType.AMINO else b"N"
    for query in [seq[:1], seq[3:9], seq[7:8] + amb, "ACG" if alphabet == jx.AlphabetType.DNA else "ACD"]:
        assert pt.create_initial_query_range(p, query) == jx.create_initial_query_range(j, query)


def test_top_level_exports_match_the_jax_package():
    """Everything the JAX package exports, the port exports too (the batch
    API, the artifact serde and the chunked corpus included)."""
    assert set(jx.__all__) - set(pt.__all__) == set()
    for name in jx.__all__:
        assert hasattr(pt, name), name
    for name in ("CURRENT_VERSION_NUMBER", "NUCLEOTIDE_CARDINALITY", "AMINO_CARDINALITY",
                 "POSITIONS_PER_BLOCK"):
        assert getattr(pt, name) == getattr(jx, name)
    np.testing.assert_array_equal(pt.search_range_length([3, 9], [7, 8]),
                                  jx.search_range_length([3, 9], [7, 8]))
    assert [int(c) for c in pt.ReturnCode] == [int(c) for c in jx.ReturnCode]

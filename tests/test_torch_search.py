"""Port parity: SearchEngine count/locate/ranges against the JAX engine.

Covers mixed query lengths, ambiguity letters, unseeded short k-mers,
amino, the suffix array kept on disk, and the pair-window overflow
corpus (a long run of 'A' whose seeded ranges span more than 512
positions). On the CPU the port's K2/K3 wrappers run their plain
versions, which K2/K3 equal on the card. Exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch import search as psearch

from oracle import match_positions, random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both, configs

CASES = [
    (jx.AlphabetType.DNA, 4, 4, 12000),
    (jx.AlphabetType.AMINO, 8, 2, 6000),
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: c[0].name)
def engines(request):
    alphabet, ratio, k, n = request.param
    rng = np.random.default_rng(0x5E4C + n)
    seq = random_sequence(rng, n, alphabet)
    j, p = build_both(seq, ratio, k, alphabet)
    return seq, alphabet, jx.SearchEngine(j), pt.SearchEngine(p, device="cpu")


def _queries(rng, seq, alphabet, k):
    """Sampled hits of mixed lengths, random clean k-mers, short
    (unseeded) k-mers and k-mers with ambiguity letters."""
    qs = [seq[s : s + int(L)] for s, L in zip(rng.integers(0, len(seq) - 20, 120), rng.integers(1, 20, 120))]
    qs += [random_kmer(rng, int(L), alphabet) for L in rng.integers(1, 14, 60)]
    qs += [random_kmer(rng, int(L), alphabet, clean=False) for L in rng.integers(1, 14, 60)]
    amb = b"N" if alphabet == jx.AlphabetType.DNA else b"X"
    qs += [seq[s : s + k + 3] + amb for s in rng.integers(0, len(seq) - 20, 20)]
    qs += [amb + seq[s : s + k + 3] for s in rng.integers(0, len(seq) - 20, 20)]
    return qs


def test_count_and_locate_match_jax(engines):
    seq, alphabet, je, pe = engines
    rng = np.random.default_rng(1)
    qs = _queries(rng, seq, alphabet, pe.dev.kmer_length_in_seed_table)
    counts = pe.count(qs)
    np.testing.assert_array_equal(counts, je.count(qs))
    assert counts.dtype == np.uint64
    assert_locates_equal(pe.locate(qs), je.locate(qs))


def test_ranges_match_jax(engines):
    seq, alphabet, je, pe = engines
    rng = np.random.default_rng(2)
    qs = _queries(rng, seq, alphabet, pe.dev.kmer_length_in_seed_table)
    np.testing.assert_array_equal(pe.find_ranges(qs), je.find_ranges(qs))
    mat, lengths, _ = pe.encode_kmers(qs)
    np.testing.assert_array_equal(pe._seed_eligibility(mat, lengths), je._seed_eligibility(mat, lengths))


def test_unseeded_short_kmers(engines):
    seq, alphabet, je, pe = engines
    k = pe.dev.kmer_length_in_seed_table
    rng = np.random.default_rng(3)
    qs = [seq[s : s + int(L)] for s, L in zip(rng.integers(0, len(seq) - k, 64), rng.integers(1, k, 64))]
    mat, lengths, _ = pe.encode_kmers(qs)
    assert not pe._seed_eligibility(mat, lengths)[: len(qs)].any()
    np.testing.assert_array_equal(pe.count(qs), je.count(qs))
    assert_locates_equal(pe.locate(qs), je.locate(qs))


def test_encode_kmers_matches_jax(engines):
    seq, alphabet, je, pe = engines
    rng = np.random.default_rng(4)
    uniform = [random_kmer(rng, 7, alphabet) for _ in range(37)]
    mixed = uniform + [uniform[0][:5], uniform[1].decode()]
    for qs in (uniform, mixed):
        for got, want in zip(pe.encode_kmers(qs), je.encode_kmers(qs)):
            np.testing.assert_array_equal(got, want)


def test_resolve_every_position(engines):
    seq, alphabet, je, pe = engines
    n = pe.dev.bwt_length
    positions = np.arange(n, dtype=np.uint64)
    np.testing.assert_array_equal(pe.resolve_positions(positions), je.resolve_positions(positions))


def test_locate_against_oracle(engines):
    seq, alphabet, je, pe = engines
    rng = np.random.default_rng(5)
    for s in rng.integers(0, len(seq) - 8, 10):
        kmer = seq[s : s + 6]
        got = np.sort(pe.locate([kmer])[0].astype(np.int64))
        np.testing.assert_array_equal(got, match_positions(seq, kmer, alphabet))


def test_total_hits_and_enumerate():
    start = torch.tensor([5, 9, 3, 0, 2**32 - 3], dtype=torch.int64)
    end = torch.tensor([7, 8, 3, 1, 2**32 - 1], dtype=torch.int64)
    assert psearch.total_hits_host(start, end) == 3 + 0 + 1 + 2 + 3
    counts = psearch.range_counts(start, end)
    pos = psearch.enumerate_range_positions(start, counts)
    want = jx.SearchEngine._flat_positions(start.numpy().astype(np.uint64), counts.numpy())
    np.testing.assert_array_equal(pos.numpy().astype(np.uint64), want)


@pytest.mark.parametrize("alphabet", [jx.AlphabetType.DNA, jx.AlphabetType.AMINO], ids=lambda a: a.name)
def test_suffix_array_on_disk(tmp_path, alphabet):
    rng = np.random.default_rng(6)
    seq = random_sequence(rng, 3000, alphabet)
    jcfg, _ = configs(8, 3, alphabet)
    _, pcfg = configs(8, 3, alphabet, keep_suffix_array_in_memory=False)
    path = str(tmp_path / "disk.awfmi")
    j = jx.create_index(seq, jcfg)
    p = pt.create_index(seq, pcfg, file_src=path, device="cpu")
    assert p.sampled_sa is None and p.to_device("cpu").sampled_sa is None
    qs = [seq[s : s + int(L)] for s, L in zip(rng.integers(0, 2980, 80), rng.integers(2, 12, 80))]
    pe = pt.SearchEngine(p, device="cpu")
    assert_locates_equal(pe.locate(qs), jx.SearchEngine(j).locate(qs))
    loaded = pt.read_index_from_file(path, keep_suffix_array_in_memory=False)
    assert_locates_equal(pt.SearchEngine(loaded, device="cpu").locate(qs), jx.SearchEngine(j).locate(qs))


def test_pair_window_overflow_corpus():
    rng = np.random.default_rng(7)
    seq = b"A" * 4000 + random_sequence(rng, 6000, jx.AlphabetType.DNA, clean=True)
    j, p = build_both(seq, 8, 6, jx.AlphabetType.DNA)
    je, pe = jx.SearchEngine(j), pt.SearchEngine(p, device="cpu")
    qs = [b"A" * L for L in range(6, 40)] + [seq[s : s + 14] for s in rng.integers(3900, 4100, 64)]
    ranges = pe.find_ranges(qs)
    np.testing.assert_array_equal(ranges, je.find_ranges(qs))
    # seeded ranges wider than the 512-position pair window were stepped
    seed_widths = pe.find_ranges([b"A" * 6])[0]
    assert seed_widths[1] - seed_widths[0] + 1 > 512
    np.testing.assert_array_equal(pe.count(qs), je.count(qs))
    assert_locates_equal(pe.locate(qs), je.locate(qs))


def test_engine_requires_matching_device():
    rng = np.random.default_rng(8)
    seq = random_sequence(rng, 400, jx.AlphabetType.DNA)
    _, p = build_both(seq, 4, 2, jx.AlphabetType.DNA)
    dev = p.to_device("cpu")
    with pytest.raises(ValueError, match="lives on"):
        pt.SearchEngine(dev, device="meta")
    with pytest.raises(TypeError):
        pt.SearchEngine(p)

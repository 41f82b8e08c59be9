"""The plain reference against a brute-force scan, and the comparison
that decides ``correct``."""

import numpy as np
import pytest
import torch

from benchmark.reference import WindowTable, compare_answers


def _scan(text: bytes, query: bytes):
    return [i for i in range(len(text) - len(query) + 1) if text[i:i + len(query)] == query]


def _answer(text: bytes, alphabet: str, queries, prefix: int):
    cols = max(len(q) for q in queries)
    mat = np.zeros((len(queries), cols), dtype=np.uint8)
    for i, q in enumerate(queries):
        mat[i, :len(q)] = np.frombuffer(q, dtype=np.uint8)
    lengths = torch.tensor([len(q) for q in queries])
    table = WindowTable(torch.from_numpy(np.frombuffer(text, dtype=np.uint8).copy()), alphabet, prefix)
    counts, hits = table.answer(torch.from_numpy(mat), lengths, block=7)
    return counts, hits


def _check_against_scan(text, alphabet, queries, prefix):
    counts, hits = _answer(text, alphabet, queries, prefix)
    off = 0
    for q, c in zip(queries, counts.tolist()):
        want = _scan(text, q)
        assert c == len(want), q
        assert hits[off:off + c].tolist() == want, q
        off += c
    assert off == hits.numel()


@pytest.mark.parametrize("prefix", [3, 6, 10])
def test_dna_against_scan(prefix):
    rng = np.random.default_rng(1)
    text = bytes(np.frombuffer(b"ACGT", dtype=np.uint8)[rng.integers(0, 4, 3000)])
    queries = [text[s:s + n] for s, n in zip(rng.integers(0, 2980, 60), rng.integers(10, 16, 60))]
    queries += [b"ACGTACGTAC", b"AAAAAAAAAAAA", text[-10:], text[:12]]
    _check_against_scan(text, "dna", queries, prefix)


def test_proteins_across_record_boundaries():
    rng = np.random.default_rng(2)
    letters = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", dtype=np.uint8)
    records = [bytes(letters[rng.integers(0, 20, n)]) for n in (50, 3, 120, 7, 80)]
    text = b"".join(records)
    ends = np.cumsum([len(r) for r in records])
    # queries that straddle each boundary of the concatenated text match there
    queries = [text[e - 4:e + 5] for e in ends[:-1]]
    queries += [text[s:s + n] for s, n in zip(rng.integers(0, len(text) - 25, 40), rng.integers(7, 26, 40))]
    queries += [b"WWWWWWW", b"KR" * 4]
    _check_against_scan(text, "amino", queries, 7)
    counts, _ = _answer(text, "amino", queries[:len(ends) - 1], 7)
    assert (counts >= 1).all()


def test_letters_outside_the_alphabet_match_nothing():
    text = b"ACGTNACGTACGTNNACGT"
    counts, _ = _answer(text, "dna", [b"ACGTN", b"TACGT", b"NACGT", b"acgta"], 4)
    assert counts.tolist() == [0, 1, 0, 1]


def _answers():
    ref_counts = torch.tensor([2, 0, 1, 3])
    ref_hits = torch.tensor([5, 9, 4, 1, 2, 8])
    return ref_counts, ref_hits


def test_compare_accepts_the_same_hits_in_any_order():
    ref_counts, ref_hits = _answers()
    hits = torch.tensor([9, 5, 4, 8, 1, 2])
    assert compare_answers(ref_counts, ref_hits, ref_counts.clone(), hits, ref_counts.clone()) == (0, 0)


@pytest.mark.parametrize("fault", ["count", "hit", "fewer hits", "out of range"])
def test_compare_finds_each_fault(fault):
    ref_counts, ref_hits = _answers()
    counts, hits, hit_counts = ref_counts.clone(), ref_hits.clone(), ref_counts.clone()
    if fault == "count":
        counts[1] = 1
    elif fault == "hit":
        hits[3] += 1
    elif fault == "fewer hits":
        hit_counts[0], hits = 1, hits[1:]
    else:
        hits[5] = -7
    cw, hw = compare_answers(ref_counts, ref_hits, counts, hits, hit_counts)
    assert (cw, hw) == ((1, 0) if fault == "count" else (0, 1))

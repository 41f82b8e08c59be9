"""Port parity: the n-gram (n = 2, 3) engine against ops/ngram.py and the
JAX NgramSearchEngine.

The host builders must give byte-equal codes, Cn, block rows and pair
rows; the plain torch n-gram steps (the version K4 is held to on the
card) must equal the JAX steps, edge positions and the pair-window flag
included; ``NgramSearchEngine`` count, ranges and locate must equal the
JAX engine's on its fast path and on every fallback; and an ``.npz`` row
cache written by either package must load in the other. Exact:
tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.ops import ngram as jngram
from avxwindowfmindex_tpu_torch import search as psearch
from avxwindowfmindex_tpu_torch.models import convert
from avxwindowfmindex_tpu_torch.ops import ngram as pngram

from oracle import count_occurrences, random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both

DNA = jx.AlphabetType.DNA
NS = [2, 3]


@pytest.fixture(scope="module")
def indexes():
    """(JAX FmIndex, port FmIndex) of one 3,000-base DNA text, k = 3."""
    rng = np.random.default_rng(0x96A3)
    seq = random_sequence(rng, 3000, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    return seq, j, p


@pytest.fixture(scope="module")
def tables(indexes):
    """{(n, biased): (JAX NgramIndex, port NgramIndex)} of that index."""
    _, j, p = indexes
    return {
        (n, b): (
            jngram.build_ngram_device(j, n, bias_cn=b),
            pngram.build_ngram_device(p, n, device="cpu", bias_cn=b),
        )
        for n in NS for b in (True, False)
    }


@pytest.fixture(scope="module")
def engines(indexes):
    """{n: (JAX NgramSearchEngine, port NgramSearchEngine)}."""
    _, j, p = indexes
    return {
        n: (jx.NgramSearchEngine(j, n=n), pt.NgramSearchEngine(p, n, device="cpu"))
        for n in NS
    }


def _u32(x):
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


# ---------------------------------------------------------------------------
# Host builders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", NS)
def test_host_build_byte_equal(indexes, n):
    _, j, p = indexes
    jcodes, jcn = jngram.build_ngram_host(j, n)
    pcodes, pcn = pngram.build_ngram_host(p, n)
    assert pcodes.tobytes() == jcodes.tobytes()
    assert pcn.dtype == jcn.dtype and pcn.tobytes() == jcn.tobytes()
    jblocks = jngram.pack_ngram_blocks(jcodes, n)
    pblocks = pngram.pack_ngram_blocks(pcodes, n)
    assert pblocks.tobytes() == jblocks.tobytes()
    assert (
        pngram.pair_rows_from_ngram_blocks(pblocks, n).tobytes()
        == jngram.pair_rows_from_ngram_blocks(jblocks, n).tobytes()
    )
    assert pngram._geometry(n) == jngram._geometry(n)
    assert pngram._geometry_pair(n) == jngram._geometry_pair(n)


@pytest.mark.parametrize("n", NS)
def test_chunked_host_build_matches_unchunked(indexes, monkeypatch, n):
    _, _, p = indexes
    want_codes, want_cn = pngram.build_ngram_host(p, n)
    monkeypatch.setattr(pngram, "_HOST_CHUNK", 257)  # not a divisor
    got_codes, got_cn = pngram.build_ngram_host(p, n)
    np.testing.assert_array_equal(got_codes, want_codes)
    np.testing.assert_array_equal(got_cn, want_cn)


@pytest.mark.parametrize("chunk", [None, 64])
def test_letter_counts_before_matches_bruteforce(monkeypatch, chunk):
    rng = np.random.default_rng(0x1C)
    if chunk:
        monkeypatch.setattr(pngram, "_HOST_CHUNK", chunk)
    bwt = rng.integers(0, 6, size=5000).astype(np.uint8)
    bounds = np.concatenate([[0, 1, 256, 257, 4999, 5000, 2500, 5000], rng.integers(0, 5001, 16)])
    out = pngram._letter_counts_before(bwt, bounds)
    np.testing.assert_array_equal(out, jngram._letter_counts_before(bwt, bounds))
    for i, b in enumerate(bounds):
        for x in range(4):
            assert out[x, i] == int((bwt[:b] == x).sum()), (x, b)


@pytest.mark.parametrize("biased", [True, False], ids=["biased", "unbiased"])
@pytest.mark.parametrize("n", NS)
def test_device_table_bytes_equal_jax(tables, n, biased):
    jng, png = tables[(n, biased)]
    assert png.n == jng.n == n and png.biased == jng.biased == biased
    assert png.packed.dtype == torch.uint8 and png.cn.dtype == torch.int32
    assert png.packed.numpy().tobytes() == np.asarray(jng.packed).tobytes()
    assert png.cn.numpy().tobytes() == np.asarray(jng.cn).tobytes()


# ---------------------------------------------------------------------------
# Device functions (plain torch) against the JAX functions
# ---------------------------------------------------------------------------

def _step_inputs(n_positions, n, seed):
    """512 random ranges of width 0..600 (some past the pair window), the
    edge starts 0, 255, 256 and n-1, and edge positions including
    0xFFFFFFFF; letters in [0, 4)."""
    rng = np.random.default_rng(seed)
    last = n_positions - 1
    start = np.concatenate([rng.integers(0, last, size=512), [0, 255, 256, last, 0, 1]])
    width = np.concatenate([rng.integers(0, 601, size=512), [0, 5, 300, 0, 700, 0]])
    end = np.minimum(start + width, last)
    end[-1] = 0  # an invalid range (start > end) keeps itself
    pos = np.concatenate([rng.integers(0, n_positions, size=512), [0, 255, 256, last, 0xFFFFFFFF, 7]])
    letters = [rng.integers(0, 4, size=len(start)).astype(np.int32) for _ in range(n)]
    return start, end, pos, letters


def _compare_steps(jng, png, start, end, pos, letters):
    jl = [jnp.asarray(x) for x in letters]
    tl = [torch.from_numpy(x) for x in letters]
    js, je_ = jnp.asarray(_u32(start)), jnp.asarray(_u32(end))
    ts, te = torch.from_numpy(start.astype(np.int64)), torch.from_numpy(end.astype(np.int64))

    want = np.asarray(jngram.ngram_occurrence(jng, jnp.asarray(_u32(pos)), jl))
    got = pngram.ngram_occurrence(png, torch.from_numpy(pos.astype(np.int64)), tl)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))

    ws, we = jngram.ngram_backward_step(jng, js, je_, jl)
    gs, ge = pngram.ngram_backward_step(png, ts, te, tl)
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we).astype(np.int64))

    ws, we, wbad = jngram.ngram_backward_step_pair(jng, js, je_, jl, jnp.zeros(len(start), bool))
    gs, ge, gbad = pngram.ngram_backward_step_pair(
        png, ts, te, tl, torch.zeros(len(start), dtype=torch.bool)
    )
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we).astype(np.int64))
    np.testing.assert_array_equal(gbad.numpy(), np.asarray(wbad))
    return gbad


@pytest.mark.parametrize("biased", [True, False], ids=["biased", "unbiased"])
@pytest.mark.parametrize("n", NS)
def test_steps_match_jax(indexes, tables, n, biased):
    _, j, _ = indexes
    jng, png = tables[(n, biased)]
    bad = _compare_steps(jng, png, *_step_inputs(j.bwt_length, n, seed=n + 2 * biased))
    assert bad.any() and not bad.all()  # some ranges outgrew the pair window


@pytest.mark.parametrize("n", NS)
def test_table_carried_across_from_jax(indexes, tables, n):
    _, j, _ = indexes
    jng, png = tables[(n, True)]
    carried = convert.ngram_index_from_numpy(
        np.asarray(jng.packed), np.asarray(jng.cn), n=jng.n, biased=jng.biased, device="cpu"
    )
    assert carried.packed.numpy().tobytes() == png.packed.numpy().tobytes()
    assert carried.cn.numpy().tobytes() == png.cn.numpy().tobytes()
    _compare_steps(jng, carried, *_step_inputs(j.bwt_length, n, seed=11))
    with pytest.raises(ValueError):
        convert.ngram_index_from_numpy(
            np.asarray(jng.packed), np.asarray(jng.cn), n=5 - n, biased=True, device="cpu"
        )


def test_pair_mask_and_word_value_match_jax():
    local = np.array([0, 1, 7, 8, 31, 32, 255, 256, 300, 511])
    np.testing.assert_array_equal(
        pngram._pair_mask(torch.from_numpy(local)).numpy(),
        np.asarray(jngram._pair_mask(jnp.asarray(local.astype(np.int32)))),
    )
    lett = [np.array([0, 1, 2, 3, 3]), np.array([3, 2, 1, 0, 3]), np.array([1, 1, 0, 2, 3])]
    np.testing.assert_array_equal(
        pngram._word_value([torch.from_numpy(x) for x in lett]).numpy(),
        np.asarray(jngram._word_value([jnp.asarray(x.astype(np.int32)) for x in lett])),
    )


# ---------------------------------------------------------------------------
# Engines
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kmer_len", [4, 5, 9, 12, 13])
@pytest.mark.parametrize("n", NS)
def test_engine_matches_jax(indexes, engines, n, kmer_len):
    seq, _, _ = indexes
    je, pe = engines[n]
    rng = np.random.default_rng(100 * n + kmer_len)
    qs = [seq[s : s + kmer_len] for s in rng.integers(0, len(seq) - kmer_len, 60)]
    qs += [random_kmer(rng, kmer_len, DNA) for _ in range(40)]
    np.testing.assert_array_equal(pe.find_ranges(qs), je.find_ranges(qs))
    counts = pe.count(qs)
    np.testing.assert_array_equal(counts, je.count(qs))
    assert_locates_equal(pe.locate(qs), je.locate(qs))
    for q, c in zip(qs[::10], counts[::10]):
        assert c == count_occurrences(seq, q, DNA), q


@pytest.mark.parametrize("n", NS)
def test_engine_takes_ngram_path(engines, monkeypatch, n):
    """count and locate of a uniform clean batch come through
    ngram_ranges (K4's wrapper); other batches do not."""
    _, pe = engines[n]
    calls = []
    real = psearch.ngram_ranges
    monkeypatch.setattr(
        psearch, "ngram_ranges", lambda *a: calls.append(a[-1]) or real(*a)
    )
    rng = np.random.default_rng(n)
    qs = [random_kmer(rng, 9, DNA) for _ in range(30)]
    pe.count(qs)
    pe.locate(qs)
    assert calls == [9, 9]
    pe.count([b"ACGT", b"ACGTAC"])  # mixed lengths
    pe.count([b"ACG", b"TTT"])  # exactly the seed length
    assert calls == [9, 9]


@pytest.mark.parametrize(
    "kmers",
    [
        [b"ACGT", b"ACGTAC", b"GATTACA"],  # mixed lengths
        [b"ACGNT", b"ACGNT", b"ACGNT"],  # ambiguity letters
        [b"ACGNTAC", b"ACGTTAC"],  # one ambiguous among clean ones
        [b"ACGT", b"TTTT"],  # exactly the seed length: pure seed lookup
    ],
    ids=["mixed", "ambiguous", "one-ambiguous", "seed-length"],
)
def test_fallbacks_match_jax(kmers):
    rng = np.random.default_rng(0xFB)
    seq = random_sequence(rng, 800, DNA)
    j, p = build_both(seq, 4, 4, DNA)
    je = jx.NgramSearchEngine(j, n=3)
    pe = pt.NgramSearchEngine(p, 3, device="cpu")
    single = pt.SearchEngine(p, device="cpu")
    np.testing.assert_array_equal(pe.count(kmers), je.count(kmers))
    np.testing.assert_array_equal(pe.count(kmers), single.count(kmers))
    np.testing.assert_array_equal(pe.find_ranges(kmers), je.find_ranges(kmers))
    assert_locates_equal(pe.locate(kmers), je.locate(kmers))


def test_digram_alias_and_rejections():
    rng = np.random.default_rng(0xD6)
    seq = random_sequence(rng, 500, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    eng = pt.DigramSearchEngine(p, device="cpu")
    assert eng.ng.n == 2 and eng.ng.biased
    assert eng.count([b"GATTACA"])[0] == count_occurrences(seq, b"GATTACA", DNA)
    assert eng.count([b"GATTACA"])[0] == jx.DigramSearchEngine(j).count([b"GATTACA"])[0]
    with pytest.raises(ValueError):
        pt.NgramSearchEngine(p, 4, device="cpu")
    with pytest.raises(TypeError):
        pt.NgramSearchEngine(p.to_device("cpu"), 2, device="cpu")
    aseq = random_sequence(rng, 200, jx.AlphabetType.AMINO)
    _, ap = build_both(aseq, 4, 2, jx.AlphabetType.AMINO)
    with pytest.raises(NotImplementedError):
        pt.NgramSearchEngine(ap, 2, device="cpu")


@pytest.mark.parametrize("n", NS)
def test_overflow_corpus(n):
    """A long run of 'A': seeded ranges span ~4,000 positions, so the
    n-gram steps take the two-row branch mid-extension."""
    rng = np.random.default_rng(7)
    seq = b"A" * 4000 + random_sequence(rng, 6000, DNA, clean=True)
    j, p = build_both(seq, 8, 6, DNA)
    je, pe = jx.NgramSearchEngine(j, n=n), pt.NgramSearchEngine(p, n, device="cpu")
    qs = [b"A" * 40] + [seq[s : s + 40] for s in rng.integers(3950, 4000, 63)]
    ranges = pe.find_ranges(qs)
    np.testing.assert_array_equal(ranges, je.find_ranges(qs))
    assert int(ranges[0, 1] - ranges[0, 0]) + 1 > 512
    np.testing.assert_array_equal(pe.count(qs), je.count(qs))
    assert_locates_equal(pe.locate(qs), je.locate(qs))
    mat, _, _ = pe.encode_kmers(qs)
    s, e = psearch.ngram_ranges_plain(pe.dev, pe.ng, torch.from_numpy(mat), 40)
    assert int(psearch.range_counts(s, e)[0]) == count_occurrences(seq, b"A" * 40, DNA)


# ---------------------------------------------------------------------------
# Row cache
# ---------------------------------------------------------------------------

def test_cache_round_trip_both_ways(tmp_path):
    rng = np.random.default_rng(0xCA)
    seq = random_sequence(rng, 700, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    jpath, ppath = str(tmp_path / "j.npz"), str(tmp_path / "p.npz")
    jfresh = jngram.build_ngram_device(j, 2, bias_cn=True, cache_path=jpath)
    pfresh = pngram.build_ngram_device(p, 2, device="cpu", bias_cn=True, cache_path=ppath)
    # a JAX file loads in the port, a port file in the JAX package
    from_j = pngram.build_ngram_device(p, 2, device="cpu", bias_cn=True, cache_path=jpath)
    from_p = jngram.build_ngram_device(j, 2, bias_cn=True, cache_path=ppath)
    for got in (from_j.packed.numpy(), pfresh.packed.numpy(), np.asarray(from_p.packed)):
        assert got.tobytes() == np.asarray(jfresh.packed).tobytes()
    assert from_j.cn.numpy().tobytes() == np.asarray(jfresh.cn).tobytes()
    assert from_j.biased and from_p.biased
    with np.load(jpath) as zj, np.load(ppath) as zp:
        assert sorted(zj.files) == sorted(zp.files)
        for key in zj.files:
            assert zj[key].dtype == zp[key].dtype and zj[key].tobytes() == zp[key].tobytes(), key


def test_cache_mismatch_is_rebuilt(tmp_path):
    rng = np.random.default_rng(0xCB)
    seq = random_sequence(rng, 700, DNA)
    _, p = build_both(seq, 4, 3, DNA)
    path = str(tmp_path / "ng.npz")
    fresh = pngram.build_ngram_device(p, 2, device="cpu", cache_path=path)
    # the flipped bias flag must not serve the stale file
    other = pngram.build_ngram_device(p, 2, device="cpu", bias_cn=False, cache_path=path)
    assert not other.biased
    assert other.packed.numpy().tobytes() != fresh.packed.numpy().tobytes()
    # an n=2 file must not be served to an n=3 build
    tri = pngram.build_ngram_device(p, 3, device="cpu", cache_path=path)
    assert tri.n == 3 and tri.packed.shape[1] == pngram._geometry_pair(3)[4]
    # nor a file built from a different corpus (bwt_length differs)
    _, p2 = build_both(random_sequence(rng, 900, DNA), 4, 3, DNA)
    stale = pngram.build_ngram_device(p2, 3, device="cpu", cache_path=path)
    want = pngram.build_ngram_device(p2, 3, device="cpu")
    assert stale.packed.numpy().tobytes() == want.packed.numpy().tobytes()
    with np.load(path) as z:
        assert int(z["bwt_length"]) == p2.bwt_length and int(z["n"]) == 3

"""Port parity: the window classes of a backward step.

K2 and K4 pick, per step, one of three ways to read a row, from
``delta = end - 256 * floor((start - 1) / 256)``: the first block's
sectors (delta < 256), the whole 512-position pair window (delta < 512),
or two rows. The plain torch statement of the first class
(``ngram_backward_step_first_block``, ``backward_step_first_block``)
must equal the JAX one-row steps on every range of that class and must
not depend on any byte outside the sectors it names; the plain K2 / K4
steps, which choose among the three as the kernels do, must equal the
JAX exact steps on ranges built to sit on the class edges and the JAX
engines on a corpus that takes all three; and the per-class step count
that feeds ``chip_smoke.py``'s bounds must equal a brute-force count.
Exact: tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.ops import ngram as jngram
from avxwindowfmindex_tpu.ops import rank as jrank
from avxwindowfmindex_tpu_torch import search as psearch
from avxwindowfmindex_tpu_torch.ops import ngram as pngram
from avxwindowfmindex_tpu_torch.ops import rank as prank

from oracle import random_sequence
from torch_helpers import build_both

DNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.AMINO
NS = [2, 3]
BIAS = pytest.mark.parametrize("biased", [True, False], ids=["biased", "unbiased"])


def _u32(x):
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _delta(start, end):
    pos_s = (start - 1) & 0xFFFFFFFF
    return (end - (pos_s & ~0xFF)) & 0xFFFFFFFF


def _random_ranges(rng, n_positions, b=600):
    """Ranges of width 1..400 anywhere, so all three classes and both
    sides of every edge turn up; plus start == 0 and an invalid range."""
    start = rng.integers(0, n_positions - 1, size=b)
    end = np.minimum(start + rng.integers(0, 400, size=b), n_positions - 1)
    return np.concatenate([start, [0, 0, 9]]), np.concatenate([end, [0, 200, 3]])


def _edge_ranges(n_positions):
    """(start, end) with (start - 1) % 256 = o and delta = d for the pairs
    below, in two blocks: the edges of each class, width 1 and 2 at the
    last position of a block, start == 0 (start - 1 wraps and the gather
    clamps), and an invalid range of delta 0."""
    cases = [(0, 1), (100, 255), (100, 256), (200, 511), (200, 512), (200, 513),
             (255, 256), (255, 257), (254, 255), (254, 256), (0, 255), (0, 256)]
    start, end = [], []
    for blk in (1, 3):
        for o, d in cases:
            start.append(256 * blk + o + 1)
            end.append(256 * blk + d)
    start += [0, 0, 0, 256 * 2 + 1]
    end += [0, 255, 300, 256 * 2]  # the last: delta 0, start > end
    start, end = np.array(start), np.array(end)
    assert end.max() < n_positions
    return start, end


@pytest.fixture(scope="module")
def dna():
    """(JAX FmIndex, port FmIndex) of one 3,000-base DNA text, k = 3."""
    rng = np.random.default_rng(0x5EC7)
    return build_both(random_sequence(rng, 3000, DNA), 4, 3, DNA)


@pytest.fixture(scope="module")
def tables(dna):
    j, p = dna
    return {
        (n, b): (jngram.build_ngram_device(j, n, bias_cn=b),
                 pngram.build_ngram_device(p, n, device="cpu", bias_cn=b))
        for n in NS for b in (True, False)
    }


# ---------------------------------------------------------------------------
# the first-block step
# ---------------------------------------------------------------------------

@BIAS
@pytest.mark.parametrize("n", NS)
def test_ngram_first_block_step_equals_jax_pair_step(dna, tables, n, biased):
    j, _ = dna
    jng, png = tables[(n, biased)]
    rng = np.random.default_rng(10 * n + biased)
    s1, e1 = _random_ranges(rng, j.bwt_length)
    s2, e2 = _edge_ranges(j.bwt_length)
    start, end = np.concatenate([s1, s2]), np.concatenate([e1, e2])
    letters = [rng.integers(0, 4, size=len(start)).astype(np.int32) for _ in range(n)]
    ws, we, _ = jngram.ngram_backward_step_pair(
        jng, jnp.asarray(_u32(start)), jnp.asarray(_u32(end)),
        [jnp.asarray(x) for x in letters], jnp.zeros(len(start), bool),
    )
    gs, ge, first = pngram.ngram_backward_step_first_block(
        png, _t(start), _t(end), [torch.from_numpy(x) for x in letters]
    )
    want_first = (_delta(start, end) < 256) & (start <= end)
    np.testing.assert_array_equal(first.numpy(), want_first)
    assert 50 < want_first.sum() < len(start) - 50  # both sides exercised
    np.testing.assert_array_equal(gs.numpy()[want_first], np.asarray(ws).astype(np.int64)[want_first])
    np.testing.assert_array_equal(ge.numpy()[want_first], np.asarray(we).astype(np.int64)[want_first])
    # every other row keeps its range
    np.testing.assert_array_equal(gs.numpy()[~want_first], start[~want_first])
    np.testing.assert_array_equal(ge.numpy()[~want_first], end[~want_first])


@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
def test_rank_first_block_step_equals_jax_pair_step(alphabet):
    rng = np.random.default_rng(0xB10C + int(alphabet))
    j, p = build_both(random_sequence(rng, 2600, alphabet), 4, 2, alphabet)
    jd, pd = j.to_device(), p.to_device("cpu")
    s1, e1 = _random_ranges(rng, j.bwt_length)
    s2, e2 = _edge_ranges(j.bwt_length)
    start, end = np.concatenate([s1, s2]), np.concatenate([e1, e2])
    b = len(start)
    letters = rng.integers(0, jd.cardinality + 2, size=b).astype(np.int32)
    active = rng.integers(0, 4, size=b) > 0
    ws, we, _ = jrank.backward_step_pair(
        jd, jnp.asarray(_u32(start)), jnp.asarray(_u32(end)), jnp.asarray(letters),
        jnp.zeros(b, bool), jnp.asarray(active),
    )
    gs, ge, first = prank.backward_step_first_block(
        pd, _t(start), _t(end), torch.from_numpy(letters), torch.from_numpy(active)
    )
    want_first = (_delta(start, end) < 256) & (start <= end) & active
    np.testing.assert_array_equal(first.numpy(), want_first)
    assert 50 < want_first.sum() < b - 50
    # the JAX step leaves inactive and invalid rows as they are, as this one does
    keep = want_first | ~active | (start > end)
    np.testing.assert_array_equal(gs.numpy()[keep], np.asarray(ws).astype(np.int64)[keep])
    np.testing.assert_array_equal(ge.numpy()[keep], np.asarray(we).astype(np.int64)[keep])


def _scramble_outside(table, keep_cols, rng):
    """A copy of a uint8 table with every byte outside keep_cols replaced."""
    noise = torch.from_numpy(rng.integers(0, 256, size=tuple(table.shape), dtype=np.uint8))
    out = noise.clone()
    out[:, keep_cols] = table[:, keep_cols]
    assert not torch.equal(out, table)
    return out


@pytest.mark.parametrize("n", NS)
def test_ngram_first_block_step_reads_only_its_sectors(dna, tables, n):
    """Bytes [64 p, 64 p + 32) of each plane and the word's milestone: any
    other byte of the table may change and the step gives the same."""
    import dataclasses

    j, _ = dna
    _, png = tables[(n, True)]
    n_words, _, n_planes, ms_offset, _ = pngram._geometry_pair(n)
    keep = [64 * p + i for p in range(n_planes) for i in range(32)]
    keep += list(range(ms_offset, ms_offset + 4 * n_words))
    rng = np.random.default_rng(n)
    other = dataclasses.replace(png, packed=_scramble_outside(png.packed, keep, rng))
    start, end = _random_ranges(rng, j.bwt_length)
    letters = [torch.from_numpy(rng.integers(0, 4, size=len(start))) for _ in range(n)]
    want = pngram.ngram_backward_step_first_block(png, _t(start), _t(end), letters)
    got = pngram.ngram_backward_step_first_block(other, _t(start), _t(end), letters)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and want[2].any()
    # the whole-window step does read the second halves
    bad = torch.zeros(len(start), dtype=torch.bool)
    full = pngram.ngram_backward_step_pair(png, _t(start), _t(end), letters, bad)
    full_other = pngram.ngram_backward_step_pair(other, _t(start), _t(end), letters, bad)
    assert not torch.equal(full[1], full_other[1])


def test_rank_first_block_step_reads_only_its_sectors(dna):
    import dataclasses

    j, p = dna
    pd = p.to_device("cpu")
    keep = [64 * pl + i for pl in range(pd.n_planes) for i in range(32)]
    ms = pd.pair_milestone_offset
    keep += list(range(ms, ms + 4 * (pd.cardinality + 1)))
    rng = np.random.default_rng(21)
    other = dataclasses.replace(pd, packed_pair=_scramble_outside(pd.packed_pair, keep, rng))
    start, end = _random_ranges(rng, j.bwt_length)
    letters = torch.from_numpy(rng.integers(0, pd.cardinality + 1, size=len(start)))
    want = prank.backward_step_first_block(pd, _t(start), _t(end), letters)
    got = prank.backward_step_first_block(other, _t(start), _t(end), letters)
    assert all(torch.equal(a, b) for a, b in zip(got, want)) and want[2].any()


# ---------------------------------------------------------------------------
# the class edges through the plain K2 / K4 steps
# ---------------------------------------------------------------------------

def test_edge_ranges_sit_on_the_class_edges(dna):
    start, end = _edge_ranges(dna[0].bwt_length)
    d = _delta(start, end)
    for want in (1, 255, 256, 257, 511, 512, 513, 0):
        assert (d == want).any(), want
    at_last = ((start - 1) & 255) == 255
    assert set((end - start + 1)[at_last & (start > 0)]) >= {1, 2}
    assert (start == 0).sum() == 3 and (start > end).sum() == 1
    counts = prank.window_classes(_t(start), _t(end), _t(start) <= _t(end))
    assert counts.tolist() == [int(((d < 256) & (start <= end)).sum()),
                               int(((d >= 256) & (d < 512) & (start <= end)).sum()),
                               int(((d >= 512) & (start <= end)).sum())]
    assert all(c > 0 for c in counts.tolist())


@BIAS
@pytest.mark.parametrize("n", NS)
def test_ngram_step_on_class_edges_equals_jax_exact_step(dna, tables, n, biased):
    """Against the step the JAX engine takes: the one-row step, and the
    exact two-row step where that one flags the range. At start == 0
    (which no search produces: C[0] = 1) the two differ, and the engine's
    is the one-row answer."""
    j, _ = dna
    jng, png = tables[(n, biased)]
    start, end = _edge_ranges(j.bwt_length)
    rng = np.random.default_rng(n)
    for _ in range(3):
        letters = [rng.integers(0, 4, size=len(start)).astype(np.int32) for _ in range(n)]
        js, je, jl = jnp.asarray(_u32(start)), jnp.asarray(_u32(end)), [jnp.asarray(x) for x in letters]
        ws, we, flag = jngram.ngram_backward_step_pair(jng, js, je, jl, jnp.zeros(len(start), bool))
        xs, xe = jngram.ngram_backward_step(jng, js, je, jl)
        ws, we = jnp.where(flag, xs, ws), jnp.where(flag, xe, we)
        # away from start == 0 that is the exact step itself
        real = start > 0
        np.testing.assert_array_equal(np.asarray(ws)[real], np.asarray(xs)[real])
        np.testing.assert_array_equal(np.asarray(we)[real], np.asarray(xe)[real])
        gs, ge = psearch._ngram_step_exact(
            png, _t(start), _t(end), [torch.from_numpy(x) for x in letters]
        )
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we).astype(np.int64))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
def test_step_on_class_edges_equals_jax_exact_step(alphabet, wide):
    rng = np.random.default_rng(0xED6E + int(alphabet))
    j, p = build_both(random_sequence(rng, 2600, alphabet), 4, 2, alphabet)
    jd, pd = j.to_device(), p.to_device("cpu", wide=wide)
    start, end = _edge_ranges(j.bwt_length)
    for lett in range(jd.cardinality + 1):
        letters = np.full(len(start), lett, dtype=np.int32)
        js, je, jl = jnp.asarray(_u32(start)), jnp.asarray(_u32(end)), jnp.asarray(letters)
        ws, we, flag = jrank.backward_step_pair(jd, js, je, jl, jnp.zeros(len(start), bool))
        xs, xe = jrank.backward_step(jd, js, je, jl)
        ws, we = jnp.where(flag, xs, ws), jnp.where(flag, xe, we)
        real = start > 0
        np.testing.assert_array_equal(np.asarray(ws)[real], np.asarray(xs)[real])
        np.testing.assert_array_equal(np.asarray(we)[real], np.asarray(xe)[real])
        gs, ge = psearch._step_exact(pd, _t(start), _t(end), torch.from_numpy(letters), None)
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws).astype(np.int64), err_msg=str(lett))
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we).astype(np.int64), err_msg=str(lett))


# ---------------------------------------------------------------------------
# a corpus whose steps take all three classes, and the class count
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def runs_corpus():
    """Runs of one letter (700 A, 300 C, 420 G) inside random text, seed
    k = 6, and a uniform batch of 41-mers: the runs' own windows, windows
    across their ends, and random windows."""
    rng = np.random.default_rng(0xC1A5)
    parts = [random_sequence(rng, 2500, DNA, clean=True), b"A" * 700,
             random_sequence(rng, 2500, DNA, clean=True), b"C" * 300,
             random_sequence(rng, 1500, DNA, clean=True), b"G" * 420,
             random_sequence(rng, 2000, DNA, clean=True)]
    seq = b"".join(parts)
    j, p = build_both(seq, 8, 6, DNA)
    klen = 41
    starts = np.concatenate([
        [2500, 5700, 7500],  # inside each run
        rng.integers(2500 + 700 - klen, 2500 + 700, 20), rng.integers(5700 + 300 - klen, 5700 + 300, 20),
        rng.integers(7500 + 420 - klen, 7500 + 420, 20), rng.integers(0, len(seq) - klen, 65),
    ])
    qs = [seq[s : s + klen] for s in starts]
    return seq, j, p, qs, klen


@pytest.mark.parametrize("n", NS)
def test_runs_corpus_takes_all_classes_and_equals_jax(runs_corpus, n):
    _, j, p, qs, klen = runs_corpus
    je, pe = jx.NgramSearchEngine(j, n=n), pt.NgramSearchEngine(p, n, device="cpu")
    want = je.find_ranges(qs)
    mat, _, nq = pe.encode_kmers(qs)
    classes = psearch.new_step_classes("cpu")
    s, e = psearch.ngram_ranges_plain(pe.dev, pe.ng, torch.from_numpy(mat), klen, classes)
    got = np.stack([s.numpy()[:nq], e.numpy()[:nq]], axis=1)
    np.testing.assert_array_equal(got.astype(np.uint64), want.astype(np.uint64))
    assert all(c > 0 for c in classes["ngram_pair"].tolist()), classes
    assert classes["pair"].sum() > 0  # 35 = 17 * 2 + 1 = 11 * 3 + 2: a tail either way
    np.testing.assert_array_equal(pe.count(qs), je.count(qs))


def test_runs_corpus_single_steps_take_all_classes_and_equal_jax(runs_corpus):
    _, j, p, qs, _ = runs_corpus
    je, pe = jx.SearchEngine(j), pt.SearchEngine(p, device="cpu")
    qs = qs + [q[:9] for q in qs[:40]] + [b"A" * L for L in range(7, 30)]
    want = je.find_ranges(qs)
    mat, lengths, nq = pe.encode_kmers(qs)
    seeded = pe._seed_eligibility(mat, lengths)
    classes = torch.zeros(3, dtype=torch.int64)
    s, e = psearch.ranges_plain(pe.dev, torch.from_numpy(mat), torch.from_numpy(lengths),
                                torch.from_numpy(seeded), classes)
    got = np.stack([s.numpy()[:nq], e.numpy()[:nq]], axis=1)
    np.testing.assert_array_equal(got.astype(np.uint64), want.astype(np.uint64))
    assert all(c > 0 for c in classes.tolist()), classes


@pytest.mark.parametrize("n", NS)
def test_step_classes_equal_a_brute_force_count(runs_corpus, n):
    """The class counts of ngram_ranges_plain against one made query by
    query with Python integers over the JAX package's exact steps."""
    _, j, p, qs, klen = runs_corpus
    pe = pt.NgramSearchEngine(p, n, device="cpu")
    jng = jngram.build_ngram_device(j, n, bias_cn=True)
    jd = j.to_device()
    mat, _, nq = pe.encode_kmers(qs)
    classes = psearch.new_step_classes("cpu")
    # the batch is padded to a power of two with rows the engine drops;
    # count the real rows only
    psearch.ngram_ranges_plain(pe.dev, pe.ng, torch.from_numpy(mat[:nq]), klen, classes)

    def cls(start, end):
        d = (end - ((start - 1) % 2**32 & ~0xFF)) % 2**32
        return 0 if d < 256 else (1 if d < 512 else 2)

    k = 6
    m = klen - k
    seed = np.asarray(jd.seed_table)
    want = {"ngram_pair": [0, 0, 0], "pair": [0, 0, 0]}
    for row in mat[:nq]:
        idx = 0
        for c in row[klen - k : klen]:
            idx = idx * 4 + int(c)
        start, end = int(seed[idx, 0]), int(seed[idx, 1])
        for t in range(m // n):
            if start > end:
                break
            want["ngram_pair"][cls(start, end)] += 1
            cols = [m - n * (t + 1) + i for i in range(n)]
            s, e = jngram.ngram_backward_step(
                jng, jnp.asarray(_u32([start])), jnp.asarray(_u32([end])),
                [jnp.asarray(np.array([row[c]], np.int32)) for c in cols],
            )
            start, end = int(s[0]), int(e[0])
        for c in range(m % n - 1, -1, -1):
            if start > end:
                break
            want["pair"][cls(start, end)] += 1
            s, e = jrank.backward_step(
                jd, jnp.asarray(_u32([start])), jnp.asarray(_u32([end])),
                jnp.asarray(np.array([row[c]], np.int32)),
            )
            start, end = int(s[0]), int(e[0])
    assert {t: c.tolist() for t, c in classes.items()} == want
    assert sum(want["ngram_pair"]) > 0 and sum(want["pair"]) > 0


def test_window_classes_wide_reads_u64_unsigned():
    # a u64 delta of 2^63 and more is a wide range, not a negative one
    start = torch.tensor([1, 1, 1, 2**40 + 1])
    end = torch.tensor([0x7FFFFFFFFFFFFFFF, -5, 200, 2**40 + 300])
    keep = torch.ones(4, dtype=torch.bool)
    assert prank.window_classes(start, end, keep, -1).tolist() == [1, 1, 2]

"""Port parity: views without pair rows against the JAX package's
``AWFM_PAIR_ROWS=0``.

The port asks for such a view with a keyword (``to_device(device,
pair_rows=False)``, ``pair_rows=False`` on the engines, ``create_index``
and ``load_artifact``) and reads no environment variable; the JAX side gets
``AWFM_PAIR_ROWS=0`` through ``monkeypatch.setenv``, as its own tests do,
and runs its CPU path. A narrow view keeps its block rows and no pair
table; a wide amino view the compact 384 B rows; a wide nucleotide view
its pair-fused rows. On the CPU every step is the plain block-row step
(the first-block class from the block row, wider ranges from two block
rows), the version the kernels' block-row and compact forms are held to
on the card. Inputs come from numpy seeds; every quantity is an integer:
tolerance 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu import search64 as jsearch64
from avxwindowfmindex_tpu.ops import rank as jrank
from avxwindowfmindex_tpu.ops import rank64 as r64
from avxwindowfmindex_tpu_torch import search as psearch
from avxwindowfmindex_tpu_torch.io import artifact as partifact
from avxwindowfmindex_tpu_torch.models import convert
from avxwindowfmindex_tpu_torch.models import index as pindex
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.ops import ngram as pngram
from avxwindowfmindex_tpu_torch.ops import rank as prank
from avxwindowfmindex_tpu_torch.parallel import api as papi
from avxwindowfmindex_tpu_torch.parallel import dist as pdist
from avxwindowfmindex_tpu_torch.parallel.range_sharded import RangeShardedSearchEngine
from avxwindowfmindex_tpu_torch.tools import kernel_ab

from oracle import random_kmer, random_sequence
from torch_helpers import DEVICE_FIELDS, assert_locates_equal, build_both

DNA, RNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.RNA, jx.AlphabetType.AMINO
CASES = [(DNA, 3000, 4), (RNA, 2600, 4), (AMINO, 2500, 2)]


def _ids(c):
    return c[0].name


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def built(request):
    """(alphabet, sequence, JAX FmIndex, port FmIndex) of one text."""
    alphabet, n, k = request.param
    seq = random_sequence(np.random.default_rng(0x9A1 + n), n, alphabet)
    j, p = build_both(seq, 4, k, alphabet)
    return alphabet, seq, j, p


@pytest.fixture
def jax_pairless(monkeypatch):
    """The JAX package's view without pair rows: ``AWFM_PAIR_ROWS=0``
    (read when its view is built and when it steps), its cached view
    dropped after the test, as its own tests do."""
    monkeypatch.setenv("AWFM_PAIR_ROWS", "0")
    made = []
    yield made
    for j in made:
        j._device_cache = None


def _queries(rng, seq: bytes, alphabet, n: int = 90):
    """Sampled windows of 1-14 letters (seeded and unseeded), random
    k-mers, and windows ending in an ambiguity letter."""
    amb = b"X" if alphabet == AMINO else b"n"
    qs = [seq[s : s + int(L)] for s, L in zip(rng.integers(0, len(seq) - 15, n),
                                             rng.integers(1, 15, n))]
    qs += [random_kmer(rng, int(rng.integers(2, 10)), alphabet) for _ in range(30)]
    qs += [seq[s : s + 7] + amb for s in rng.integers(0, len(seq) - 8, 10)]
    return qs


def _jax_view(j, jax_pairless, wide=False):
    jax_pairless.append(j)
    return j.to_device(refresh=True, wide=wide)


# ---------------------------------------------------------------------------
# the views and their bytes
# ---------------------------------------------------------------------------

def test_view_bytes_equal_jax(built, jax_pairless):
    """``to_device(pair_rows=False)`` holds the JAX view's bytes: the block
    rows and no pair table."""
    alphabet, _, j, p = built
    jdev = _jax_view(j, jax_pairless)
    pdev = p.to_device("cpu", pair_rows=False)
    assert jdev.packed_pair is None and pdev.packed_pair is None and not pdev.pair_rows
    for f in DEVICE_FIELDS:
        want = getattr(jdev, f)
        got = getattr(pdev, f)
        if want is None:
            assert got is None, f
        else:
            assert got.numpy().tobytes() == np.asarray(want).tobytes(), f


@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
def test_wide_view_bytes_equal_jax(alphabet, jax_pairless):
    """Wide, without pair rows: the compact 384 B rows for amino, the
    pair-fused 256 B rows for nucleotides, as the JAX view keeps them."""
    seq = random_sequence(np.random.default_rng(0x9A2), 2500, alphabet)
    j, p = build_both(seq, 4, 2, alphabet)
    jdev = _jax_view(j, jax_pairless, wide=True)
    pdev = p.to_device("cpu", wide=True, pair_rows=False)
    assert pdev.wide and pdev.pair_fused == jdev.pair_fused == (alphabet != AMINO)
    assert pdev.packed.shape[1] == (384 if alphabet == AMINO else 256)
    assert (pdev.packed_pair is pdev.packed) if pdev.pair_fused else pdev.packed_pair is None
    assert pdev.packed.numpy().tobytes() == np.asarray(jdev.packed).tobytes()
    want = r64.pack_device_blocks64(j.bwt_letters, j.milestones(), j.alphabet,
                                    pair=alphabet != AMINO)
    assert pdev.packed.numpy().tobytes() == np.asarray(want).tobytes()


@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
def test_converters_take_views_without_pair_rows(alphabet, jax_pairless):
    """``device_index_from_numpy`` takes ``packed_pair=None`` and
    ``wide_device_index_from_numpy(pair_fused=False)`` the compact view:
    both give the port's own views byte for byte, and search like the JAX
    engines over them."""
    rng = np.random.default_rng(0x9A3)
    seq = random_sequence(rng, 2500, alphabet)
    j, p = build_both(seq, 4, 2, alphabet)
    kw = dict(bwt_length=j.bwt_length, ratio=4, k=2, alphabet=int(alphabet), device="cpu")
    jdev = _jax_view(j, jax_pairless)
    arrays = {f: None if getattr(jdev, f) is None else np.asarray(getattr(jdev, f))
              for f in DEVICE_FIELDS}
    narrow = convert.device_index_from_numpy(arrays, **kw)
    own = p.to_device("cpu", pair_rows=False)
    assert narrow.packed_pair is None and not narrow.pair_rows
    for f in DEVICE_FIELDS:
        a, b = getattr(narrow, f), getattr(own, f)
        assert (a is None and b is None) or a.numpy().tobytes() == b.numpy().tobytes(), f
    kmers = _queries(rng, seq, alphabet)
    want = jx.SearchEngine(j).count(kmers)
    np.testing.assert_array_equal(pt.SearchEngine(narrow, device="cpu").count(kmers), want)

    j64 = _jax_view(j, jax_pairless, wide=True)
    wide_arrays = {f: None if getattr(j64, f) is None else np.asarray(getattr(j64, f))
                   for f in ("packed", "prefix_hi", "prefix_lo", "seed_table", "sampled_sa",
                             "code_masks", "vec_to_index")}
    wide = convert.wide_device_index_from_numpy(wide_arrays, pair_fused=j64.pair_fused, **kw)
    own = p.to_device("cpu", wide=True, pair_rows=False)
    assert wide.pair_fused == own.pair_fused and wide.pair_rows == own.pair_rows
    assert (wide.packed_pair is None) == (own.packed_pair is None)
    for f in ("packed", "prefix_sums", "seed_table", "sampled_sa", "code_masks", "vec_to_index"):
        assert getattr(wide, f).numpy().tobytes() == getattr(own, f).numpy().tobytes(), f
    np.testing.assert_array_equal(pt.SearchEngine(wide, device="cpu").count(kmers), want)


# ---------------------------------------------------------------------------
# the engines
# ---------------------------------------------------------------------------

def test_count_locate_equal_jax(built, jax_pairless):
    """``SearchEngine(pair_rows=False)``: counts, ranges and locates equal
    the JAX engine's under AWFM_PAIR_ROWS=0 and the port's with pair rows."""
    alphabet, seq, j, p = built
    rng = np.random.default_rng(0x9A4)
    kmers = _queries(rng, seq, alphabet)
    _jax_view(j, jax_pairless)
    jeng = jx.SearchEngine(j)
    with_pair = pt.SearchEngine(p, device="cpu")
    eng = pt.SearchEngine(p, device="cpu", pair_rows=False)
    assert eng.dev.packed_pair is None and jeng.dev.packed_pair is None
    want = jeng.count(kmers)
    np.testing.assert_array_equal(eng.count(kmers), want)
    np.testing.assert_array_equal(eng.find_ranges(kmers), jeng.find_ranges(kmers))
    np.testing.assert_array_equal(eng.find_ranges(kmers), with_pair.find_ranges(kmers))
    assert_locates_equal(eng.locate(kmers[:60]), jeng.locate(kmers[:60]))


@pytest.mark.parametrize("n,kmer_len", [(2, 8), (2, 9), (3, 7), (3, 8)],
                         ids=["n2-tail1", "n2-tail0", "n3-tail1", "n3-tail2"])
def test_ngram_engines_equal_jax(n, kmer_len, jax_pairless):
    """``DigramSearchEngine`` / ``NgramSearchEngine(pair_rows=False)``:
    uniform batches through the n-gram steps and a tail of m mod n
    single steps over block rows (seed k = 3, m = kmer_len - 3), and a
    mixed batch through the single-step fallback, equal to the JAX
    n-gram engine under AWFM_PAIR_ROWS=0."""
    rng = np.random.default_rng(0x9A5 + kmer_len)
    seq = random_sequence(rng, 3000, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    _jax_view(j, jax_pairless)
    jeng = jx.NgramSearchEngine(j, n=n)
    eng = (pt.DigramSearchEngine(p, device="cpu", pair_rows=False) if n == 2
           else pt.NgramSearchEngine(p, n, device="cpu", pair_rows=False))
    assert eng.dev.packed_pair is None and eng.ng.n == n
    uniform = [seq[s : s + kmer_len] for s in rng.integers(0, len(seq) - kmer_len, 80)]
    uniform += [b"A" * kmer_len, b"ACGT" * 2 + b"A" * (kmer_len - 8)]
    uniform += [random_kmer(rng, kmer_len, DNA) for _ in range(20)]
    for kmers in (uniform, uniform[:40] + [b"ACG", b"GATTACA"]):
        np.testing.assert_array_equal(eng.count(kmers), jeng.count(kmers))
        np.testing.assert_array_equal(eng.find_ranges(kmers), jeng.find_ranges(kmers))
        assert_locates_equal(eng.locate(kmers), jeng.locate(kmers))


def test_wide_compact_engine_equal_jax(monkeypatch):
    """The JAX package's ``test_wide_compact_layout_opt_out`` setup: an
    amino index as a wide view on compact rows, the engine's counts and
    locates equal to the JAX wide engine's and to the narrow engine's."""
    monkeypatch.setenv("AWFM_PAIR_ROWS", "0")
    rng = np.random.default_rng(0x9A6)
    seq = random_sequence(rng, 3000, AMINO)
    j, p = build_both(seq, 4, 3, AMINO)
    jnarrow = jx.SearchEngine(j)
    jdev = j.to_device(refresh=True, wide=True)
    assert not jdev.pair_fused and jdev.packed.shape[1] == 384
    jwide = jx.SearchEngine(jdev)
    jwide.host_index = j
    eng = pt.SearchEngine(p, device="cpu", wide=True, pair_rows=False)
    assert eng.wide and not eng.dev.pair_fused and eng.dev.packed.shape[1] == 384
    kmers = [random_kmer(rng, int(rng.integers(2, 10)), AMINO) for _ in range(100)]
    kmers += [seq[s : s + 9] for s in rng.integers(0, len(seq) - 9, 60)]
    want = jwide.count(kmers)
    np.testing.assert_array_equal(want, jnarrow.count(kmers))
    np.testing.assert_array_equal(eng.count(kmers), want)
    assert_locates_equal(eng.locate(kmers[:30] + kmers[100:130]),
                         jwide.locate(kmers[:30] + kmers[100:130]))
    j._device_cache = None


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide-compact"])
def test_single_query_api(wide, jax_pairless):
    """The single-query API on a view without pair rows (``pair_rows=False``
    passed through) equals the JAX functions, and leaves that view
    installed."""
    rng = np.random.default_rng(0x9A7)
    seq = random_sequence(rng, 2500, AMINO)
    j, p = build_both(seq, 4, 2, AMINO)
    _jax_view(j, jax_pairless)
    kw = dict(device="cpu", wide=wide, pair_rows=False)
    for _ in range(40):
        s, e = sorted(int(x) for x in rng.integers(0, j.bwt_length, 2))
        lett = int(rng.integers(0, 21))
        assert pt.iterative_step_backward_search(p, s, e, lett, **kw) == \
            jx.iterative_step_backward_search(j, s, e, lett)
    # start == 0: start - 1 wraps
    assert pt.iterative_step_backward_search(p, 0, 40, 3, **kw) == \
        jx.iterative_step_backward_search(j, 0, 40, 3)
    for pos in [0, 1, 255, 256, j.bwt_length - 1] + [int(x) for x in rng.integers(0, j.bwt_length, 30)]:
        assert pt.backtrace_return_previous_letter_index(p, pos, **kw) == \
            jx.backtrace_return_previous_letter_index(j, pos)
    for q in [seq[s : s + 6] for s in rng.integers(0, len(seq) - 6, 10)] + [b"WWWWWW"]:
        assert pt.find_search_range_for_string(p, q, **kw) == jx.find_search_range_for_string(j, q)
        assert pt.single_kmer_exists(p, q, **kw) == jx.single_kmer_exists(j, q)
    s, e = jx.find_search_range_for_string(j, seq[100:105])
    np.testing.assert_array_equal(pt.find_database_hit_positions(p, s, e, **kw),
                                  jx.find_database_hit_positions(j, s, e))
    assert pt.find_database_hit_position_single(p, s, **kw) == \
        jx.find_database_hit_position_single(j, s)
    view = p.to_device("cpu", wide=wide, pair_rows=False)
    assert not view.pair_rows and view.wide == wide


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide-compact"])
def test_single_query_api_keeps_the_installed_layout(wide, jax_pairless):
    """A view without pair rows that the caller installed survives the
    single-query calls and an engine made without the keyword: none
    packs the pair rows or replaces the view, and the answers equal the
    JAX functions'."""
    rng = np.random.default_rng(0x9B0)
    seq = random_sequence(rng, 2500, AMINO)
    j, p = build_both(seq, 4, 2, AMINO)
    _jax_view(j, jax_pairless)
    view = p.to_device("cpu", wide=wide, pair_rows=False)

    def refuse(*_a, **_k):
        raise AssertionError("pair rows packed for a view without them")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pindex, "pack_pair_rows_from_blocks", refuse)
        kw = dict(device="cpu", wide=wide)
        s, e = jx.find_search_range_for_string(j, seq[200:205])
        assert pt.iterative_step_backward_search(p, 0, 40, 3, **kw) == \
            jx.iterative_step_backward_search(j, 0, 40, 3)
        assert pt.backtrace_return_previous_letter_index(p, 300, **kw) == \
            jx.backtrace_return_previous_letter_index(j, 300)
        assert pt.find_search_range_for_string(p, seq[200:205], **kw) == (s, e)
        np.testing.assert_array_equal(pt.find_database_hit_positions(p, s, e, **kw),
                                      jx.find_database_hit_positions(j, s, e))
        assert pt.SearchEngine(p, **kw).dev is view
    assert p.to_device("cpu", wide=wide) is view and not view.pair_rows


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide-compact"])
def test_densify_keeps_the_layout(wide, jax_pairless):
    """``densify_device_sa`` over a view without pair rows keeps it: no
    pair table (the compact rows when wide), and the dense samples and
    locates of the JAX package's densify."""
    rng = np.random.default_rng(0x9A8)
    seq = random_sequence(rng, 3000, AMINO)
    j, p = build_both(seq, 8, 2, AMINO)
    _jax_view(j, jax_pairless, wide=wide)
    jdense = j.densify_device_sa(2, wide=wide)
    view = p.to_device("cpu", wide=wide, pair_rows=False)
    dense = p.densify_device_sa(2, device="cpu")
    assert dense.ratio == 2 and dense.packed is view.packed and not dense.pair_rows
    assert p.to_device("cpu", wide=wide, pair_rows=False) is dense
    sa = np.asarray(jdense.sampled_sa)
    if wide:
        sa = (sa[:, 1].astype(np.uint64) << np.uint64(32)) | sa[:, 0].astype(np.uint64)
    np.testing.assert_array_equal(dense.numpy_u64(dense.sampled_sa), sa.astype(np.uint64))
    kmers = [seq[s : s + 5] for s in rng.integers(0, len(seq) - 5, 40)]
    want = jx.SearchEngine(j).locate(kmers) if not wide else None
    got = pt.SearchEngine(p, device="cpu", wide=wide, pair_rows=False).locate(kmers)
    if want is not None:
        assert_locates_equal(got, want)
    assert_locates_equal(got, pt.SearchEngine(view, device="cpu").locate(kmers))


@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
def test_artifact_loads_without_pair_rows(alphabet, tmp_path, monkeypatch, jax_pairless):
    """A ``.awfmx`` without its seed table, loaded with ``pair_rows=False``:
    the BFS rebuilds the table over the view without pair rows, which
    stays installed, and no pair row is ever packed."""
    rng = np.random.default_rng(0x9A9)
    seq = random_sequence(rng, 2500, alphabet)
    j, p = build_both(seq, 4, 3, alphabet)
    p.kmer_seed_table = None  # the state an index built on the card is in
    path = str(tmp_path / "idx.awfmx")
    partifact.save_artifact(p, path)

    def refuse(*_a, **_k):
        raise AssertionError("pair rows packed for a view without them")

    monkeypatch.setattr(pindex, "pack_pair_rows_from_blocks", refuse)
    q = pt.load_artifact(path, device="cpu", pair_rows=False)
    view = q.to_device("cpu", pair_rows=False)
    assert view.packed_pair is None
    np.testing.assert_array_equal(q.seed_table_host(), j.kmer_seed_table)
    _jax_view(j, jax_pairless)
    kmers = _queries(rng, seq, alphabet)
    eng = pt.SearchEngine(q, device="cpu", pair_rows=False)
    assert eng.dev is view
    np.testing.assert_array_equal(eng.count(kmers), jx.SearchEngine(j).count(kmers))


def test_create_index_never_packs_pair_rows(tmp_path, monkeypatch):
    """``create_index`` and ``create_index_from_fasta`` with
    ``pair_rows=False`` build the seed table on the view without pair
    rows and pack none; the tables equal the JAX build's."""
    rng = np.random.default_rng(0x9AA)
    seq = random_sequence(rng, 2000, DNA)
    jcfg = jx.IndexConfiguration(4, 4, DNA)
    want = jx.create_index(seq, jcfg)

    def refuse(*_a, **_k):
        raise AssertionError("pair rows packed for a view without them")

    monkeypatch.setattr(pindex, "pack_pair_rows_from_blocks", refuse)
    pcfg = pt.IndexConfiguration(4, 4, pt.AlphabetType.DNA)
    p = pt.create_index(seq, pcfg, device="cpu", pair_rows=False)
    assert p.to_device("cpu", pair_rows=False).packed_pair is None
    np.testing.assert_array_equal(p.seed_table_host(), want.kmer_seed_table)
    fasta = tmp_path / "x.fa"
    fasta.write_bytes(b">a\n" + seq[:1000] + b"\n>b\n" + seq[1000:] + b"\n")
    f = pt.create_index_from_fasta(str(fasta), pcfg, device="cpu", pair_rows=False)
    jf = jx.create_index_from_fasta(str(fasta), jcfg)
    np.testing.assert_array_equal(f.seed_table_host(), jf.kmer_seed_table)
    assert f.to_device("cpu", pair_rows=False).packed_pair is None


def test_distributed_engine_over_a_view_without_pair_rows(jax_pairless):
    """``DistributedSearchEngine`` takes a view without pair rows as it is:
    every replica has none, and the answers equal the JAX engine's."""
    rng = np.random.default_rng(0x9AB)
    seq = random_sequence(rng, 3000, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    view = p.to_device("cpu", pair_rows=False)
    eng = pdist.DistributedSearchEngine(view, ["cpu"] * 3)
    assert eng.dev is view and all(r.packed_pair is None for r in eng.replicas)
    _jax_view(j, jax_pairless)
    jeng = jx.SearchEngine(j)
    kmers = _queries(rng, seq, DNA)
    np.testing.assert_array_equal(eng.count(kmers), jeng.count(kmers))
    assert_locates_equal(eng.locate(kmers[:50]), jeng.locate(kmers[:50]))


@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
@pytest.mark.parametrize("pair_rows", [False, True], ids=["block-rows", "pair-rows"])
def test_window_classes_over_block_rows(pair_rows, alphabet, jax_pairless, monkeypatch):
    """Runs of one letter in random text: the plain step takes each of the
    three window classes (first block, over the block row in either
    layout; the 256-512 class, over the pair row where the view has one,
    else over two block rows; wider, over two block rows), and the ranges
    equal the JAX engine's in the same layout (``AWFM_PAIR_ROWS=0`` for a
    view without pair rows)."""
    rng = np.random.default_rng(0x9AC if alphabet == DNA else 0x9AD)

    def rand(n):
        return random_sequence(rng, n, alphabet, clean=True).upper()

    text = rand(1500) + b"A" * 700 + rand(1500) + b"C" * 300 + rand(900) + b"G" * 420 + rand(900)
    j, p = build_both(text, 8, 6 if alphabet == DNA else 3, alphabet)
    view = p.to_device("cpu", pair_rows=pair_rows)
    assert (view.packed_pair is not None) == pair_rows
    runs = ((1500, 700), (3700, 300), (4900, 420))
    qs = [text[lo : lo + L] for lo, _ in runs for L in range(7, 40, 2)]
    qs += [text[s : s + 25] for lo, ln in runs for s in rng.integers(lo + ln - 25, lo + ln, 10)]
    qs += [text[s : s + 14] for s in rng.integers(0, len(text) - 14, 60)]
    eng = pt.SearchEngine(view, device="cpu")
    mat, lengths, _ = eng.encode_kmers(qs)
    seeded = eng._seed_eligibility(mat, lengths)
    classes = torch.zeros(3, dtype=torch.int64)
    s, e = psearch.ranges_plain(view, torch.from_numpy(mat), torch.from_numpy(lengths),
                                torch.from_numpy(seeded), classes)
    assert min(classes.tolist()) >= 1, classes.tolist()
    if pair_rows:
        monkeypatch.delenv("AWFM_PAIR_ROWS")
    _jax_view(j, jax_pairless)
    want = jx.SearchEngine(j).find_ranges(qs)
    got = torch.stack([s, e], dim=1)[: len(qs)].numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide-compact"])
def test_start_zero_wraps(wide, jax_pairless):
    """The u32 (u64) edge rules of the block-row step: ``start - 1`` at
    ``start == 0`` wraps and its row clamps (the last row), as the JAX
    classic step gives; the first-block class reads the block row and the
    two-row class equals the plain classic step."""
    rng = np.random.default_rng(0x9AD)
    seq = random_sequence(rng, 3000, AMINO)
    j, p = build_both(seq, 4, 2, AMINO)
    view = p.to_device("cpu", wide=wide, pair_rows=False)
    jdev = _jax_view(j, jax_pairless, wide=wide)
    n = j.bwt_length
    start = np.array([0, 0, 0, 0, 1, 256, 300, n - 1, 5, 0, 5], dtype=np.uint64)
    end = np.array([0, 40, 255, 700, 0, 511, 299, n - 1, 3000, n - 1, 40], dtype=np.uint64)
    letters = np.arange(len(start)) % 21
    s, e = psearch._step_exact(view, torch.from_numpy(start.view(np.int64)),
                               torch.from_numpy(end.view(np.int64)), torch.from_numpy(letters),
                               None)
    if wide:
        sh, sl = r64.split_u64_host(start)
        eh, el = r64.split_u64_host(end)
        wsh, wsl, weh, wel = r64.backward_step64(jdev, jnp.asarray(sh), jnp.asarray(sl),
                                                 jnp.asarray(eh), jnp.asarray(el),
                                                 jnp.asarray(letters.astype(np.int32)))
        ws = (np.asarray(wsh).astype(np.uint64) << np.uint64(32)) | np.asarray(wsl)
        we = (np.asarray(weh).astype(np.uint64) << np.uint64(32)) | np.asarray(wel)
    else:
        ws, we = jrank.backward_step(jdev, jnp.asarray(start.astype(np.uint32)),
                                     jnp.asarray(end.astype(np.uint32)),
                                     jnp.asarray(letters.astype(np.int32)))
    mask = view.pos_mask
    np.testing.assert_array_equal((s & mask).numpy().astype(np.uint64) if not wide
                                  else s.numpy().view(np.uint64), np.asarray(ws).astype(np.uint64))
    np.testing.assert_array_equal((e & mask).numpy().astype(np.uint64) if not wide
                                  else e.numpy().view(np.uint64), np.asarray(we).astype(np.uint64))
    fs, fe, first = prank.backward_step_first_block(view, torch.from_numpy(start.view(np.int64)),
                                                    torch.from_numpy(end.view(np.int64)),
                                                    torch.from_numpy(letters))
    # start - 1 wraps to the top of the last block: end + 256 from its
    # start, so a range from 0 is never first-block; (5, 40) is
    delta = prank.window_delta(torch.from_numpy(start.view(np.int64)),
                               torch.from_numpy(end.view(np.int64)), mask)
    assert delta[:3].tolist() == [256, 296, 511] and not first[:4].any() and bool(first[10])


# ---------------------------------------------------------------------------
# the view cache, the engine cache and the layout guards
# ---------------------------------------------------------------------------

def test_view_cache_keys_the_layout():
    """``to_device`` returns the cached view only with the layout asked
    for; a rebuild at the same width carries the same seed-table tensor;
    a wide nucleotide view is the same with or without ``pair_rows``."""
    seq = random_sequence(np.random.default_rng(0x9AE), 2000, DNA)
    _, p = build_both(seq, 4, 3, DNA)
    pair = p.to_device("cpu")
    p.kmer_seed_table = None  # the table lives in the view, as one built on the card
    block = p.to_device("cpu", pair_rows=False)
    assert block is not pair and block.packed_pair is None
    assert block.seed_table is pair.seed_table
    assert p.to_device("cpu", pair_rows=False) is block
    assert p.to_device("cpu") is block  # no layout named: the installed one
    again = p.to_device("cpu", pair_rows=True)
    assert again is not block and again.packed_pair is not None
    assert p.to_device("cpu") is again
    wide = p.to_device("cpu", wide=True)
    assert p.to_device("cpu", wide=True, pair_rows=False) is wide and wide.pair_rows


def test_engine_cache_serves_the_installed_layout(jax_pairless):
    """The batch API's engine cache serves a view without pair rows that
    the caller installed as it is, and one with them after the caller
    installs that."""
    rng = np.random.default_rng(0x9AF)
    seq = random_sequence(rng, 2500, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    kmers = _queries(rng, seq, DNA)
    view = p.to_device("cpu", pair_rows=False)
    eng = papi._engine_for(p, "cpu")
    assert eng.dev is view
    _jax_view(j, jax_pairless)
    want = jx.SearchEngine(j).count(kmers)
    np.testing.assert_array_equal(pt.parallel_search_count(p, kmers, device="cpu"), want)
    assert p.to_device("cpu", pair_rows=False) is view
    pair = p.to_device("cpu", pair_rows=True)
    assert papi._engine_for(p, "cpu").dev is pair and pair.packed_pair is not None
    np.testing.assert_array_equal(pt.parallel_search_count(p, kmers, device="cpu"), want)


def test_engines_check_a_device_index_layout():
    """A ``DeviceIndex`` brings its own layout: ``pair_rows`` that names
    another is refused, a shard of the range-sharded engine is no whole
    view, and the plain pair step refuses a view without pair rows."""
    seq = random_sequence(np.random.default_rng(0x9B0), 2000, AMINO)
    _, p = build_both(seq, 4, 2, AMINO)
    block = p.to_device("cpu", pair_rows=False)
    assert pt.SearchEngine(block, device="cpu", pair_rows=False).dev is block
    with pytest.raises(ValueError, match="layout"):
        pt.SearchEngine(block, device="cpu", pair_rows=True)
    shard = RangeShardedSearchEngine(p, ["cpu"] * 2).shards[0]
    assert shard.shard and not shard.pair_rows
    with pytest.raises(ValueError, match="shard"):
        pt.SearchEngine(shard, device="cpu")
    z = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="no pair rows"):
        prank.backward_step_pair(block, z, z, z, torch.zeros(4, dtype=torch.bool))


def test_kernel_forms_follow_the_layout():
    """The form each view takes, and the tables each form refuses: a
    shard never reaches K2 and a whole view never K1R; block rows are
    never read as pair rows; a wide view's one table is the pair-fused
    one or none. All refused before any build or launch."""
    rng = np.random.default_rng(0x9B1)
    seq = random_sequence(rng, 2000, AMINO)
    _, p = build_both(seq, 4, 2, AMINO)
    pair = p.to_device("cpu")
    block = p.to_device("cpu", pair_rows=False)
    wide = p.to_device("cpu", wide=True, pair_rows=True)
    compact = p.to_device("cpu", wide=True, pair_rows=False)
    shard = RangeShardedSearchEngine(p, ["cpu"] * 2).shards[0]
    k = kernels
    forms = {
        "pair": (pair, [k.K1, k.K2, k.K3, k.K1X, k.K4]),
        "block": (block, [k.K1, k.K2_BLOCK, k.K3, k.K1X, k.K4_BLOCK]),
        "wide": (wide, [k.K1W, k.K2W, k.K3W, k.K1WX]),  # K4 is narrow-only
        "compact": (compact, [k.K1W_COMPACT, k.K2W_COMPACT, k.K3W_COMPACT, k.K1WX_COMPACT]),
    }
    for name, (view, want) in forms.items():
        got = [k.form_of(view, x) for x in (k.K1, k.K2, k.K3, k.K1X, k.K4)]
        assert got[: len(want)] == want, name
    assert k.form_of(shard, k.K1R) is k.K1R and k.form_of(shard, k.K2) is k.K2
    k.reset_launch_counts()
    mat = torch.zeros((4, 8), dtype=torch.uint8)
    lengths = torch.full((4,), 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="shards"):
        k.k2_ranges(shard, mat, lengths, torch.ones(4, dtype=torch.uint8))
    pos = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="shards"):
        k.k1r_occurrence(block, 0, pos, None, None, 0, torch.zeros(4, dtype=torch.int32), pos, 4)
    with pytest.raises(ValueError, match="pair rows must be"):
        k.k2_ranges(dataclasses.replace(block, packed_pair=block.packed), mat, lengths,
                    torch.ones(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="one row table"):
        k.k2_ranges(dataclasses.replace(compact, packed_pair=compact.packed), mat, lengths,
                    torch.ones(4, dtype=torch.uint8))
    with pytest.raises(ValueError, match="rows must be 384"):
        k.k3_backtrace_resolve(dataclasses.replace(wide, packed_pair=None, pair_fused=False), pos)
    for view in (block, compact):
        with pytest.raises(ValueError, match="CUDA tensor"):
            k.k2_ranges(view, mat, lengths, torch.ones(4, dtype=torch.uint8))
    assert all(x.launches == 0 for x in k.KERNELS)


@pytest.mark.parametrize("form", ["k4-n2-41", "k4-n3-41", "k4-n2-29", "k4-n3-29", "k2w-compact",
                                  "k2-block-41", "k2-block-29"])
def test_phase_4p_corpora_reach_every_window_class(form, jax_pairless):
    """``chip_smoke.py`` phase 4p holds K4 over block rows (n = 2 and 3),
    K2w over compact rows and K2 over block rows to their plain versions on
    the corpora of ``pairless_corpora`` (K2: the batches of
    ``corpus_k2_batches``): here the plain versions' class counts show that
    those inputs take every window class of K4's n-gram steps, of its
    block-row tail, of K2w's compact steps and of K2's block-row steps, and
    the plain answers equal the JAX engines' under AWFM_PAIR_ROWS=0."""
    import chip_smoke

    text, k4_qs, klen, aa_text, aa_qs = chip_smoke.pairless_corpora()
    if form.startswith("k2-block"):
        j, p = build_both(text, 8, 6, DNA)
        view = p.to_device("cpu", pair_rows=False)
        length = int(form.split("-")[-1])
        v, qs = next(b for b in chip_smoke.corpus_k2_batches(view, k4_qs, klen).values()
                     if len(b[1][0]) == length)
        assert v is view and len(qs) == len(k4_qs) and {len(q) for q in qs} == {length}
        eng = pt.SearchEngine(view, device="cpu")
        mat, lengths, _ = eng.encode_kmers(qs)
        seeded = eng._seed_eligibility(mat, lengths)
        classes = torch.zeros(3, dtype=torch.int64)
        s, e = psearch.ranges_plain(view, torch.from_numpy(mat), torch.from_numpy(lengths),
                                    torch.from_numpy(seeded), classes)
        assert min(classes.tolist()) >= 1, classes.tolist()
        _jax_view(j, jax_pairless)
        want = jx.SearchEngine(j).find_ranges(qs)
    elif form.startswith("k4"):
        # the 41-mers and their last 29 letters (K4's letters from memory
        # and in registers)
        n, short = int(form.split("-")[1][1:]), chip_smoke.PAIRLESS_SHORT_LEN
        length = klen if form.endswith(str(klen)) else short
        qs = [q[-length:] for q in k4_qs]
        j, p = build_both(text, 8, 6, DNA)
        view = p.to_device("cpu", pair_rows=False)
        ng = pngram.build_ngram_device(p, n, device="cpu")
        mat = torch.from_numpy(pt.SearchEngine(view, device="cpu").encode_kmers(k4_qs)[0])
        if length == short:
            mat = kernel_ab.lengthwise_batch(mat, klen, short)[0]
            assert mat.shape[1] == 32
        classes = psearch.new_step_classes("cpu")
        s, e = psearch.ngram_ranges_plain(view, ng, mat, length, classes)
        for table in ("ngram_pair", "pair"):  # the n-gram steps, the block-row tail
            assert min(classes[table].tolist()) >= 1, (table, classes[table].tolist())
        _jax_view(j, jax_pairless)
        want = jx.NgramSearchEngine(j, n=n).find_ranges(qs)
    else:
        j, p = build_both(aa_text, 8, chip_smoke.PAIRLESS_AMINO_SEED_K, AMINO)
        view = p.to_device("cpu", wide=True, pair_rows=False)
        assert not view.pair_fused and view.packed.shape[1] == 384
        eng = pt.SearchEngine(view, device="cpu")
        mat, lengths, _ = eng.encode_kmers(aa_qs)
        seeded = eng._seed_eligibility(mat, lengths)
        classes = torch.zeros(3, dtype=torch.int64)
        s, e = psearch.ranges_plain(view, torch.from_numpy(mat), torch.from_numpy(lengths),
                                    torch.from_numpy(seeded), classes)
        assert min(classes.tolist()) >= 1, classes.tolist()
        jwide = jx.SearchEngine(_jax_view(j, jax_pairless, wide=True))
        jwide.host_index = j
        qs = aa_qs
        want = jwide.find_ranges(qs)
    got = torch.stack([s, e], dim=1)[: len(qs)].numpy().astype(np.uint64)
    np.testing.assert_array_equal(got, np.asarray(want).astype(np.uint64))


@pytest.mark.parametrize("output", ["resolve", "on-disk"])
def test_compact_backtrace_at_a_ratio_no_power_of_two_equals_jax(output, jax_pairless):
    """K3w's plain version over compact amino rows at SA ratio 6 (the
    grid's ``p % ratio``, no shift) gives the JAX wide backtrace's answers
    under AWFM_PAIR_ROWS=0, resolved and as (position, offset) pairs, on
    random positions, the sentinel's row, 0, bwtLength - 1 and every 37th
    position."""
    rng = np.random.default_rng(0x9B6)
    seq = random_sequence(rng, 3000, AMINO)
    j, p = build_both(seq, 6, 3, AMINO)
    view = p.to_device("cpu", wide=True, pair_rows=False)
    assert not view.pair_fused and view.packed.shape[1] == 384 and view.ratio == 6
    jdev = _jax_view(j, jax_pairless, wide=True)
    assert not jdev.pair_fused and jdev.packed.shape[1] == 384
    n = view.bwt_length
    sentinel_row = int(np.flatnonzero(p.bwt_letters == view.sentinel)[0])
    pos = np.concatenate([rng.integers(0, n, 600), [sentinel_row, 0, n - 1],
                          np.arange(0, n, 37)]).astype(np.uint64)
    hi, lo = r64.split_u64_host(pos)
    p_hi, p_lo, off = jsearch64.backtrace_all64(jdev, jnp.asarray(hi), jnp.asarray(lo))
    want_p = (np.asarray(p_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(p_lo).astype(np.uint64)
    want_off = np.asarray(off).astype(np.int64)
    assert int(want_off.max()) >= 5 and (want_p % 6 == 0).all()
    tpos = torch.from_numpy(pos.view(np.int64))
    if output == "on-disk":
        got_p, got_off = psearch.backtrace_resolve_plain(dataclasses.replace(view, sampled_sa=None),
                                                         tpos)
        np.testing.assert_array_equal(got_p.numpy().view(np.uint64), want_p)
        np.testing.assert_array_equal(got_off.numpy(), want_off)
    else:
        h_hi, h_lo = jsearch64._resolve_samples64(jdev, p_hi, p_lo, off)
        want = (np.asarray(h_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(h_lo).astype(np.uint64)
        got = psearch.backtrace_resolve_plain(view, tpos)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)

"""Port parity: the 64-bit-capacity path (positions >= 2^32).

Mirrors ``tests/test_index64.py`` against the JAX package's wide engine
(``ops/rank64.py``, ``search64.py``: u64 values as (hi, lo) u32 pairs)
with the same numpy-seeded inputs. The port carries u64 values in int64
tensors and runs one set of functions for both widths, so each case
holds three things equal: the port's wide view, the port's narrow view
and the JAX wide view. Every quantity is an integer: tolerance 0.

The wide view is forced on small indexes (``wide=True``); the carries
and the block-index rule are exercised on hand-made tables whose
milestones and positions straddle 2^32 and 2^63.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu import search64
from avxwindowfmindex_tpu.ops import rank64 as r64
from avxwindowfmindex_tpu_torch import search as psearch
from avxwindowfmindex_tpu_torch.models import alphabet as palpha
from avxwindowfmindex_tpu_torch.models import convert
from avxwindowfmindex_tpu_torch.models import index as pindex
from avxwindowfmindex_tpu_torch.ops import rank as prank
from avxwindowfmindex_tpu_torch.ops import seed_table as pseed

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both

DNA, RNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.RNA, jx.AlphabetType.AMINO
WIDE_FIELDS = ("packed", "prefix_hi", "prefix_lo", "seed_table", "sampled_sa",
               "code_masks", "vec_to_index")
ALPHABETS = [(DNA, 4, 3, 4000), (RNA, 8, 4, 3001), (AMINO, 8, 2, 2500)]


def _ids(c):
    return c[0].name


def _join(hi, lo) -> np.ndarray:
    """uint64 values of a JAX (hi, lo) u32 pair."""
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _split(values):
    """(hi, lo) jnp u32 arrays of uint64 values."""
    hi, lo = r64.split_u64_host(np.asarray(values, dtype=np.uint64))
    return jnp.asarray(hi), jnp.asarray(lo)


def _u64(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint64)


def _i64(values) -> torch.Tensor:
    return torch.from_numpy(np.asarray(values, dtype=np.uint64).view(np.int64).copy())


def jax_wide_arrays(jdev) -> dict:
    return {f: None if getattr(jdev, f) is None else np.asarray(getattr(jdev, f))
            for f in WIDE_FIELDS}


def assert_wide_tables_equal(pdev, arrays) -> None:
    """Every tensor of a wide port view holds the JAX DeviceIndex64's bytes."""
    assert pdev.wide and pdev.packed is pdev.packed_pair
    assert pdev.packed.numpy().tobytes() == arrays["packed"].tobytes()
    prefix = np.stack([arrays["prefix_lo"], arrays["prefix_hi"]], axis=1)
    assert pdev.prefix_sums.dtype == torch.int64
    assert pdev.prefix_sums.numpy().tobytes() == prefix.tobytes()
    assert pdev.seed_table.dtype == torch.int64
    assert pdev.seed_table.shape == (arrays["seed_table"].shape[0], 2)
    assert pdev.seed_table.numpy().tobytes() == arrays["seed_table"].tobytes()
    if arrays["sampled_sa"] is None:
        assert pdev.sampled_sa is None
    else:
        assert pdev.sampled_sa.dtype == torch.int64
        assert pdev.sampled_sa.shape == (arrays["sampled_sa"].shape[0],)
        assert pdev.sampled_sa.numpy().tobytes() == arrays["sampled_sa"].tobytes()
    assert pdev.code_masks.numpy().tobytes() == arrays["code_masks"].tobytes()
    assert pdev.vec_to_index.numpy().tobytes() == arrays["vec_to_index"].tobytes()


@pytest.fixture(scope="module", params=ALPHABETS, ids=_ids)
def both(request):
    alphabet, ratio, k, n = request.param
    rng = np.random.default_rng(0x64B + n)
    seq = random_sequence(rng, n, alphabet)
    j, p = build_both(seq, ratio, k, alphabet)
    jdev = j.to_device(refresh=True, wide=True)
    j._device_cache = None  # later users see the narrow default
    return j, p, jdev, seq


def _jax_wide_engine(j, jdev):
    eng = jx.SearchEngine(jdev)
    eng.host_index = j
    return eng


# ---------------------------------------------------------------------------
# the wide tables and the converter
# ---------------------------------------------------------------------------

def test_wide_tables_byte_equal(both):
    j, p, jdev, _ = both
    pdev = p.to_device("cpu", wide=True)
    assert_wide_tables_equal(pdev, jax_wide_arrays(jdev))
    assert pdev.packed.shape[1] == r64.device_row_bytes64(jdev.alphabet)
    assert pdev.packed.shape[1] == (512 if jdev.alphabet == AMINO else 256)
    assert (pdev.plane_stride, pdev.milestone_bytes) == (64, 8)
    assert pdev.milestone_offset == jdev.milestone_offset == pdev.pair_milestone_offset
    assert (pdev.bwt_length, pdev.ratio) == (jdev.bwt_length, jdev.ratio)


def test_pack_device_blocks64_equals_jax(both):
    j, p, jdev, _ = both
    want = r64.pack_device_blocks64(j.bwt_letters, j.milestones(), j.alphabet)
    got = pindex.pack_device_blocks64(p.bwt_letters, p.milestones(), p.alphabet)
    assert got.dtype == np.uint8 and got.tobytes() == want.tobytes()
    assert pindex.device_row_bytes64(p.alphabet) == r64.device_row_bytes64(j.alphabet)


def test_convert_wide_round_trip(both):
    j, p, jdev, seq = both
    arrays = jax_wide_arrays(jdev)
    dev = convert.wide_device_index_from_numpy(
        arrays, bwt_length=jdev.bwt_length, ratio=jdev.ratio,
        k=jdev.kmer_length_in_seed_table, alphabet=jdev.alphabet, device="cpu",
    )
    assert_wide_tables_equal(dev, arrays)
    own = p.to_device("cpu", wide=True)
    for f in ("packed", "prefix_sums", "seed_table", "sampled_sa", "code_masks", "vec_to_index"):
        assert getattr(dev, f).numpy().tobytes() == getattr(own, f).numpy().tobytes(), f
    # the converted view searches like the JAX wide engine
    rng = np.random.default_rng(3)
    kmers = [seq[s : s + int(rng.integers(2, 9))] for s in rng.integers(0, len(seq) - 9, 60)]
    jeng = _jax_wide_engine(j, jdev)
    peng = pt.SearchEngine(dev, device="cpu")
    assert peng.wide
    np.testing.assert_array_equal(peng.count(kmers), jeng.count(kmers))
    assert_locates_equal(peng.locate(kmers[:20]), jeng.locate(kmers[:20]))


def test_convert_refuses_the_compact_layout(both):
    """The compact layout is asked for by ``pair_fused=False`` and held to
    its row width: rows of another width are refused, the 512 B amino
    pair-fused rows among them (the compact view itself converts:
    tests/test_torch_pairless.py)."""
    j, p, jdev, _ = both
    arrays = jax_wide_arrays(jdev)
    kw = dict(bwt_length=jdev.bwt_length, ratio=jdev.ratio, k=jdev.kmer_length_in_seed_table,
              alphabet=jdev.alphabet, device="cpu")
    want = pindex.device_row_bytes64(pt.AlphabetType(int(jdev.alphabet)), pair=False)
    with pytest.raises(ValueError, match=f"wide rows must be \\(nb, {want}\\)"):
        convert.wide_device_index_from_numpy(dict(arrays, packed=arrays["packed"][:, :128]),
                                             pair_fused=False, **kw)
    if want != arrays["packed"].shape[1]:
        with pytest.raises(ValueError, match="wide rows must be"):
            convert.wide_device_index_from_numpy(arrays, pair_fused=False, **kw)
    with pytest.raises(ValueError, match="wide rows"):
        convert.wide_device_index_from_numpy(dict(arrays, packed=arrays["packed"][:, :128]), **kw)


# ---------------------------------------------------------------------------
# count / locate: wide = narrow = JAX wide
# ---------------------------------------------------------------------------

def test_wide_count_locate_equal_narrow_and_jax(both):
    j, p, jdev, seq = both
    alphabet = jdev.alphabet
    rng = np.random.default_rng(17)
    kmers = [random_kmer(rng, int(rng.integers(2, 12)), alphabet) for _ in range(150)]
    kmers += [seq[s : s + int(rng.integers(2, 14))] for s in rng.integers(0, len(seq) - 14, 50)]
    narrow = pt.SearchEngine(p, device="cpu")
    wide = pt.SearchEngine(p, device="cpu", wide=True)
    jwide = _jax_wide_engine(j, jdev)
    assert wide.wide and not narrow.wide and jwide.wide
    want = jwide.count(kmers)
    assert want.sum() > 0
    np.testing.assert_array_equal(wide.count(kmers), want)
    np.testing.assert_array_equal(narrow.count(kmers), want)
    got = wide.locate(kmers)
    assert got[0].dtype == np.uint64
    assert_locates_equal(got, jwide.locate(kmers))
    assert_locates_equal(got, narrow.locate(kmers))
    np.testing.assert_array_equal(wide.find_ranges(kmers), jwide.find_ranges(kmers))


def test_wide_unseeded_and_mixed_lengths():
    rng = np.random.default_rng(0xA3F1)
    seq = random_sequence(rng, 3000, DNA)
    j, p = build_both(seq, 4, 5, DNA)
    jwide = jx.SearchEngine(j.to_device(refresh=True, wide=True))
    # short kmers (unseeded), ambiguity in the last k letters, mixed lengths
    kmers = [b"AC", b"GATTACA", b"ACGTN", b"TT", b"ACGTACGTACGT", b"N", b"ACGNTACG"]
    want = jwide.count(kmers)
    j._device_cache = None
    np.testing.assert_array_equal(pt.SearchEngine(p, device="cpu", wide=True).count(kmers), want)
    np.testing.assert_array_equal(pt.SearchEngine(p, device="cpu").count(kmers), want)


@pytest.mark.parametrize("corpus", ["random", "two-letter"])
def test_wide_ranges_outgrow_the_pair_window(corpus):
    """A repeat-rich corpus keeps seeded ranges wider than the 512-position
    window: the step then reads two first-block halves, where the JAX wide
    engine flags the query and re-runs it."""
    rng = np.random.default_rng(0x51)
    seq = (random_sequence(rng, 4000, DNA) if corpus == "random"
           else bytes(rng.choice(np.frombuffer(b"AC", np.uint8), size=4000)))
    j, p = build_both(seq, 4, 3, DNA)
    jwide = _jax_wide_engine(j, j.to_device(refresh=True, wide=True))
    kmers = [random_kmer(rng, int(rng.integers(3, 12)), DNA) for _ in range(128)]
    kmers += [b"ACACACAC", b"AAAA", b"CCCCCC"]
    want_c, want_l = jwide.count(kmers), jwide.locate(kmers)
    j._device_cache = None
    wide = pt.SearchEngine(p, device="cpu", wide=True)
    np.testing.assert_array_equal(wide.count(kmers), want_c)
    assert_locates_equal(wide.locate(kmers), want_l)
    if corpus == "two-letter":
        assert wide.count([b"AC"])[0] > 512


def test_wide_resolve_positions_equal_jax(both):
    j, p, jdev, _ = both
    rng = np.random.default_rng(5)
    pos = rng.integers(0, jdev.bwt_length, size=300).astype(np.uint64)
    want = _jax_wide_engine(j, jdev).resolve_positions(pos)
    got = pt.SearchEngine(p, device="cpu", wide=True).resolve_positions(pos)
    assert got.dtype == np.uint64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(pt.SearchEngine(p, device="cpu").resolve_positions(pos), want)
    assert len(pt.SearchEngine(p, device="cpu", wide=True).resolve_positions(pos[:0])) == 0


def test_wide_backtrace_equals_jax_and_narrow(both):
    j, p, jdev, _ = both
    rng = np.random.default_rng(6)
    pos = rng.integers(0, jdev.bwt_length, size=512).astype(np.uint64)
    hi, lo = _split(pos)
    w_hi, w_lo, w_off = search64.backtrace_all64(jdev, hi, lo)
    disk = dataclasses.replace(p.to_device("cpu", wide=True), sampled_sa=None)
    gp, goff = psearch.backtrace_resolve_plain(disk, _i64(pos))
    np.testing.assert_array_equal(_u64(gp), _join(w_hi, w_lo))
    np.testing.assert_array_equal(goff.numpy(), np.asarray(w_off))
    h_hi, h_lo = search64._backtrace_resolve64(jdev, hi, lo)
    hits = psearch.backtrace_resolve(p.to_device("cpu", wide=True), _i64(pos))
    np.testing.assert_array_equal(_u64(hits), _join(h_hi, h_lo))
    narrow = psearch.backtrace_resolve(p.to_device("cpu", wide=False), _i64(pos))
    np.testing.assert_array_equal(hits.numpy(), narrow.numpy())


# the wide backtrace (K3w's plain version) at SA ratios 1 to 64, nucleotide
# and amino, on hits in range order (every row of some k-mers' ranges,
# query by query, as a locate enumerates them) and the same shuffled
BACKTRACE_CASES = [(a, r) for a in (DNA, AMINO) for r in (1, 3, 8, 64)]


@pytest.fixture(scope="module", params=BACKTRACE_CASES, ids=lambda c: f"{c[0].name}-ratio{c[1]}")
def wide_at_ratio(request):
    alphabet, ratio = request.param
    rng = np.random.default_rng(0xB7 + 1000 * int(alphabet) + ratio)
    n, k, kmer_len = (3000, 3, 4) if alphabet == DNA else (2500, 2, 2)
    seq = random_sequence(rng, n, alphabet)
    j, p = build_both(seq, ratio, k, alphabet)
    jdev = j.to_device(refresh=True, wide=True)
    j._device_cache = None
    kmers = [seq[s : s + kmer_len] for s in rng.integers(0, n - kmer_len, 60)]
    ranges = pt.SearchEngine(p, device="cpu").find_ranges(kmers)
    rows = np.concatenate([np.arange(s, e + 1) for s, e in ranges if s <= e]).astype(np.uint64)
    assert len(rows) > len(kmers)
    return ratio, jdev, p.to_device("cpu", wide=True), rows


@pytest.mark.parametrize("output", ["resolve", "on-disk"])
@pytest.mark.parametrize("order", ["range-order", "shuffled"])
def test_wide_backtrace_at_ratio_equals_jax(wide_at_ratio, order, output):
    ratio, jdev, pdev, rows = wide_at_ratio
    pos = rows if order == "range-order" else np.random.default_rng(ratio).permutation(rows)
    hi, lo = _split(pos)
    if output == "on-disk":
        w_hi, w_lo, w_off = search64.backtrace_all64(jdev, hi, lo)
        disk = dataclasses.replace(pdev, sampled_sa=None)
        got_p, got_off = psearch.backtrace_resolve_plain(disk, _i64(pos))
        np.testing.assert_array_equal(_u64(got_p), _join(w_hi, w_lo))
        np.testing.assert_array_equal(got_off.numpy(), np.asarray(w_off))
        assert (_u64(got_p) % np.uint64(ratio) == 0).all()
        if ratio > 1:
            assert int(got_off.max()) > 0
    else:
        h_hi, h_lo = search64._backtrace_resolve64(jdev, hi, lo)
        hits = psearch.backtrace_resolve_plain(pdev, _i64(pos))
        np.testing.assert_array_equal(_u64(hits), _join(h_hi, h_lo))
        assert int(hits.max()) < pdev.bwt_length


def test_wide_letter_and_lf_equal_jax(both):
    j, p, jdev, _ = both
    n = jdev.bwt_length
    pos = np.arange(n, dtype=np.uint64)  # every position: the sentinel is among them
    hi, lo = _split(pos)
    w_lett, w_hi, w_lo = r64.letter_and_lf_at64(jdev, hi, lo)
    pdev = p.to_device("cpu", wide=True)
    lett, lf = prank.letter_and_lf_at(pdev, _i64(pos))
    np.testing.assert_array_equal(lett.numpy(), np.asarray(w_lett))
    np.testing.assert_array_equal(_u64(lf), _join(w_hi, w_lo))
    assert (lett == pdev.sentinel).sum() == 1


def test_wide_on_disk_suffix_array(tmp_path):
    rng = np.random.default_rng(21)
    seq = random_sequence(rng, 3000, DNA)
    cfg = pt.IndexConfiguration(8, 3, pt.AlphabetType.DNA)
    path = str(tmp_path / "wide.awfmi")
    pt.create_index(seq, cfg, file_src=path, device="cpu")
    kmers = [seq[s : s + 7] for s in rng.integers(0, 2990, 40)]
    want = pt.SearchEngine(pt.read_index_from_file(path), device="cpu").locate(kmers)
    on_disk = pt.read_index_from_file(path, keep_suffix_array_in_memory=False)
    eng = pt.SearchEngine(on_disk, device="cpu", wide=True)
    assert eng.wide and eng.dev.sampled_sa is None
    assert_locates_equal(eng.locate(kmers), want)


# ---------------------------------------------------------------------------
# carries: milestones and prefix sums that straddle 2^32
# ---------------------------------------------------------------------------

def _synthetic(letters_blocks: np.ndarray, base: int, alphabet=DNA, ratio=8):
    """(JAX DeviceIndex64, port wide DeviceIndex, milestones, prefix sums)
    over hand-made letters: the true per-block cumulative counts offset by
    ``base`` per letter, and prefix sums spaced ``base // 2`` apart, as
    ``tests/test_index64.py:_synthetic_wide_dev`` makes them."""
    nb = letters_blocks.shape[0]
    card = palpha.cardinality(pt.AlphabetType(int(alphabet)))
    counts = np.stack(
        [(letters_blocks == j).sum(axis=1) for j in range(card + 2)], axis=1
    ).astype(np.uint64)
    cum = np.cumsum(counts, axis=0)
    ms = np.zeros_like(cum)
    ms[1:] = cum[:-1]
    ms += np.uint64(base)
    packed = r64.pack_device_blocks64(letters_blocks.reshape(-1), ms, alphabet)
    ps = np.arange(card + 2, dtype=np.uint64) * np.uint64(base // 2) + np.uint64(1)
    ps_hi, ps_lo = r64.split_u64_host(ps)
    jdev = r64.DeviceIndex64(
        packed=jnp.asarray(packed), prefix_hi=jnp.asarray(ps_hi), prefix_lo=jnp.asarray(ps_lo),
        seed_table=jnp.zeros((1, 4), dtype=jnp.uint32), sampled_sa=None, code_masks=None,
        vec_to_index=None, bwt_length=nb * 256, ratio=ratio, kmer_length_in_seed_table=3,
        alphabet=alphabet,
    )
    palphabet = pt.AlphabetType(int(alphabet))
    own = pindex.pack_device_blocks64(letters_blocks.reshape(-1), ms, palphabet)
    assert own.tobytes() == packed.tobytes()
    rows = torch.from_numpy(own)
    pdev = pt.DeviceIndex(
        packed=rows, packed_pair=rows, prefix_sums=pindex.u64_tensor(ps, "cpu"),
        seed_table=torch.zeros((1, 2), dtype=torch.int64), sampled_sa=None,
        code_masks=torch.from_numpy(pindex.device_code_masks(palphabet)),
        vec_to_index=torch.from_numpy(palpha.vector_to_index_lut(palphabet).astype(np.int32)),
        bwt_length=nb * 256, ratio=ratio, kmer_length_in_seed_table=3, alphabet=palphabet,
        wide=True,
    )
    return jdev, pdev, ms, ps


def _occ_oracle(flat, ms, p, l):
    b = int(p) // 256
    return ms[b, l] + np.uint64(np.count_nonzero(flat[b * 256 : int(p) + 1] == l))


@pytest.mark.parametrize("alphabet,n_letters", [(DNA, 6), (AMINO, 22)], ids=["DNA", "AMINO"])
def test_carry_rank_straddles_2_32(alphabet, n_letters):
    rng = np.random.default_rng(0xA3F1)
    nb = 16
    letters = rng.integers(0, n_letters, size=(nb, 256)).astype(np.uint8)
    jdev, pdev, ms, ps = _synthetic(letters, 2**32 - 100, alphabet)
    flat = letters.reshape(-1)
    positions = rng.integers(0, nb * 256, size=512, dtype=np.uint64)
    letts = rng.integers(0, n_letters - 1, size=512).astype(np.int32)
    got = _u64(prank.occurrence(pdev, _i64(positions), torch.from_numpy(letts)))
    want = np.array([_occ_oracle(flat, ms, p, l) for p, l in zip(positions, letts)], np.uint64)
    np.testing.assert_array_equal(got, want)
    assert (want < 2**32).any() and (want >= 2**32).any()
    hi, lo = _split(positions)
    np.testing.assert_array_equal(got, _join(*r64.occurrence64(jdev, hi, lo, jnp.asarray(letts))))


@pytest.mark.parametrize("check_valid", [True, False])
def test_carry_backward_step_straddles_2_32(check_valid):
    rng = np.random.default_rng(0xA3F2)
    nb = 16
    letters = rng.integers(0, 6, size=(nb, 256)).astype(np.uint8)
    jdev, pdev, ms, ps = _synthetic(letters, 2**32 - 100)
    flat = letters.reshape(-1)
    s0 = rng.integers(1, 2**33, size=64, dtype=np.uint64) % np.uint64(nb * 256 - 2) + np.uint64(1)
    e0 = np.minimum(s0 + rng.integers(0, 512, size=64, dtype=np.uint64), np.uint64(nb * 256 - 1))
    lt = rng.integers(0, 4, size=64).astype(np.int32)
    ns, ne = prank.backward_step(pdev, _i64(s0), _i64(e0), torch.from_numpy(lt),
                                 check_valid=check_valid)
    for i in range(64):
        c = ps[lt[i]]
        assert int(_u64(ns)[i]) == int(c + _occ_oracle(flat, ms, s0[i] - 1, lt[i])), i
        assert int(_u64(ne)[i]) == int(c + _occ_oracle(flat, ms, e0[i], lt[i]) - np.uint64(1)), i
    sh, sl = _split(s0)
    eh, el = _split(e0)
    w = r64.backward_step64(jdev, sh, sl, eh, el, jnp.asarray(lt), check_valid=check_valid)
    np.testing.assert_array_equal(_u64(ns), _join(w[0], w[1]))
    np.testing.assert_array_equal(_u64(ne), _join(w[2], w[3]))


def _garbage_ranges(rng, n, nb):
    """Ranges the seed-table BFS steps through and worse: start 0 (so
    start - 1 wraps to 2^64 - 1), start > end, block indices past the
    table, values with bit 31 of the block index set (a negative int32 in
    the JAX gather) and values above 2^63 (negative as int64)."""
    s = rng.integers(0, 2**63, size=n, dtype=np.uint64) * np.uint64(2) + rng.integers(
        0, 2, size=n, dtype=np.uint64)
    e = rng.integers(0, 2**63, size=n, dtype=np.uint64) * np.uint64(2)
    q = n // 8
    s[:q] = 0
    e[:q] = rng.integers(0, nb * 256, size=q, dtype=np.uint64)
    s[q : 2 * q] = rng.integers(0, nb * 256 + 600, size=q, dtype=np.uint64)
    e[q : 2 * q] = rng.integers(0, nb * 256 + 600, size=q, dtype=np.uint64)
    s[2 * q : 3 * q] = (np.uint64(1) << np.uint64(39)) + rng.integers(0, 4096, size=q, dtype=np.uint64)
    e[2 * q : 3 * q] = s[2 * q : 3 * q] + rng.integers(0, 700, size=q, dtype=np.uint64)
    s[3 * q : 4 * q] = np.uint64(2**64 - 1) - rng.integers(0, 600, size=q, dtype=np.uint64)
    e[3 * q : 4 * q] = rng.integers(0, 600, size=q, dtype=np.uint64)
    return s, e


@pytest.mark.parametrize("nb", [4, 16, 300])
def test_block_index_rule_equals_jax_gather(nb):
    """The wide block index: bits 8..39 of the position as int32, a
    negative value counted from the end of the table, then clamped, which
    is what ``dev.packed[blk]`` does in the JAX package."""
    rng = np.random.default_rng(nb)
    s, e = _garbage_ranges(rng, 512, nb)
    pos = np.concatenate([s, e, s - np.uint64(1)])
    table = jnp.asarray(np.arange(nb, dtype=np.int32))
    hi, lo = r64.split_u64_host(pos)
    blk = ((hi << np.uint32(24)) | (lo >> np.uint32(8))).astype(np.int32)
    want = np.asarray(table[jnp.asarray(blk)])
    got = prank.block_index(nb, _i64(pos), wide=True).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.min() == 0 and got.max() == nb - 1
    # start - 1 at start == 0 reads the last row, as the narrow rule does
    assert prank.block_index(nb, _i64([2**64 - 1]), wide=True)[0] == nb - 1
    assert prank.block_index(nb, torch.tensor([0xFFFFFFFF]), wide=False)[0] == nb - 1


@pytest.mark.parametrize("check_valid", [True, False])
def test_garbage_steps_equal_jax(check_valid):
    """Unconditional steps on ranges no search produces follow the JAX
    functions bit for bit: the wrap mod 2^64, the unsigned compares and
    the block-index rule."""
    rng = np.random.default_rng(0xBAD)
    nb = 16
    letters = rng.integers(0, 6, size=(nb, 256)).astype(np.uint8)
    jdev, pdev, _, _ = _synthetic(letters, 2**32 - 100)
    s, e = _garbage_ranges(rng, 512, nb)
    lt = rng.integers(0, 7, size=512).astype(np.int32)  # 5, 6: above the alphabet
    sh, sl = _split(s)
    eh, el = _split(e)
    w = r64.backward_step64(jdev, sh, sl, eh, el, jnp.asarray(lt), check_valid=check_valid)
    ns, ne = prank.backward_step(pdev, _i64(s), _i64(e), torch.from_numpy(lt),
                                 check_valid=check_valid)
    np.testing.assert_array_equal(_u64(ns), _join(w[0], w[1]))
    np.testing.assert_array_equal(_u64(ne), _join(w[2], w[3]))
    hi, lo = _split(s)
    got = prank.occurrence(pdev, _i64(s), torch.from_numpy(lt))
    np.testing.assert_array_equal(_u64(got), _join(*r64.occurrence64(jdev, hi, lo, jnp.asarray(lt))))


# ---------------------------------------------------------------------------
# the pair step against the two-row step
# ---------------------------------------------------------------------------

def test_pair_step_matches_classic_and_flags():
    rng = np.random.default_rng(0xA3F3)
    nb = 16
    letters = rng.integers(0, 6, size=(nb, 256)).astype(np.uint8)
    jdev, pdev, _, _ = _synthetic(letters, 2**32 - 100)
    s0 = rng.integers(1, nb * 256 - 600, size=256, dtype=np.uint64)
    e0 = s0 + rng.integers(0, 500, size=256, dtype=np.uint64)
    lt = rng.integers(0, 4, size=256).astype(np.int32)
    bad0 = torch.zeros(256, dtype=torch.bool)
    ps_, pe_, bad = prank.backward_step_pair(pdev, _i64(s0), _i64(e0), torch.from_numpy(lt), bad0)
    cs_, ce_ = prank.backward_step(pdev, _i64(s0), _i64(e0), torch.from_numpy(lt))
    ok = ~bad.numpy()
    assert ok.sum() > 200
    np.testing.assert_array_equal(ps_.numpy()[ok], cs_.numpy()[ok])
    np.testing.assert_array_equal(pe_.numpy()[ok], ce_.numpy()[ok])
    # the JAX pair step returns the same five arrays, flagged rows included
    sh, sl = _split(s0)
    eh, el = _split(e0)
    w = r64.backward_step64_pair(jdev, sh, sl, eh, el, jnp.asarray(lt), jnp.zeros(256, dtype=bool))
    np.testing.assert_array_equal(_u64(ps_), _join(w[0], w[1]))
    np.testing.assert_array_equal(_u64(pe_), _join(w[2], w[3]))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(w[4]))
    # ranges that span past block b + 1 are flagged; the exact step takes
    # the two-row branch for them
    s1 = np.full(8, 257, dtype=np.uint64)
    e1 = s1 + np.uint64(600)
    z = torch.zeros(8, dtype=torch.int64)
    *_, bad1 = prank.backward_step_pair(pdev, _i64(s1), _i64(e1), z, torch.zeros(8, dtype=torch.bool))
    assert bool(bad1.all())
    xs, xe = psearch._step_exact(pdev, _i64(s1), _i64(e1), z, None)
    cs1, ce1 = prank.backward_step(pdev, _i64(s1), _i64(e1), z)
    assert torch.equal(xs, cs1) and torch.equal(xe, ce1)


def test_pair_step_overflow_flag_u64_oracle():
    """The window test is e - ((s - 1) & ~255) >= 512 in u64, also where
    the window straddles 2^32 or the values pass 2^63."""
    rng = np.random.default_rng(0xA3F4)
    letters = rng.integers(0, 6, size=(4, 256)).astype(np.uint8)
    jdev, pdev, _, _ = _synthetic(letters, 0)
    s = rng.integers(1, 2**63, size=1024, dtype=np.uint64)
    width = np.where(
        rng.random(1024) < 0.5,
        rng.integers(0, 1000, size=1024, dtype=np.uint64),
        rng.integers(0, 2**40, size=1024, dtype=np.uint64),
    )
    s[:64] = np.uint64(2**32) - rng.integers(1, 300, size=64, dtype=np.uint64)
    width[:64] = rng.integers(0, 600, size=64, dtype=np.uint64)
    s[64:128] = np.uint64(2**63) - rng.integers(1, 300, size=64, dtype=np.uint64)
    width[64:128] = rng.integers(0, 600, size=64, dtype=np.uint64)
    e = s + width
    want = (e - ((s - np.uint64(1)) & ~np.uint64(0xFF))) >= np.uint64(512)
    z = torch.zeros(1024, dtype=torch.int64)
    ns, ne, bad = prank.backward_step_pair(pdev, _i64(s), _i64(e), z,
                                           torch.zeros(1024, dtype=torch.bool))
    np.testing.assert_array_equal(bad.numpy(), want)
    sh, sl = _split(s)
    eh, el = _split(e)
    w = r64.backward_step64_pair(jdev, sh, sl, eh, el, jnp.zeros(1024, dtype=jnp.int32),
                                 jnp.zeros(1024, dtype=bool))
    np.testing.assert_array_equal(bad.numpy(), np.asarray(w[4]))
    np.testing.assert_array_equal(_u64(ns), _join(w[0], w[1]))
    np.testing.assert_array_equal(_u64(ne), _join(w[2], w[3]))


# ---------------------------------------------------------------------------
# seed table, dense SA, cache
# ---------------------------------------------------------------------------

def test_wide_seed_table_widened_and_bfs_agree():
    rng = np.random.default_rng(0xA3F5)
    seq = random_sequence(rng, 3000, DNA)
    j, p = build_both(seq, 4, 4, DNA)
    p.kmer_seed_table = None
    p._device_cache = None
    pt.build.attach_seed_table(p, "cpu")  # the table now lives in the narrow view only
    narrow = p.to_device("cpu")
    wide = p.to_device("cpu", wide=True)  # widened: zero high words, no second BFS
    assert wide.seed_table.dtype == torch.int64 and wide.seed_table.shape == (256, 2)
    np.testing.assert_array_equal(wide.seed_table.numpy(), pindex.widen_u32(narrow.seed_table).numpy())
    bfs = pseed.build_seed_table(wide, 4, 4, p.prefix_sums)
    chunked = pseed.build_seed_table(wide, 4, 4, p.prefix_sums, chunk=16)
    assert torch.equal(wide.seed_table, bfs) and torch.equal(bfs, chunked)
    jdev = j.to_device(refresh=True, wide=True)
    want = np.asarray(search64.build_seed_table_device64(jdev, 4, 4, j.prefix_sums))
    j._device_cache = None
    assert bfs.numpy().tobytes() == want.tobytes()
    np.testing.assert_array_equal(p.seed_table_host(), j.kmer_seed_table)


@pytest.mark.parametrize("alphabet,k", [(DNA, 3), (AMINO, 2)], ids=["DNA", "AMINO"])
def test_create_index_wide_route(monkeypatch, alphabet, k):
    """create_index on a view that comes out wide builds the seed table by
    the wide BFS: same host table, same answers."""
    rng = np.random.default_rng(0xA3F6)
    seq = random_sequence(rng, 3000, alphabet)
    cfg = pt.IndexConfiguration(4, k, pt.AlphabetType(int(alphabet)))
    want = pt.create_index(seq, cfg, device="cpu")
    orig = pt.FmIndex.to_device
    monkeypatch.setattr(pt.FmIndex, "to_device",
                        lambda self, device, wide=None, **kw: orig(self, device, wide=True, **kw))
    index = pt.create_index(seq, cfg, device="cpu")
    assert index.to_device("cpu").wide
    np.testing.assert_array_equal(index.seed_table_host(), want.seed_table_host())
    kmers = [random_kmer(rng, int(rng.integers(2, 10)), alphabet) for _ in range(80)]
    eng = pt.SearchEngine(index, device="cpu")
    assert eng.wide
    monkeypatch.undo()
    np.testing.assert_array_equal(eng.count(kmers), pt.SearchEngine(want, device="cpu").count(kmers))


def test_wide_dense_device_sa_build_time():
    rng = np.random.default_rng(0xA3F7)
    seq = random_sequence(rng, 4000, DNA)
    j, p = build_both(seq, 8, 3, DNA, device_sa_ratio=2)
    jdev = j.to_device(refresh=True, wide=True)
    pdev = p.to_device("cpu", wide=True)
    assert pdev.ratio == jdev.ratio == 2
    assert pdev.sampled_sa.shape[0] == (p.bwt_length + 1) // 2
    assert pdev.sampled_sa.numpy().tobytes() == np.asarray(jdev.sampled_sa).tobytes()
    kmers = [random_kmer(rng, int(rng.integers(2, 12)), DNA) for _ in range(128)]
    want = _jax_wide_engine(j, jdev).locate(kmers)
    j._device_cache = None
    assert_locates_equal(pt.SearchEngine(pdev, device="cpu").locate(kmers), want)
    _, plain = build_both(seq, 8, 3, DNA)
    assert_locates_equal(pt.SearchEngine(plain, device="cpu").locate(kmers), want)


def test_wide_densify_device_sa_matches_build_time():
    rng = np.random.default_rng(0xA3F8)
    seq = random_sequence(rng, 4000, DNA)
    _, built = build_both(seq, 8, 3, DNA, device_sa_ratio=2)
    built_dev = built.to_device("cpu", wide=True)
    j, p = build_both(seq, 8, 3, DNA)
    p.to_device("cpu", wide=True)  # install the wide view
    dense = p.densify_device_sa(2, chunk=1024, device="cpu")  # finds it wide
    assert dense.wide and dense.ratio == 2 and p.device_sa_ratio == 2
    assert p.to_device("cpu", wide=True) is dense
    assert torch.equal(dense.sampled_sa, built_dev.sampled_sa)
    j.to_device(refresh=True, wide=True)
    jdense = j.densify_device_sa(2, chunk=1024)
    assert dense.sampled_sa.numpy().tobytes() == np.asarray(jdense.sampled_sa).tobytes()
    j._device_cache = None
    kmers = [random_kmer(rng, int(rng.integers(2, 12)), DNA) for _ in range(128)]
    _, plain = build_both(seq, 8, 3, DNA)
    assert_locates_equal(pt.SearchEngine(dense, device="cpu").locate(kmers),
                         pt.SearchEngine(plain, device="cpu").locate(kmers))


def test_narrow_rebuild_after_wide_cache():
    """A narrow view rebuilt while a wide one is cached must not take the
    int64 seed table as it is, and the reverse."""
    rng = np.random.default_rng(0xA3F9)
    seq = random_sequence(rng, 3000, DNA)
    _, p = build_both(seq, 4, 3, DNA)
    kmers = [random_kmer(rng, int(rng.integers(3, 9)), DNA) for _ in range(64)]
    want = pt.SearchEngine(p, device="cpu").count(kmers)
    assert want.sum() > 0
    p.kmer_seed_table = None  # the table lives only in the cached view from here on
    wide = p.to_device("cpu", wide=True)
    assert wide.wide and p.to_device("cpu", wide=True) is wide
    eng = pt.SearchEngine(p, device="cpu")  # narrow rebuild from the wide cache
    assert not eng.wide and eng.dev.seed_table.dtype == torch.int32
    np.testing.assert_array_equal(eng.count(kmers), want)
    again = pt.SearchEngine(p, device="cpu", wide=True)  # and back
    assert again.dev.seed_table.dtype == torch.int64
    np.testing.assert_array_equal(again.count(kmers), want)


def test_ngram_engine_refuses_a_wide_view():
    rng = np.random.default_rng(0xA3FA)
    seq = random_sequence(rng, 2000, DNA, clean=True)
    _, p = build_both(seq, 4, 3, DNA)
    with pytest.raises(NotImplementedError, match="n-gram stepping over wide rows"):
        pt.NgramSearchEngine(p, 2, device="cpu", wide=True)
    with pytest.raises(NotImplementedError, match="narrow-only"):
        pt.DigramSearchEngine(p, device="cpu", wide=True)
    with pytest.raises(ValueError, match="own width"):
        pt.SearchEngine(p.to_device("cpu", wide=True), device="cpu", wide=False)
    assert pt.DigramSearchEngine(p, device="cpu").count([seq[5:30]])[0] >= 1


# ---------------------------------------------------------------------------
# enumerate and the device-side locate at the full width
# ---------------------------------------------------------------------------

def test_range_counts_do_not_wrap_above_2_32():
    start = _i64([5, 2**33, 2**64 - 1, 7, 2**63 + 5])
    end = _i64([2**33, 2**33 + 9, 3, 6, 2**63 + 9])
    got = psearch.range_counts(start, end, wide=True)
    assert got.tolist() == [2**33 - 4, 10, 0, 0, 5]
    assert psearch.total_hits_host(start, end, wide=True) == 2**33 - 4 + 15
    # the narrow reading of the same small values is unchanged
    assert psearch.range_counts(torch.tensor([5, 7]), torch.tensor([9, 6])).tolist() == [5, 0]


def test_enumerate_flat_keeps_positions_above_2_32():
    start = _i64([2**32 - 2, 2**35 + 1, 9])
    end = _i64([2**32 + 1, 2**35 + 2, 8])
    pos, qid, mask = psearch.enumerate_flat(start, end, capacity=8, wide=True)
    assert pos.tolist() == [2**32 - 2, 2**32 - 1, 2**32, 2**32 + 1, 2**35 + 1, 2**35 + 2, 0, 0]
    assert qid.tolist() == [0, 0, 0, 0, 1, 1, 0, 0] and mask.tolist() == [True] * 6 + [False] * 2
    # the same values cut to u32 give the narrow reading: the first range
    # is empty there (2^32 - 2 > 1), the second is [1, 2]
    npos, nqid, nmask = psearch.enumerate_flat(start & 0xFFFFFFFF, end & 0xFFFFFFFF, capacity=8)
    assert npos.tolist()[:3] == [1, 2, 0] and nqid.tolist()[:2] == [1, 1] and int(nmask.sum()) == 2


def test_wide_device_side_locate_equals_narrow(both):
    j, p, jdev, seq = both
    rng = np.random.default_rng(9)
    kmers = [seq[s : s + int(rng.integers(2, 8))] for s in rng.integers(0, len(seq) - 8, 64)]
    narrow = pt.SearchEngine(p, device="cpu")
    wide = pt.SearchEngine(p, device="cpu", wide=True)
    mat, lengths, n = wide.encode_kmers(kmers)
    ws, we = wide._ranges_device(mat, lengths)
    ns, ne = narrow._ranges_device(mat, lengths)
    assert torch.equal(ws, ns) and torch.equal(we, ne)
    cap = psearch.total_hits_host(ws[:n], we[:n], wide=True) + 13
    got = psearch.locate_flat_device(wide.dev, ws[:n], we[:n], capacity=cap)
    want = psearch.locate_flat_device(narrow.dev, ns[:n], ne[:n], capacity=cap)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(psearch.locate_first_hit(wide.dev, ws, we),
                       psearch.locate_first_hit(narrow.dev, ns, ne))

"""Port parity: the range-sharded engine (parallel/range_sharded.py), its
masked rank (ops/sharded.py), the compact wide rows it shards, and the
planner's range-sharded plans.

Every case of tests/test_range_sharded.py runs on the port over
``["cpu"] * n`` (the JAX side on ``make_index_mesh(n)`` of the 8 virtual
CPU devices where it is run), held to the JAX ``SearchEngine``'s answers
and, narrow, to the JAX range-sharded engine's. Beyond them: each shard's
rows and samples against the JAX engine's arrays, the masked plain
versions against the JAX per-shard bodies (``_local_occurrence``,
``_local_rows64`` + ``_count_rows64``, ``letter_at_rows``) on crafted
positions at the shard edges, and ``plan_capacity(n_devices > 1)`` field
for field against the JAX planner. Tolerance 0: every quantity is an
integer.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.models import index as jindex
from avxwindowfmindex_tpu.ops import rank as jrank
from avxwindowfmindex_tpu.ops import rank64 as jr64
from avxwindowfmindex_tpu.parallel import range_sharded as jrs
from avxwindowfmindex_tpu.utils import capacity as jcap
from avxwindowfmindex_tpu_torch.models import index as pindex
from avxwindowfmindex_tpu_torch.ops import kernels, sharded
from avxwindowfmindex_tpu_torch.parallel import range_sharded as prs
from avxwindowfmindex_tpu_torch.utils import capacity as pcap

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both

DNA = jx.AlphabetType.DNA
AMINO = jx.AlphabetType.AMINO


class Built:
    """One text indexed by both packages, with the JAX SearchEngine's
    answers and the JAX range-sharded engines made once per list length
    and width."""

    def __init__(self, seq, ratio, k, alphabet):
        self.seq = seq
        self.j, self.p = build_both(seq, ratio, k, alphabet)
        self.single = jx.SearchEngine(self.j)
        self._jax = {}

    def jax_sharded(self, n, wide=False):
        if (n, wide) not in self._jax:
            self._jax[n, wide] = jrs.RangeShardedSearchEngine(
                self.j, jrs.make_index_mesh(n), wide=wide)
        return self._jax[n, wide]

    def port(self, n, wide=False):
        return prs.RangeShardedSearchEngine(self.p, ["cpu"] * n, wide=wide)


@pytest.fixture(scope="module")
def built():
    # > 8 blocks so that every shard of 8 owns at least one
    return Built(random_sequence(np.random.default_rng(11), 5000, DNA), 4, 3, DNA)


# ---------------------------------------------------------------------------
# the cases of tests/test_range_sharded.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_count_matches(built, rng, n_dev):
    kmers = [random_kmer(rng, int(rng.integers(1, 9)), DNA) for _ in range(80)]
    got = built.port(n_dev).count(kmers)
    np.testing.assert_array_equal(got, built.single.count(kmers))
    np.testing.assert_array_equal(got, built.jax_sharded(n_dev).count(kmers))


def test_sharded_locate_matches(built, rng):
    kmers = [random_kmer(rng, int(rng.integers(3, 7)), DNA) for _ in range(30)]
    eng = built.port(4)
    got = eng.locate(kmers)
    assert_locates_equal(got, built.single.locate(kmers))
    assert_locates_equal(got, built.jax_sharded(4).locate(kmers))
    assert eng.last_backtrace["launches"] == 4 * eng.last_backtrace["lf_steps"]


def test_sharded_amino(rng):
    seq = random_sequence(rng, 3000, AMINO)
    b = Built(seq, 3, 2, AMINO)
    kmers = [random_kmer(rng, 4, AMINO) for _ in range(40)]
    eng = b.port(8)
    np.testing.assert_array_equal(eng.count(kmers), b.single.count(kmers))
    assert_locates_equal(eng.locate(kmers[:10]), b.single.locate(kmers[:10]))


def test_on_disk_sa_rejected_clearly(rng, tmp_path):
    seq = random_sequence(rng, 600, DNA)
    path = str(tmp_path / "r.awfmi")
    pt.create_index(seq, pt.IndexConfiguration(4, 2, pt.AlphabetType.DNA), file_src=path,
                    device="cpu")
    on_disk = pt.read_index_from_file(path, keep_suffix_array_in_memory=False)
    with pytest.raises(ValueError, match="suffix array"):
        prs.RangeShardedSearchEngine(on_disk, ["cpu"] * 2)


def test_resolve_cached_or_rebuilt_without_harm(built):
    """The JAX engine builds its resolve program once (``_resolve_fn``);
    the port has nothing to build, so a second locate must leave the
    shards as they were and answer the same."""
    eng = built.port(2)
    ptrs = [(s.packed.data_ptr(), s.sampled_sa.data_ptr()) for s in eng.shards]
    first = eng.locate([b"ACGT", b"GATT"])
    again = eng.locate([b"ACGT", b"GATT"])
    assert_locates_equal(again, first)
    assert_locates_equal(first, built.single.locate([b"ACGT", b"GATT"]))
    assert [(s.packed.data_ptr(), s.sampled_sa.data_ptr()) for s in eng.shards] == ptrs


def test_sharded_backtrace_compaction_levels(rng):
    """Every BWT position at ratio 16: walks longer than a segment make
    the loop compact its lanes several times, and the answers must equal
    the single-device walk exactly."""
    b = Built(random_sequence(rng, 3000, DNA), 16, 2, DNA)
    eng = b.port(2)
    pos = np.arange(b.p.bwt_length, dtype=np.uint64)
    np.testing.assert_array_equal(eng.resolve_positions(pos), b.single.resolve_positions(pos))
    stats = eng.last_backtrace
    assert stats["segments"] >= 3 and stats["lane_steps"] < stats["lf_steps"] * len(pos)


@pytest.mark.parametrize("n_dev", [2, 8])
def test_sharded_wide_matches(built, rng, n_dev):
    """Forced-wide engine: compact wide rows, count and locate equal to
    the narrow single-device engine."""
    eng = built.port(n_dev, wide=True)
    assert eng.wide and not any(s.pair_fused for s in eng.shards)
    kmers = [random_kmer(rng, int(rng.integers(2, 12)), DNA) for _ in range(64)]
    np.testing.assert_array_equal(eng.count(kmers), built.single.count(kmers))
    assert_locates_equal(eng.locate(kmers[:12]), built.single.locate(kmers[:12]))


def test_sharded_wide_mixed_eligibility(built):
    kmers = [b"AC", b"GATTACA", b"T", b"ACGTACGTACGT", b"GG"]
    np.testing.assert_array_equal(built.port(4, wide=True).count(kmers),
                                  built.single.count(kmers))


def _hi_carry_table(rng, nb):
    """Letters, u64 milestones straddling 2^32 and their compact rows."""
    card = 4
    letters = rng.integers(0, card + 2, size=(nb, 256)).astype(np.uint8)
    counts = np.stack([(letters == j).sum(axis=1) for j in range(card + 2)],
                      axis=1).astype(np.uint64)
    cum = np.cumsum(counts, axis=0)
    ms = np.zeros_like(cum)
    ms[1:] = cum[:-1]
    ms += np.uint64(2**32 - 100)  # counts cross 2^32 mid-table
    return letters, ms


def test_sharded_wide_occurrence_hi_carry(rng):
    """Masked occurrences over compact rows whose milestones straddle
    2^32, summed over 8 shards, equal a host oracle and the JAX per-shard
    body (``_local_rows64`` + ``_count_rows64``) shard by shard."""
    nb, n_dev = 16, 8
    letters, ms = _hi_carry_table(rng, nb)
    rows = pindex.pack_device_blocks64(letters.reshape(-1), ms, pt.AlphabetType.DNA, pair=False)
    np.testing.assert_array_equal(
        rows, jr64.pack_device_blocks64(letters.reshape(-1), ms, DNA, pair=False))
    positions = rng.integers(0, nb * 256, size=256, dtype=np.uint64)
    letts = rng.integers(0, 5, size=256).astype(np.int32)
    jdev = jr64.DeviceIndex64(
        packed=None, prefix_hi=jnp.zeros(6, jnp.uint32), prefix_lo=jnp.ones(6, jnp.uint32),
        seed_table=jnp.zeros((1, 4), jnp.uint32), sampled_sa=None,
        code_masks=jnp.asarray(jindex.device_code_masks(DNA)),
        vec_to_index=jnp.asarray(jx.models.alphabet.vector_to_index_lut(DNA).astype(np.int32)),
        bwt_length=nb * 256, ratio=8, kmer_length_in_seed_table=3, alphabet=DNA,
        pair_fused=False,
    )
    bps = nb // n_dev
    p_hi, p_lo = jr64.split_u64_host(positions)
    total = torch.zeros(256, dtype=torch.int64)
    for i in range(n_dev):
        shard = _port_shard(rows[i * bps : (i + 1) * bps], wide=True)
        got = sharded.local_occurrence_plain(
            shard, torch.from_numpy(positions.view(np.int64)), torch.from_numpy(letts), i * bps)
        d = dataclasses.replace(jdev, packed=jnp.asarray(rows[i * bps : (i + 1) * bps]))
        r, local, owned = jrs._local_rows64(d, jnp.asarray(p_hi), jnp.asarray(p_lo), i * bps, bps)
        hi, lo = jr64._count_rows64(d, r, local, jnp.asarray(letts))
        want = np.where(np.asarray(owned), _join(hi, lo), 0)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want)
        total += got
    flat = letters.reshape(-1)
    oracle = np.array([
        ms[int(p) // 256, l] + np.uint64(np.count_nonzero(flat[int(p) // 256 * 256 : int(p) + 1] == l))
        for p, l in zip(positions, letts)
    ], dtype=np.uint64)
    np.testing.assert_array_equal(total.numpy().view(np.uint64), oracle)


# ---------------------------------------------------------------------------
# the shards against the JAX engine's arrays
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n_dev", [3, 8])
def test_shards_equal_jax_engine_arrays(built, n_dev, wide):
    j = built.jax_sharded(n_dev, wide)
    eng = built.port(n_dev, wide)
    assert (eng.blocks_per_shard, eng.samples_per_shard) == (j.blocks_per_shard,
                                                            j.samples_per_shard)
    rows = np.asarray(j.dev.packed)
    sa = np.asarray(j.dev.sampled_sa)
    if wide:
        sa = (sa[:, 1].astype(np.uint64) << np.uint64(32)) | sa[:, 0]
    bps, sps = eng.blocks_per_shard, eng.samples_per_shard
    for i, shard in enumerate(eng.shards):
        assert eng.first_blocks[i] == i * bps and eng.first_samples[i] == i * sps
        np.testing.assert_array_equal(shard.packed.numpy(), rows[i * bps : (i + 1) * bps])
        np.testing.assert_array_equal(shard.numpy_u64(shard.sampled_sa), sa[i * sps : (i + 1) * sps])
        assert shard.packed_pair is None and shard.pair_fused == (not wide)
    if wide:
        ps = (np.asarray(j.dev.prefix_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
            j.dev.prefix_lo)
        np.testing.assert_array_equal(eng.dev.numpy_u64(eng.dev.prefix_sums), ps)
    else:
        np.testing.assert_array_equal(eng.dev.numpy_u64(eng.dev.prefix_sums),
                                      np.asarray(j.dev.prefix_sums))
        np.testing.assert_array_equal(eng.dev.numpy_u64(eng.dev.seed_table),
                                      np.asarray(j.dev.seed_table))
    # one replicated table for a device named n times
    assert all(s.seed_table is eng.dev.seed_table for s in eng.shards)
    assert all(s.prefix_sums is eng.dev.prefix_sums for s in eng.shards)


@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=["nt", "aa"])
def test_compact_wide_rows_equal_jax(alphabet):
    rng = np.random.default_rng(21)
    b = Built(random_sequence(rng, 1500, alphabet), 4, 2, alphabet)
    ms = b.p.milestones()
    got = pindex.pack_device_blocks64(b.p.bwt_letters, ms, b.p.alphabet, pair=False)
    want = jr64.pack_device_blocks64(b.j.bwt_letters, ms, alphabet, pair=False)
    np.testing.assert_array_equal(got, want)
    assert got.shape[1] == pindex.device_row_bytes64(b.p.alphabet, pair=False) == (
        jr64.device_row_bytes64(alphabet, pair=False)) == {DNA: 256, AMINO: 384}[alphabet]
    # the default stays the pair-fused rows
    np.testing.assert_array_equal(
        pindex.pack_device_blocks64(b.p.bwt_letters, ms, b.p.alphabet),
        jr64.pack_device_blocks64(b.j.bwt_letters, ms, alphabet))


# ---------------------------------------------------------------------------
# the masked plain versions against the JAX per-shard bodies
# ---------------------------------------------------------------------------

def _join(hi, lo):
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def _port_shard(rows, wide, alphabet=pt.AlphabetType.DNA):
    z = torch.zeros(1, dtype=torch.int64 if wide else torch.int32)
    return pindex.DeviceIndex(
        packed=torch.from_numpy(np.ascontiguousarray(rows)), packed_pair=None,
        prefix_sums=z, seed_table=z, sampled_sa=None,
        code_masks=torch.from_numpy(pindex.device_code_masks(alphabet)),
        vec_to_index=torch.from_numpy(
            pt.models.alphabet.vector_to_index_lut(alphabet).astype(np.int32)),
        bwt_length=1, ratio=1, kmer_length_in_seed_table=1, alphabet=alphabet,
        wide=wide, pair_fused=not wide,
    )


def _edge_positions(rng, eng, wide):
    """Every shard's first and last block (their first and last
    positions), the zero padding of the last shard, ``start - 1`` at
    ``start == 0``, past the padded table, random positions; wide: above
    2^32 and with bit 39 set (reads negative as int32)."""
    bps, n = eng.blocks_per_shard, eng.n_dev
    edges = []
    for i in range(n):
        for blk in (i * bps, (i + 1) * bps - 1):
            edges += [blk * 256, blk * 256 + 255]
    top = bps * n * 256
    edges += [eng.host_index.bwt_length - 1, eng.host_index.bwt_length, top - 1, top, top + 300]
    if wide:
        edges += [2**64 - 1, 2**32 - 1, 2**32 + 5, 2**39, 2**39 + 256 * 3 + 7, 2**40 + 5,
                  2**63 + 9]
    else:
        edges += [2**32 - 1, 2**31 + 17]
    # one batch size for every case, so that the JAX side compiles once
    edges += list(rng.integers(0, top, 256 - len(edges)))
    return np.array(edges, dtype=np.uint64)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_masked_plain_versions_equal_jax(built, rng, n_dev, wide):
    """``local_occurrence_plain`` and the LF body (``local_letter_occ_plain``)
    against ``_local_occurrence`` / ``_local_rows64`` + ``_count_rows64``
    and ``letter_at_rows`` + ``_count_rows`` of the JAX package, shard by
    shard, on crafted edge positions."""
    eng = built.port(n_dev, wide)
    pos = _edge_positions(rng, eng, wide)
    letts = rng.integers(0, 7, size=len(pos)).astype(np.int32)
    pos_t = torch.from_numpy(pos.view(np.int64))
    card = eng.dev.cardinality
    full = built.j.to_device(wide=True, refresh=True) if wide else built.j.to_device()
    built.j._device_cache = None
    for i, shard in enumerate(eng.shards):
        fb, bps = eng.first_blocks[i], eng.blocks_per_shard
        d = dataclasses.replace(full, packed=jnp.asarray(shard.packed.numpy()))
        if wide:
            d = dataclasses.replace(d, pair_fused=False)
            p_hi, p_lo = jr64.split_u64_host(pos)
            rows, local, owned = jrs._local_rows64(d, jnp.asarray(p_hi), jnp.asarray(p_lo), fb, bps)
            want_occ = np.where(np.asarray(owned),
                                _join(*jr64._count_rows64(d, rows, local, jnp.asarray(letts))), 0)
            lett = jrank.letter_at_rows(d, rows, local)
            occ_l = _join(*jr64._count_rows64(d, rows, local, jnp.minimum(lett, card)))
        else:
            p32 = jnp.asarray(pos.astype(np.uint32))
            want_occ = np.asarray(jrs._local_occurrence(d, p32, jnp.asarray(letts), fb, bps))
            blk = (p32 // 256).astype(jnp.int32) - fb
            owned = (blk >= 0) & (blk < bps)
            rows = d.packed[jnp.clip(blk, 0, bps - 1)]
            local = (p32 % 256).astype(jnp.int32)
            lett = jrank.letter_at_rows(d, rows, local)
            occ_l = np.asarray(jrank._count_rows(d, rows, local, jnp.minimum(lett, card)))
        owned = np.asarray(owned)
        got = sharded.local_occurrence_plain(shard, pos_t, torch.from_numpy(letts), fb)
        np.testing.assert_array_equal(got.numpy().view(np.uint64), want_occ.astype(np.uint64))
        gl, go = sharded.local_letter_occ_plain(shard, pos_t, fb)
        np.testing.assert_array_equal(gl.numpy(), np.where(owned, np.asarray(lett), 0))
        np.testing.assert_array_equal(go.numpy().view(np.uint64),
                                      np.where(owned, occ_l, 0).astype(np.uint64))
        # the dispatch wrappers take the plain versions for CPU tensors: the
        # route and this shard's occ give its masked occ where it owns
        out = torch.full((len(pos),), -7, dtype=torch.int64)
        counts = torch.empty(eng.n_dev + 1, dtype=torch.int32)
        slot_pos, slot_lane = sharded.route(pos_t, out, eng.n_dev, bps, wide, 0, counts)
        sharded.shard_occurrence(shard, fb, slot_pos, slot_lane, counts, i,
                                 torch.from_numpy(letts), out)
        np.testing.assert_array_equal(out.numpy()[owned], got.numpy()[owned])


def test_wrapped_start_is_owned_by_no_shard(built):
    """``start - 1`` at ``start == 0`` wraps (u32 0xFFFFFFFF, u64 2^64 - 1)
    and lies in no shard's range, so its occ is 0: the sharded engine does
    not clamp it to the last row as the single-device engine does."""
    for wide in (False, True):
        eng = built.port(2, wide)
        wrapped = torch.tensor([-1], dtype=torch.int64)
        for letter in range(eng.dev.cardinality + 1):
            assert int(eng.occurrence(wrapped, torch.tensor([letter]))[0]) == 0
        lett, lf = eng.letter_and_lf(wrapped & eng.dev.pos_mask)
        assert (int(lett[0]), int(lf[0])) == (0, 0)


def test_sharded_resolve_wraps_like_jax():
    """The sharded SA gather: the owning shard's sample, 0 from the rest,
    and a sum past 2^32 brought back by the wrap-aware subtract."""
    z = torch.zeros(1, dtype=torch.int32)
    n = 3 * 2**30
    dev = pindex.DeviceIndex(
        packed=torch.zeros((1, 128), dtype=torch.uint8), packed_pair=None, prefix_sums=z,
        seed_table=z, sampled_sa=pindex.u32_tensor([n - 1, n - 2], "cpu"),
        code_masks=z, vec_to_index=z, bwt_length=n, ratio=4, kmer_length_in_seed_table=1,
        alphabet=pt.AlphabetType.DNA,
    )
    p = torch.tensor([4 * 7, 4 * 8, 4 * 9, 4 * 10], dtype=torch.int64)
    sa = sharded.local_samples(dev, p, 8)
    assert sa.tolist() == [0, n - 1, n - 2, 0]
    off = torch.tensor([0, 2**31 + 5, 1, 0], dtype=torch.int64)
    assert sharded.resolve_hits(dev, sa, off).tolist() == [0, (n - 1 + 2**31 + 5) - n, n - 1, 0]


def test_devices_default_to_the_card_and_kernels_refuse_cpu(built):
    assert prs.make_index_mesh(2, ["cpu", "cpu:0", torch.device("cpu")]) == [
        torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            prs.make_index_mesh()
        with pytest.raises(RuntimeError, match="devices="):
            prs.RangeShardedSearchEngine(built.p)
    eng = built.port(2)
    with pytest.raises(ValueError, match="wide=True"):
        prs.RangeShardedSearchEngine(
            dataclasses.replace(built.p, bwt_length=2**32), ["cpu"], wide=False)
    kernels.reset_launch_counts()
    pos = torch.zeros(4, dtype=torch.int64)
    lanes, counts = torch.zeros(4, dtype=torch.int32), torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k1r_occurrence(eng.dev, 0, pos, lanes, counts, 0,
                               torch.zeros(4, dtype=torch.int32), pos.clone())
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k1r_lf(eng.dev, 0, pos, lanes, counts, 0, pos.clone())
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k1r_route(pos, pos.clone(), 2, eng.blocks_per_shard, False, 0, counts)
    # K1R takes shards only, and the other kernels whole views only
    with pytest.raises(ValueError, match="shards"):
        kernels.k1r_lf(built.p.to_device("cpu"), 0, pos, lanes, counts, 0, pos.clone())
    with pytest.raises(ValueError, match="shards"):
        kernels.k1_occurrence(eng.dev, pos, torch.zeros(4, dtype=torch.int32))
    assert all(k.launches == 0 for k in kernels.KERNELS)


# ---------------------------------------------------------------------------
# capacity: the planner's range-sharded plans
# ---------------------------------------------------------------------------

def _plan_fields(plan):
    return {f.name: getattr(plan, f.name) for f in dataclasses.fields(plan)
            if f.name not in ("alphabet", "notes")}


@pytest.mark.parametrize("case", [
    dict(num_bases=12_000_000_000, hbm_bytes=int(6e9), n_devices=8, batch=1 << 20),
    dict(num_bases=3_100_000_000, hbm_bytes=int(2e9), n_devices=4, batch=1 << 20),
    dict(num_bases=3_100_000_000, hbm_bytes=int(1.2e9), n_devices=8, batch=1 << 20),
    dict(num_bases=64_000_000, hbm_bytes=int(16e9), n_devices=8, batch=1 << 20),
    dict(num_bases=40_000_000_000, hbm_bytes=80 * 2**30, n_devices=4, batch=1 << 22),
    dict(num_bases=2_000_000_000, alphabet="AMINO", hbm_bytes=int(4e9), n_devices=4,
         batch=1 << 20, kmer_len=20),
], ids=["12G-8dev", "hg38-4dev", "hg38-8dev-k-drops", "64M-fits-one", "40G-4xH100", "amino-4dev"])
def test_plan_over_devices_equals_jax(monkeypatch, case):
    """``plan_capacity(n_devices > 1)`` equals the JAX planner's plan field
    for field: engine, per-chip bytes (the sharded components split n
    ways plus the replicated seed table), seed k, pair rows, components,
    budget; notes equal where the layout is narrow (the wide note names
    the port's u64 layout, not the hi/lo one)."""
    monkeypatch.setattr(pcap, "_WORKSPACE_SLACK_BYTES", jcap._XLA_SLACK_BYTES)
    case = dict(case)
    alphabet = case.pop("alphabet", "DNA")
    want = jcap.plan_capacity(alphabet=jx.AlphabetType[alphabet], **case)
    got = pcap.plan_capacity(alphabet=pt.AlphabetType[alphabet], **case)
    assert _plan_fields(got) == _plan_fields(want)
    assert int(got.alphabet) == int(want.alphabet)
    if not got.wide:
        assert got.notes == want.notes
    assert any("partitioned over" in n for n in got.notes) == (got.engine == "range_sharded")
    assert got.summary().replace("wide", "narrow") == want.summary().replace("wide", "narrow")


def test_range_sharded_when_exceeding_chip(monkeypatch):
    """tests/test_capacity.py's case: one device refuses with the mesh
    it would need, eight take a range-sharded plan."""
    monkeypatch.setattr(pcap, "_WORKSPACE_SLACK_BYTES", jcap._XLA_SLACK_BYTES)
    corpus = 12_000_000_000
    with pytest.raises(ValueError, match="range-sharded|mesh") as got:
        pcap.plan_capacity(corpus, hbm_bytes=int(6e9), n_devices=1, batch=1 << 20)
    with pytest.raises(ValueError) as want:
        jcap.plan_capacity(corpus, hbm_bytes=int(6e9), n_devices=1, batch=1 << 20)
    assert str(got.value) == str(want.value)
    plan = pcap.plan_capacity(corpus, hbm_bytes=int(6e9), n_devices=8, batch=1 << 20)
    assert plan.engine == "range_sharded"
    assert plan.per_chip_bytes <= plan.budget < plan.index_bytes
    # nothing fits even over the devices: the same shortfall as JAX
    with pytest.raises(ValueError, match="needs a >= ") as got:
        pcap.plan_capacity(corpus, hbm_bytes=int(2e9), n_devices=2, batch=1 << 20)
    with pytest.raises(ValueError) as want:
        jcap.plan_capacity(corpus, hbm_bytes=int(2e9), n_devices=2, batch=1 << 20)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("alphabet,k", [("DNA", 12), ("AMINO", 5)])
def test_compact_wide_component_bytes_equal_jax(alphabet, k):
    kw = dict(seed_k=k, sa_ratio=8, device_sa_ratio=4, pair_rows=False)
    got = pcap.component_bytes(5_000_000_000, pt.AlphabetType[alphabet], **kw)
    assert got == jcap.component_bytes(5_000_000_000, jx.AlphabetType[alphabet], **kw)
    nb = -(-5_000_000_001 // 256)
    assert got["packed"] == nb * {"DNA": 256, "AMINO": 384}[alphabet]

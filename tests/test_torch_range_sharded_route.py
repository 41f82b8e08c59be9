"""Port parity: the routed step of the range-sharded engine.

A step of ``parallel/range_sharded.py`` hands each position once to the
shard that owns it (``ops/sharded.py:route``), and that shard computes
the step's whole value (``shard_occurrence``, ``shard_lf``). Held here,
on the CPU with JAX pinned to the CPU, to:

- ``owned_rows``, the per-shard ownership test of the JAX-literal masked
  bodies: the route gives each lane exactly the shard whose test holds,
  or none (n = 1-4 shards, with and without padding, narrow and wide,
  DNA and amino, crafted edge positions);
- the sum over the shards of ``local_occurrence_plain`` and
  ``local_letter_occ_plain`` followed by ``lf_from_letter_occ`` and the
  done rule, the old every-lane step;
- the JAX package's ``_local_occurrence`` under ``shard_map`` with a
  ``psum``, and its backtrace segment, on the 8-device CPU mesh;
- ``SearchEngine`` and the JAX ``RangeShardedSearchEngine``, end to end.

Tolerance 0: every quantity is an integer.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import avxwindowfmindex_tpu as jx
from avxwindowfmindex_tpu.parallel import range_sharded as jrs
from avxwindowfmindex_tpu_torch.ops import rank, sharded
from avxwindowfmindex_tpu_torch.parallel import range_sharded as prs

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both

DNA = jx.AlphabetType.DNA
AMINO = jx.AlphabetType.AMINO


class Built:
    """One text indexed by both packages, its JAX SearchEngine, and the
    JAX range-sharded engines made once per shard count."""

    def __init__(self, seq, ratio, k, alphabet):
        self.j, self.p = build_both(seq, ratio, k, alphabet)
        self.single = jx.SearchEngine(self.j)
        self._jax = {}

    def jax_sharded(self, n):
        if n not in self._jax:
            self._jax[n] = jrs.RangeShardedSearchEngine(self.j, jrs.make_index_mesh(n))
        return self._jax[n]

    def port(self, n, wide=False):
        return prs.RangeShardedSearchEngine(self.p, ["cpu"] * n, wide=wide)


@pytest.fixture(scope="module")
def dna():
    # 20 blocks: 3 shards leave one block of padding, 4 none
    return Built(random_sequence(np.random.default_rng(31), 5000, DNA), 4, 3, DNA)


@pytest.fixture(scope="module")
def amino():
    # 13 blocks: 2, 3 and 4 shards all leave padding
    return Built(random_sequence(np.random.default_rng(32), 3300, AMINO), 3, 2, AMINO)


def edge_positions(rng, eng, size=384):
    """Every shard's first and last block (their first and last position),
    the zero padding of the last shard, ``start - 1`` at ``start == 0``,
    past the padded table, u32 wrap points; wide: above 2^32, bit 39 set
    (reads negative as int32), 2^40 + x (aliases block x); then random
    positions of the index. Returned as int64 holding the u64 values."""
    bps, n = eng.blocks_per_shard, eng.n_dev
    edges = []
    for i in range(n):
        for blk in (i * bps, (i + 1) * bps - 1):
            edges += [blk * 256, blk * 256 + 255]
    top = bps * n * 256
    edges += [eng.host_index.bwt_length - 1, eng.host_index.bwt_length, top - 1, top,
              top + 300, 2**32 - 1, 2**31 + 17, 0, 1]
    if eng.wide:
        edges += [2**64 - 1, 2**32 + 5, 2**39, 2**39 + 256 * 3 + 7, 2**40 + 5, 2**40 + 256 + 9,
                  2**63 + 9]
    edges += list(rng.integers(0, eng.host_index.bwt_length, size - len(edges)))
    return torch.from_numpy(np.array(edges, dtype=np.uint64).view(np.int64))


def route(eng, pos, out=None, **kw):
    """The route of ``eng``'s shards over ``pos``: (slot_pos, slot_lane,
    counts as a list)."""
    out = torch.zeros_like(pos) if out is None else out
    counts = torch.empty(eng.n_dev + 1, dtype=torch.int32)
    unowned = eng.lf_unowned if kw.get("ratio") or "letters" in kw else 0
    slot_pos, slot_lane = sharded.route(pos, out, eng.n_dev, eng.blocks_per_shard, eng.wide,
                                        unowned, counts, **kw)
    return slot_pos, slot_lane, counts.tolist()


def masked_sum(eng, pos, fn):
    """The old every-lane step: ``fn(shard, pos, first_block)`` (a tensor or
    a tuple of them) summed over the shards."""
    total = None
    for shard, fb in zip(eng.shards, eng.first_blocks):
        got = fn(shard, pos, fb)
        got = got if isinstance(got, tuple) else (got,)
        total = got if total is None else tuple(a + b for a, b in zip(total, got))
    return total


# ---------------------------------------------------------------------------
# the route against the per-shard ownership test
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alphabet", ["dna", "amino"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_route_gives_each_lane_its_owner(request, rng, alphabet, wide, n_dev):
    eng = request.getfixturevalue(alphabet).port(n_dev, wide)
    pos = edge_positions(rng, eng)
    owners = torch.stack([sharded.owned_rows(s, pos, fb)[1]
                          for s, fb in zip(eng.shards, eng.first_blocks)])
    assert int(owners.sum(dim=0).max()) <= 1  # one owner at most
    want = torch.where(owners.any(dim=0), owners.to(torch.int64).argmax(dim=0), -1)
    assert torch.equal(sharded.owner_plain(pos, n_dev, eng.blocks_per_shard, wide), want)
    out = torch.full_like(pos, -5)
    slot_pos, slot_lane, counts = route(eng, pos, out)
    assert counts[:n_dev] == [int((want == s).sum()) for s in range(n_dev)]
    begin = 0
    for s in range(n_dev):
        lanes = slot_lane[begin : begin + counts[s]].to(torch.int64)
        assert torch.equal(lanes.sort().values, torch.nonzero(want == s)[:, 0])
        assert torch.equal(slot_pos[begin : begin + counts[s]], pos[lanes] & eng.dev.pos_mask)
        begin += counts[s]
    # occ mode: the lanes no shard owns get 0 now, the rest are the shards'
    assert bool((out[want < 0] == 0).all())
    assert bool((out[want >= 0] == -5).all())
    if wide:
        # bit 39 set reads negative: no shard; 2^40 + x aliases block x
        assert int(sharded.owner_plain(torch.tensor([2**39]), n_dev, eng.blocks_per_shard,
                                       True)[0]) == -1
        assert int(sharded.owner_plain(torch.tensor([2**40 + 5]), n_dev, eng.blocks_per_shard,
                                       True)[0]) == 0
    # narrow start - 1 at 0 wraps to 0xFFFFFFFF: no shard
    assert int(sharded.owner_plain(torch.tensor([-1]), n_dev, eng.blocks_per_shard,
                                   wide)[0]) == -1


def test_slices_carry_their_lanes_whatever_the_order(dna, rng):
    """The kernel's route places lanes inside a slice in an order that
    varies from run to run; a shard's step must not depend on it."""
    eng = dna.port(3)
    pos = edge_positions(rng, eng)
    lett = torch.from_numpy(rng.integers(0, 5, len(pos)).astype(np.int32))
    slot_pos, slot_lane, counts = route(eng, pos)
    want = eng.occurrence(pos, lett)
    begin = 0
    for c in counts[:3]:
        perm = torch.from_numpy(rng.permutation(c)) + begin
        slot_pos[begin : begin + c] = slot_pos[perm].clone()
        slot_lane[begin : begin + c] = slot_lane[perm].clone()
        begin += c
    out = torch.zeros_like(pos)
    cnt = torch.tensor(counts, dtype=torch.int32)
    for i, (shard, fb) in enumerate(zip(eng.shards, eng.first_blocks)):
        sharded.shard_occurrence(shard, fb, slot_pos, slot_lane, cnt, i, lett, out)
    assert torch.equal(out, want)


def test_route_edges_empty_batch_and_empty_shard(dna):
    eng = dna.port(4)
    empty = torch.zeros(0, dtype=torch.int64)
    assert route(eng, empty)[2] == [0] * 5
    assert eng.occurrence(empty, empty.to(torch.int32)).shape == (0,)
    lett, lf = eng.letter_and_lf(empty)
    assert lett.shape == lf.shape == (0,)
    # every lane in shard 0: shards 1-3 receive 0 lanes
    pos = torch.arange(0, eng.blocks_per_shard * 256, 7, dtype=torch.int64)
    counts = route(eng, pos)[2]
    assert counts[:4] == [len(pos), 0, 0, 0]
    want = masked_sum(eng, pos, lambda s, p, fb: sharded.local_occurrence_plain(
        s, p, torch.ones_like(p, dtype=torch.int32), fb))[0]
    assert torch.equal(eng.occurrence(pos, torch.ones_like(pos)), want)
    # lane indices are int32: 2^31 lanes are refused (a stride-0 view)
    huge = torch.zeros(1, dtype=torch.int64).expand(2**31)
    with pytest.raises(ValueError, match="2\\^31"):
        sharded.route_plain(huge, huge, 4, eng.blocks_per_shard, False, 0,
                            torch.empty(5, dtype=torch.int32))


# ---------------------------------------------------------------------------
# the routed steps against the old every-lane step
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("alphabet", ["dna", "amino"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_routed_occ_equals_masked_sum(request, rng, alphabet, wide, n_dev):
    eng = request.getfixturevalue(alphabet).port(n_dev, wide)
    pos = edge_positions(rng, eng)
    lett = torch.from_numpy(rng.integers(0, eng.dev.cardinality + 3, len(pos)).astype(np.int32))
    want = masked_sum(eng, pos, lambda s, p, fb: sharded.local_occurrence_plain(s, p, lett, fb))
    assert torch.equal(eng.occurrence(pos, lett), want[0])


def old_lf_step(eng, p, off, ratio):
    """The every-lane LF step: the shards' masked (letter, occ) summed, the
    LF formed after the sum, then the done rule."""
    lett, occ = masked_sum(eng, p, sharded.local_letter_occ_plain)
    lf = rank.lf_from_letter_occ(eng.dev, lett, occ)
    done = p % ratio == 0 if ratio else torch.zeros_like(p, dtype=torch.bool)
    if eng.wide and ratio:
        done = sharded._u64_mod(p, ratio) == 0
    return lett, torch.where(done, p, lf), torch.where(done, off, off + 1)


@pytest.mark.parametrize("alphabet", ["dna", "amino"])
@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("n_dev", [2, 3])
def test_routed_lf_equals_masked_sum_then_lf(request, rng, alphabet, wide, n_dev):
    eng = request.getfixturevalue(alphabet).port(n_dev, wide)
    pos = edge_positions(rng, eng) & eng.dev.pos_mask
    # letter mode (no done rule): the letter and the LF of every lane
    lett_w, lf_w, _ = old_lf_step(eng, pos, torch.zeros_like(pos), 0)
    lett, lf = eng.letter_and_lf(pos)
    assert torch.equal(lett, lett_w) and torch.equal(lf, lf_w)
    # the backtrace's step: the done rule inside the route, in place
    ratio = eng.dev.ratio
    off = torch.from_numpy(rng.integers(0, 9, len(pos)))
    _, p_w, off_w = old_lf_step(eng, pos, off, ratio)
    p, off2 = pos.clone(), off.clone()
    eng._step(p, p, ratio=ratio, off=off2)
    assert torch.equal(p, p_w) and torch.equal(off2, off_w)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_unowned_lane_steps_to_lf_of_zero(dna, wide):
    """A lane no shard owns gets what the psum of zeros gives: letter 0,
    LF = lf_from_letter_occ(0, 0), off + 1; a lane at a sample keeps
    (p, off) whether or not a shard owns it."""
    eng = dna.port(3, wide)
    mask = eng.dev.pos_mask
    top = eng.blocks_per_shard * 3 * 256
    unowned = [top, top + 77, (2**32 - 1) & mask, -1 & mask]
    if wide:
        unowned += [2**39 + 5, -(2**63) + 2**39]  # bit 39 set: the block reads negative
    pos = torch.tensor(unowned, dtype=torch.int64)
    zero = torch.zeros(1, dtype=torch.int64)
    lf0 = int(rank.lf_from_letter_occ(eng.dev, zero, zero)[0])
    assert eng.lf_unowned == lf0
    lett, lf = eng.letter_and_lf(pos)
    assert lett.tolist() == [0] * len(pos) and lf.tolist() == [lf0] * len(pos)
    ratio = eng.dev.ratio
    p = torch.tensor(unowned + [top + ratio * 3, 8 * ratio], dtype=torch.int64)
    off = torch.arange(len(p), dtype=torch.int64)
    stepped = (sharded._u64_mod(p, ratio) if wide else p % ratio) != 0
    want_p = torch.where(stepped, lf0, p)
    want_off = torch.where(stepped, off + 1, off)
    want_p[-1] = p[-1]  # owned and at a sample: kept
    eng._step(p, p, ratio=ratio, off=off)
    assert torch.equal(p, want_p) and torch.equal(off, want_off)


def test_copied_shard_path_equals_home(dna, rng):
    """A shard on another device gets its slice copied, runs on its own
    entries and is scattered back by lane: forced here on the CPU, it must
    give the home path's answers."""
    eng = dna.port(3)
    pos = edge_positions(rng, eng)
    lett = torch.from_numpy(rng.integers(0, 5, len(pos)).astype(np.int32))
    want_occ = eng.occurrence(pos, lett)
    want_l, want_lf = eng.letter_and_lf(pos)
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), DNA) for _ in range(40)]
    want_c, want_h = eng.count(kmers), eng.locate(kmers[:12])
    eng.copied_shards = frozenset({1, 2})
    assert torch.equal(eng.occurrence(pos, lett), want_occ)
    got_l, got_lf = eng.letter_and_lf(pos)
    assert torch.equal(got_l, want_l) and torch.equal(got_lf, want_lf)
    np.testing.assert_array_equal(eng.count(kmers), want_c)
    assert_locates_equal(eng.locate(kmers[:12]), want_h)


# ---------------------------------------------------------------------------
# against the JAX package on the 8-device CPU mesh
# ---------------------------------------------------------------------------

def jax_psum_occurrence(j, pos_u32, letts):
    """``_local_occurrence`` on every shard of the JAX engine's mesh, summed
    with ``psum``."""
    bps = j.blocks_per_shard

    def body(dev, p, l):
        first = jax.lax.axis_index(jrs.AXIS).astype(jnp.int32) * bps
        return jax.lax.psum(jrs._local_occurrence(dev, p, l, first, bps), jrs.AXIS)

    fn = jax.jit(jrs._shard_map(body, mesh=j.mesh, in_specs=(jrs._dev_specs(j.dev), P(), P()),
                                out_specs=P(), check_vma=False))
    rep = NamedSharding(j.mesh, P())
    return np.asarray(fn(j.dev, jax.device_put(jnp.asarray(pos_u32), rep),
                         jax.device_put(jnp.asarray(letts), rep)))


def test_routed_occ_equals_jax_psum(dna, rng):
    j, eng = dna.jax_sharded(8), dna.port(8)
    pos = edge_positions(rng, eng, size=512)
    letts = rng.integers(0, 5, len(pos)).astype(np.int32)
    want = jax_psum_occurrence(j, (pos.numpy().view(np.uint64) & 0xFFFFFFFF).astype(np.uint32),
                               letts)
    got = eng.occurrence(pos, torch.from_numpy(letts))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_routed_lf_segment_equals_jax_segment(dna, rng):
    """The JAX backtrace segment (``seg`` masked LF steps, one stacked psum
    each, the done rule) against the same number of routed steps."""
    j, eng = dna.jax_sharded(8), dna.port(8)
    n = 512
    pos = rng.integers(0, dna.p.bwt_length, n).astype(np.uint32)
    off = rng.integers(0, 5, n).astype(np.uint32)
    rep = NamedSharding(j.mesh, P())
    jp, joff = j._get_bt_segment_fn()(j.dev, jax.device_put(jnp.asarray(pos), rep),
                                      jax.device_put(jnp.asarray(off), rep))
    seg = min(64, max(4, 2 * j.dev.ratio))
    p = torch.from_numpy(pos.astype(np.int64))
    o = torch.from_numpy(off.astype(np.int64))
    for _ in range(seg):
        eng._step(p, p, ratio=eng.dev.ratio, off=o)
    np.testing.assert_array_equal(p.numpy(), np.asarray(jp).astype(np.int64))
    np.testing.assert_array_equal(o.numpy(), np.asarray(joff).astype(np.int64))


@pytest.mark.parametrize("n_dev", [3, 4])
def test_engine_equals_jax_engine_and_single(dna, rng, n_dev):
    kmers = [random_kmer(rng, int(rng.integers(1, 9)), DNA) for _ in range(60)]
    eng = dna.port(n_dev)
    got = eng.count(kmers)
    np.testing.assert_array_equal(got, dna.single.count(kmers))
    np.testing.assert_array_equal(got, dna.jax_sharded(n_dev).count(kmers))
    hits = eng.locate(kmers[:16])
    assert_locates_equal(hits, dna.single.locate(kmers[:16]))
    assert_locates_equal(hits, dna.jax_sharded(n_dev).locate(kmers[:16]))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_amino_engine_equals_single(amino, rng, wide):
    kmers = [random_kmer(rng, int(rng.integers(2, 6)), AMINO) for _ in range(40)]
    eng = amino.port(3, wide)
    np.testing.assert_array_equal(eng.count(kmers), amino.single.count(kmers))
    assert_locates_equal(eng.locate(kmers[:10]), amino.single.locate(kmers[:10]))


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_backtrace_routes_each_lane_once(dna, wide):
    """``last_backtrace["routed_lanes"]``: each step routes at most its
    batch's lanes, one shard each, and exactly the lanes not yet at a
    sample; n launches a step over them, not n x B."""
    eng = dna.port(4, wide)
    pos = np.arange(dna.p.bwt_length, dtype=np.uint64)
    np.testing.assert_array_equal(eng.resolve_positions(pos),
                                  dna.single.resolve_positions(pos))
    bt = eng.last_backtrace
    per_step = bt["routed_per_step"]
    assert len(per_step) == bt["lf_steps"] and sum(per_step) == bt["routed_lanes"]
    ratio = dna.p.config.suffix_array_compression_ratio
    assert max(per_step) <= len(pos) and per_step[0] == int((pos % ratio != 0).sum())
    assert bt["routed_lanes"] <= bt["lane_steps"] < 4 * bt["lane_steps"]
    assert bt["launches"] == 4 * bt["lf_steps"]
    # the LF walks: every routed lane-step is one LF step of the single engine
    p = torch.from_numpy(pos.astype(np.int64))
    walked = 0
    while True:
        undone = p % ratio != 0
        if not bool(undone.any()):
            break
        walked += int(undone.sum())
        _, lf = rank.letter_and_lf_plain(dna.p.to_device("cpu", wide=wide), p)
        p = torch.where(undone, lf, p)
    assert walked == bt["routed_lanes"]

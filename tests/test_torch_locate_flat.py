"""Port parity: device-side flat locate and the dense device SA.

``enumerate_flat``, ``locate_flat_device`` and the first-hit locate
against the JAX package's ``enumerate_range_positions``,
``locate_flat_device`` and ``bench.py``'s first-hit stage (masked slots
and a capacity that cuts a range included); ``create_index(
device_sa_ratio=...)`` and ``densify_device_sa`` against the JAX dense
device SA (mirroring tests/test_locate.py). On the CPU the port's K3
wrapper runs its plain version, which K3 equals on the card. Exact:
tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu.search as jsearch
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch import search as psearch

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both, configs

DNA = jx.AlphabetType.DNA


@pytest.fixture(scope="module")
def both():
    """JAX and port engines over one 700-base DNA text at ratio 8, and a
    batch of short k-mers (many hits each) plus an absent one."""
    rng = np.random.default_rng(0x10CA)
    seq = random_sequence(rng, 700, DNA)
    j, p = build_both(seq, 8, 3, DNA)
    je, pe = jx.SearchEngine(j), pt.SearchEngine(p, device="cpu")
    kmers = [random_kmer(rng, int(rng.integers(1, 5)), DNA) for _ in range(40)]
    kmers.append(b"TTTTTTTTTTTT")  # (probably) absent: an invalid range
    ranges = pe.find_ranges(kmers)
    np.testing.assert_array_equal(ranges, je.find_ranges(kmers))
    return je, pe, kmers, ranges


def _jax_ranges(ranges):
    return jnp.asarray(ranges[:, 0].astype(np.uint32)), jnp.asarray(ranges[:, 1].astype(np.uint32))


def _port_ranges(ranges):
    return torch.from_numpy(ranges[:, 0].astype(np.int64)), torch.from_numpy(ranges[:, 1].astype(np.int64))


@pytest.mark.parametrize("cut", [False, True], ids=["full", "capacity-cut"])
def test_enumerate_flat_matches_jax(both, cut):
    _, _, _, ranges = both
    js, je_ = _jax_ranges(ranges)
    ps, pe_ = _port_ranges(ranges)
    total = psearch.total_hits_host(ps, pe_)
    assert total == jsearch.total_hits_host(js, je_)
    cap = total // 3 if cut else total + 37  # a cut drops hits and clamps ranges
    want = jsearch.enumerate_range_positions(js, je_, capacity=cap)
    got = psearch.enumerate_flat(ps, pe_, capacity=cap)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))


def test_enumerate_flat_edge_batches():
    # zero-count queries between hits, an empty batch, and u32 starts
    start = torch.tensor([5, 9, 3, 0, 2**32 - 3], dtype=torch.int64)
    end = torch.tensor([7, 8, 3, 1, 2**32 - 1], dtype=torch.int64)
    for cap in (16, 9, 4):
        want = jsearch.enumerate_range_positions(
            jnp.asarray(start.numpy().astype(np.uint32)), jnp.asarray(end.numpy().astype(np.uint32)),
            capacity=cap,
        )
        got = psearch.enumerate_flat(start, end, capacity=cap)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    pos, qid, mask = psearch.enumerate_flat(start[:0], end[:0], capacity=8)
    assert pos.shape == qid.shape == mask.shape == (8,) and not mask.any()


@pytest.mark.parametrize("cut", [False, True], ids=["full", "capacity-cut"])
def test_locate_flat_device_matches_jax(both, cut):
    je, pe, kmers, ranges = both
    js, je_ = _jax_ranges(ranges)
    ps, pe_ = _port_ranges(ranges)
    total = psearch.total_hits_host(ps, pe_)
    cap = total // 2 if cut else jsearch._round_up_pow2(total, floor=64)
    want = jsearch.locate_flat_device(je.dev, js, je_, capacity=cap)
    got = psearch.locate_flat_device(pe.dev, ps, pe_, capacity=cap)
    # every slot, the masked ones (which resolve position 0) included
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(g.numpy().dtype))
    if not cut:
        hits, qid, mask = (t.numpy() for t in got)
        assert mask.sum() == total
        for q, lst in enumerate(pe.locate(kmers)):
            np.testing.assert_array_equal(hits[mask & (qid == q)].astype(np.uint64), lst)


def test_locate_first_hit_matches_jax(both):
    je, pe, _, ranges = both
    js, je_ = _jax_ranges(ranges)
    # bench.py:519-527
    valid = js <= je_
    pos = jnp.where(valid, js, jnp.uint32(0))
    p, off = jsearch.backtrace_all(je.dev, pos)
    want = jnp.where(valid, jsearch._resolve_samples(je.dev, p, off), jnp.uint32(0))
    got = psearch.locate_first_hit(pe.dev, *_port_ranges(ranges))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).astype(np.int64))


def test_flat_locate_needs_resident_sa(tmp_path):
    seq = random_sequence(np.random.default_rng(2), 400, DNA)
    _, pcfg = configs(4, 2, DNA, keep_suffix_array_in_memory=False)
    p = pt.create_index(seq, pcfg, file_src=str(tmp_path / "d.awfmi"), device="cpu")
    dev = p.to_device("cpu")
    s = torch.tensor([1], dtype=torch.int64)
    with pytest.raises(ValueError, match="suffix array"):
        psearch.locate_flat_device(dev, s, s, capacity=8)
    with pytest.raises(ValueError, match="suffix array"):
        psearch.locate_first_hit(dev, s, s)


def test_dense_device_sa_parity(tmp_path):
    """create_index(device_sa_ratio=r) changes only the device-side SA:
    byte-identical .awfmi, the JAX device SA, equal count/locate
    (tests/test_locate.py:251-283)."""
    rng = np.random.default_rng(0xD5A)
    seq = random_sequence(rng, 3000, DNA)
    jcfg, pcfg = configs(8, 3, DNA)
    jpath, plain_path, dense_path = (str(tmp_path / f) for f in ("j.awfmi", "p.awfmi", "d.awfmi"))
    jdense = jx.create_index(seq, jcfg, file_src=jpath, device_sa_ratio=2)
    plain = pt.create_index(seq, pcfg, file_src=plain_path, device="cpu")
    dense = pt.create_index(seq, pcfg, file_src=dense_path, device_sa_ratio=2, device="cpu")
    data = open(jpath, "rb").read()
    assert open(plain_path, "rb").read() == data == open(dense_path, "rb").read()

    dev = dense.to_device("cpu")
    assert dev.ratio == 2 and dense.device_sa_ratio == 2
    assert dev.sampled_sa.shape[0] == (dense.bwt_length + 1) // 2
    np.testing.assert_array_equal(
        dev.sampled_sa.numpy().view(np.uint32), np.asarray(jdense.to_device().sampled_sa)
    )
    assert plain.to_device("cpu").ratio == 8

    kmers = [random_kmer(rng, int(rng.integers(2, 9)), DNA) for _ in range(80)]
    je = jx.SearchEngine(jdense)
    e_dense = pt.SearchEngine(dense, device="cpu")
    np.testing.assert_array_equal(e_dense.count(kmers), je.count(kmers))
    assert_locates_equal(e_dense.locate(kmers), je.locate(kmers))
    instant = pt.create_index(seq, pcfg, device_sa_ratio=1, device="cpu")
    assert instant.to_device("cpu").ratio == 1
    assert_locates_equal(pt.SearchEngine(instant, device="cpu").locate(kmers), je.locate(kmers))


def test_densify_on_load_matches_build_time_dense(tmp_path):
    """densify_device_sa(2, chunk=512) on a file-loaded index gives the
    JAX build-time dense SA (tests/test_locate.py:285-315)."""
    rng = np.random.default_rng(0xDE5)
    seq = random_sequence(rng, 3000, DNA)
    jcfg, pcfg = configs(8, 3, DNA)
    path = str(tmp_path / "d.awfmi")
    jdense = jx.create_index(seq, jcfg, device_sa_ratio=2)
    pt.create_index(seq, pcfg, file_src=path, device="cpu")
    loaded = pt.read_index_from_file(path)
    assert loaded.to_device("cpu").ratio == 8
    dense_dev = loaded.densify_device_sa(2, chunk=512, device="cpu")  # several chunks
    assert dense_dev.ratio == 2 and loaded.device_sa_ratio == 2
    np.testing.assert_array_equal(
        dense_dev.sampled_sa.numpy().view(np.uint32), np.asarray(jdense.to_device().sampled_sa)
    )
    # the device view is replaced: engines built afterwards see it
    assert loaded.to_device("cpu") is dense_dev
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), DNA) for _ in range(60)]
    je = jx.SearchEngine(jdense)
    e = pt.SearchEngine(loaded, device="cpu")
    np.testing.assert_array_equal(e.count(kmers), je.count(kmers))
    assert_locates_equal(e.locate(kmers), je.locate(kmers))


def test_densify_ratios_and_validation(tmp_path):
    """Ratios 1 and 3 equal JAX's densify; the same ratio is a no-op; bad
    ratios and positions >= 2^32 raise (tests/test_locate.py:318-345)."""
    rng = np.random.default_rng(0xDE6)
    seq = random_sequence(rng, 1500, DNA)
    jcfg, pcfg = configs(8, 3, DNA)
    jpath, ppath = str(tmp_path / "j.awfmi"), str(tmp_path / "p.awfmi")
    jx.create_index(seq, jcfg, file_src=jpath)
    pt.create_index(seq, pcfg, file_src=ppath, device="cpu")
    for ratio in (1, 3):
        want = jx.read_index_from_file(jpath).densify_device_sa(ratio)
        got = pt.read_index_from_file(ppath).densify_device_sa(ratio, device="cpu")
        assert got.ratio == ratio
        np.testing.assert_array_equal(got.sampled_sa.numpy().view(np.uint32), np.asarray(want.sampled_sa))
    loaded = pt.read_index_from_file(ppath)
    dev8 = loaded.to_device("cpu")
    assert loaded.densify_device_sa(8, device="cpu") is dev8
    with pytest.raises(ValueError, match="ratio"):
        loaded.densify_device_sa(0, device="cpu")
    on_disk = pt.read_index_from_file(ppath, keep_suffix_array_in_memory=False)
    with pytest.raises(ValueError, match="suffix array"):
        on_disk.densify_device_sa(2, device="cpu")
    # a wide view densifies through the same pass, to the same values
    narrow2 = loaded.densify_device_sa(2, device="cpu")
    fresh = pt.read_index_from_file(ppath)
    wide2 = fresh.densify_device_sa(2, device="cpu", wide=True)
    assert wide2.wide and wide2.ratio == 2 and wide2.sampled_sa.dtype == torch.int64
    np.testing.assert_array_equal(
        wide2.sampled_sa.numpy(), narrow2.sampled_sa.numpy().view(np.uint32).astype(np.int64)
    )
    # an installed wide view is densified as it is (no width given)
    assert fresh.densify_device_sa(4, device="cpu").wide

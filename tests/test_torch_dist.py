"""Port parity: the query-parallel engine (parallel/dist.py).

Every case of tests/test_dist.py runs through both packages — the JAX
engine on a ``make_query_mesh(n)`` of the 8 virtual CPU devices, the
port's over ``["cpu"] * n`` — with tolerance 0. The step-loop knobs of
the JAX engine do not carry over; the cases that forced them become
plain parity cases on the same inputs (the AC-repeat corpus whose ranges
outgrow the pair window, a 6-device list). Added: n = 1, 2, 3, 8 against
the JAX engine, narrow, forced wide and with the suffix array on disk;
the device list itself and the replicated counts.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.parallel import dist as jdist
from avxwindowfmindex_tpu_torch.parallel import dist as pdist

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, configs

DNA = jx.AlphabetType.DNA


def _cfgs():
    return configs(4, 3, DNA)


class Built:
    """One text indexed by both packages (the port's index twice: one
    for the narrow views, one for forced-wide views). The JAX engines are
    made once for each (list length, width) and shared by the cases."""

    def __init__(self, seq):
        jcfg, pcfg = _cfgs()
        self.seq = seq
        self.j = jx.create_index(seq, jcfg)
        self.p = pt.create_index(seq, pcfg, device="cpu")
        self.pw = pt.create_index(seq, pcfg, device="cpu")
        self._jax = {}

    def jax_dist(self, n, wide=False):
        if (n, wide) not in self._jax:
            view = self.j.to_device(refresh=True, wide=True) if wide else self.j
            self._jax[n, wide] = jdist.DistributedSearchEngine(view, jdist.make_query_mesh(n))
            self.j._device_cache = None
        return self._jax[n, wide]

    def port_dist(self, n, wide=False):
        view = self.pw.to_device("cpu", wide=True) if wide else self.p
        return pdist.DistributedSearchEngine(view, ["cpu"] * n)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    return Built(random_sequence(rng, 3000, DNA))


@pytest.fixture(scope="module")
def ac_built():
    # low-complexity corpus: seeded ranges stay wider than the pair window
    rng = np.random.default_rng(11)
    return Built(bytes(rng.choice(np.frombuffer(b"AC", np.uint8), size=4000)))


def ac_kmers(rng):
    return [b"ACACACAC", b"AAAA", b"CCCCCC", b"ACAC", b"CACA"] + [
        random_kmer(rng, int(rng.integers(3, 8)), DNA) for _ in range(40)
    ]


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_count_matches_single_device(built, rng, n_dev):
    kmers = [random_kmer(rng, int(rng.integers(1, 9)), DNA) for _ in range(100)]
    got = built.port_dist(n_dev).count(kmers)
    np.testing.assert_array_equal(got, built.jax_dist(n_dev).count(kmers))
    np.testing.assert_array_equal(got, pt.SearchEngine(built.p, device="cpu").count(kmers))


def test_sharded_locate_matches_single_device(built, rng):
    kmers = [random_kmer(rng, int(rng.integers(2, 7)), DNA) for _ in range(40)]
    got = built.port_dist(8).locate(kmers)
    assert_locates_equal(got, built.jax_dist(8).locate(kmers))
    assert_locates_equal(got, pt.SearchEngine(built.p, device="cpu").locate(kmers))


def test_count_replicated_allgather(built, rng):
    kmers = [random_kmer(rng, 6, DNA) for _ in range(64)]
    eng = built.port_dist(8)
    got = eng.count_replicated(kmers)
    np.testing.assert_array_equal(got, built.jax_dist(8).count_replicated(kmers))
    np.testing.assert_array_equal(got, pt.SearchEngine(built.p, device="cpu").count(kmers))
    # every device of the list holds the whole padded counts vector
    assert list(eng.replicated_counts) == [torch.device("cpu")]
    assert eng.replicated_counts[torch.device("cpu")].shape == (eng._pad_batch(64),)
    for dist in (eng, built.jax_dist(8)):
        with pytest.raises(ValueError, match="seed-eligible"):
            dist.count_replicated([b"AC", b"ACGT"])


def test_sharded_locate_with_on_disk_sa(disk_built, rng):
    """keep_suffix_array_in_memory=False: the backtrace runs split over
    the devices, only the packed-SA reads on the host, and the hits equal
    the in-memory answers of both packages."""
    assert disk_built.p.sampled_sa is None
    eng = pdist.DistributedSearchEngine(disk_built.p, ["cpu"] * 8)
    kmers = [random_kmer(rng, int(rng.integers(2, 7)), DNA) for _ in range(40)]
    calls = []
    real = pdist.backtrace_resolve

    def spy(view, positions):
        calls.append(positions.shape[0])
        return real(view, positions)

    with mock.patch.object(pdist, "backtrace_resolve", spy):
        got = eng.locate(kmers)
    assert len(calls) == 8, "one backtrace per device part"
    assert sum(calls) == sum(len(h) for h in got), "each part enumerates its own hits"
    assert_locates_equal(got, disk_built.jax_dist(8).locate(kmers))
    assert_locates_equal(got, jx.SearchEngine(disk_built.j_mem).locate(kmers))


def test_locate_keeps_ranges_on_each_device(built, rng):
    """Each part runs K2, the enumerate and K3 on its own device: nothing
    of more than one element is read back to the host before the last
    part's backtrace, and then only the hits and counts."""
    eng = built.port_dist(3)
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), DNA) for _ in range(50)]
    events = []
    real_k2, real_k3 = pdist.search_ranges, pdist.backtrace_resolve
    real_cpu, real_numpy = torch.Tensor.cpu, torch.Tensor.numpy

    def k2(*a):
        events.append("k2")
        return real_k2(*a)

    def k3(*a):
        events.append("k3")
        return real_k3(*a)

    def host(real):
        def read(t, *a, **kw):
            if t.numel() > 1:
                events.append("host")
            return real(t, *a, **kw)
        return read

    with mock.patch.object(pdist, "search_ranges", k2), \
            mock.patch.object(pdist, "backtrace_resolve", k3), \
            mock.patch.object(torch.Tensor, "cpu", host(real_cpu)), \
            mock.patch.object(torch.Tensor, "numpy", host(real_numpy)):
        got = eng.locate(kmers)
    assert events.count("k2") == events.count("k3") == 3
    last_k3 = max(i for i, e in enumerate(events) if e == "k3")
    assert "host" not in events[:last_k3] and "host" in events[last_k3:]
    assert_locates_equal(got, pt.SearchEngine(built.p, device="cpu").locate(kmers))


def test_mixed_eligibility_sharded(built):
    kmers = [b"ACGT", b"AC", b"ACGNT", b"TTTTTTT", b"x", b"GATTACA"]
    got = built.port_dist(4).count(kmers)
    np.testing.assert_array_equal(got, built.jax_dist(4).count(kmers))
    np.testing.assert_array_equal(got, pt.SearchEngine(built.p, device="cpu").count(kmers))


def test_dist_steploop_matches(built, rng):
    """The JAX case forces its GSPMD step loop; the port has one path,
    held to the JAX engine's default on the same kmers."""
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), DNA) for _ in range(80)]
    np.testing.assert_array_equal(built.port_dist(8).count(kmers), built.jax_dist(8).count(kmers))


def test_dist_steploop_pair_fixup_on_nonpow2_list(ac_built, rng):
    """A 6-device list (the pow2 batch is not divisible by 6) on a corpus
    whose ranges outgrow the pair window: padding keeps the parts equal
    and the answers exact."""
    kmers = ac_kmers(rng)
    eng = ac_built.port_dist(6)
    assert eng._pad_batch(64) == 66
    got = eng.count(kmers)
    np.testing.assert_array_equal(got, ac_built.jax_dist(6).count(kmers))
    np.testing.assert_array_equal(got, pt.SearchEngine(ac_built.p, device="cpu").count(kmers))


def test_dist_wide_matches_single_device(built, rng):
    """A forced-wide view runs split over the devices: count, locate and
    count_replicated equal the narrow single-device engine and the JAX
    wide engine."""
    eng = built.port_dist(4, wide=True)
    assert eng.wide and all(v.wide for v in eng.replicas)
    single = pt.SearchEngine(built.p, device="cpu")
    kmers = [random_kmer(rng, int(rng.integers(2, 12)), DNA) for _ in range(64)]
    np.testing.assert_array_equal(eng.count(kmers), single.count(kmers))
    np.testing.assert_array_equal(eng.count(kmers), built.jax_dist(4, wide=True).count(kmers))
    assert_locates_equal(eng.locate(kmers[:16]), single.locate(kmers[:16]))
    eligible = [random_kmer(rng, 8, DNA) for _ in range(24)]
    np.testing.assert_array_equal(eng.count_replicated(eligible), single.count(eligible))


def test_dist_wide_steploop_pair_fixup(ac_built, rng):
    kmers = ac_kmers(rng)
    got = ac_built.port_dist(6, wide=True).count(kmers)
    np.testing.assert_array_equal(got, ac_built.jax_dist(6, wide=True).count(kmers))
    np.testing.assert_array_equal(got, pt.SearchEngine(ac_built.p, device="cpu").count(kmers))


def test_dist_wide_count_replicated(built, ac_built, rng):
    for b in (built, ac_built):
        kmers = [b"ACACACAC", b"AAAACCCC", b"CACACACA", b"ACGTACGT"] + [
            random_kmer(rng, 8, DNA) for _ in range(20)
        ]
        got = b.port_dist(4, wide=True).count_replicated(kmers)
        np.testing.assert_array_equal(got, b.jax_dist(4, wide=True).count_replicated(kmers))
        np.testing.assert_array_equal(got, pt.SearchEngine(b.p, device="cpu").count(kmers))


# ---------------------------------------------------------------------------
# every list length against the JAX engine on the mesh of that size
# ---------------------------------------------------------------------------

class DiskBuilt:
    """One text indexed by both packages with the suffix array left on
    disk, and the JAX index with it in memory."""

    def __init__(self, seq, path):
        jcfg, pcfg = _cfgs()
        self.j_mem = jx.create_index(seq, jcfg, file_src=path + ".jax")
        pt.create_index(seq, pcfg, file_src=path, device="cpu")
        self.p = pt.read_index_from_file(path, keep_suffix_array_in_memory=False)
        self.j = jx.read_index_from_file(path + ".jax", keep_suffix_array_in_memory=False)
        self._jax = {}

    def jax_dist(self, n):
        if n not in self._jax:
            self._jax[n] = jdist.DistributedSearchEngine(self.j, jdist.make_query_mesh(n))
        return self._jax[n]


@pytest.fixture(scope="module")
def disk_built(tmp_path_factory):
    rng = np.random.default_rng(23)
    return DiskBuilt(random_sequence(rng, 2000, DNA),
                     str(tmp_path_factory.mktemp("dist") / "d.awfmi"))


@pytest.mark.parametrize("mode", ["narrow", "wide", "on-disk"])
@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_every_list_length_against_jax(built, disk_built, n, mode):
    rng = np.random.default_rng(100 + n)
    kmers = [random_kmer(rng, int(rng.integers(1, 10)), DNA) for _ in range(37)]
    if mode == "on-disk":
        eng = pdist.DistributedSearchEngine(disk_built.p, ["cpu"] * n)
        jeng = disk_built.jax_dist(n)
    else:
        eng, jeng = built.port_dist(n, wide=mode == "wide"), built.jax_dist(n, wide=mode == "wide")
    assert eng.n_dev == n and len(eng.replicas) == n
    np.testing.assert_array_equal(eng.count(kmers), jeng.count(kmers))
    assert_locates_equal(eng.locate(kmers), jeng.locate(kmers))
    np.testing.assert_array_equal(eng.find_ranges(kmers), jeng.find_ranges(kmers))


def test_query_mesh_and_replicas(built):
    """The device list: names resolved, truncated to num_devices, the
    default every card (raising without one); a device named twice
    shares one view, and a view moved to another device keeps the wide
    view's one row table shared."""
    assert pdist.make_query_mesh(2, ["cpu", "cpu:0", torch.device("cpu")]) == [
        torch.device("cpu")] * 2
    with pytest.raises(ValueError, match="at least one device"):
        pdist.make_query_mesh(devices=[])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="devices="):
            pdist.make_query_mesh()
        with pytest.raises(RuntimeError, match="devices="):
            pdist.DistributedSearchEngine(built.p)
    eng = built.port_dist(3)
    assert all(v is eng.dev for v in eng.replicas)
    wide = built.pw.to_device("cpu", wide=True)
    moved = pdist.replicate_index(wide, torch.device("meta"))
    assert moved.packed is moved.packed_pair and moved.packed.device.type == "meta"
    assert moved.seed_table.device.type == "meta" and moved.wide
    assert pdist.replicate_index(wide, torch.device("cpu")) is wide

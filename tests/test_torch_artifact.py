"""Port parity: the native .awfmx artifact (io/artifact.py).

Every case of tests/test_artifact.py runs through both packages — JAX on
the CPU, the port on ``device="cpu"`` — and the two are compared, field
for field and answer for answer, with tolerance 0. Files cross both ways:
a file written by either package loads in the other to an equal
``FmIndex``, including a file without the seed table (rebuilt by the
loader's BFS) and the v1/v2/v3 version gate.
"""

import numpy as np
import pytest

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.io import artifact as jart
from avxwindowfmindex_tpu.ops import ngram as jngram
from avxwindowfmindex_tpu_torch.io import artifact as part
from avxwindowfmindex_tpu_torch.ops import ngram as pngram

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, build_both, configs

DNA = jx.AlphabetType.DNA


def assert_fmindex_equal(a, b) -> None:
    """Two FmIndexes (of either package) equal array for array and field
    for field: what the .awfmx format carries."""
    for f in ("suffix_array_compression_ratio", "kmer_length_in_seed_table",
              "keep_suffix_array_in_memory", "store_original_sequence"):
        assert getattr(a.config, f) == getattr(b.config, f), f
    assert int(a.config.alphabet_type) == int(b.config.alphabet_type)
    for f in ("bwt_length", "version_number", "feature_flags", "sa_guard_bytes",
              "sequence", "device_sa_ratio"):
        assert getattr(a, f) == getattr(b, f), f
    for f in ("bwt_letters", "prefix_sums", "sampled_sa", "kmer_seed_table", "device_sa"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
    assert (a.fasta_metadata is None) == (b.fasta_metadata is None)
    if a.fasta_metadata is not None:
        assert a.fasta_metadata.headers == b.fasta_metadata.headers
        np.testing.assert_array_equal(a.fasta_metadata.header_ends, b.fasta_metadata.header_ends)
        np.testing.assert_array_equal(a.fasta_metadata.sequence_ends,
                                      b.fasta_metadata.sequence_ends)


def counts_equal(j, p, kmers) -> None:
    np.testing.assert_array_equal(
        pt.SearchEngine(p, device="cpu").count(kmers), jx.SearchEngine(j).count(kmers)
    )


@pytest.mark.parametrize("alphabet", [DNA, jx.AlphabetType.AMINO], ids=lambda a: a.name)
def test_artifact_roundtrip(rng, tmp_path, alphabet):
    seq = random_sequence(rng, 600, alphabet)
    j, p = build_both(seq, 4, 3, alphabet)
    jpath, ppath = str(tmp_path / "j.awfmx.npz"), str(tmp_path / "p.awfmx.npz")
    jart.save_artifact(j, jpath)
    part.save_artifact(p, ppath)
    jl, pl = jart.load_artifact(jpath), part.load_artifact(ppath, device="cpu")
    assert_fmindex_equal(pl, jl)
    assert_fmindex_equal(pl, p)
    kmers = [random_kmer(rng, 4, alphabet) for _ in range(20)]
    counts_equal(jl, pl, kmers)
    counts_equal(j, pl, kmers)


def test_artifact_uncompressed_roundtrip(rng, tmp_path):
    seq = random_sequence(rng, 600, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    jpath, ppath = str(tmp_path / "j.awfmx"), str(tmp_path / "p.awfmx")
    jart.save_artifact(j, jpath, compress=False)
    part.save_artifact(p, ppath, compress=False)
    with np.load(ppath) as z:  # a plain NPZ: every member stored, none deflated
        assert all(info.compress_type == 0 for info in z.zip.infolist())
    jl, pl = jart.load_artifact(jpath), part.load_artifact(ppath, device="cpu")
    assert_fmindex_equal(pl, jl)
    counts_equal(jl, pl, [random_kmer(rng, 4, DNA) for _ in range(10)])


def test_artifact_with_fasta_metadata(tmp_path):
    fasta = tmp_path / "m.fasta"
    fasta.write_text(">one\nGATTACA\n>two\nACGTACGT\n")
    jcfg, pcfg = configs(2, 2, DNA)
    j = jx.create_index_from_fasta(str(fasta), jcfg)
    p = pt.create_index_from_fasta(str(fasta), pcfg, device="cpu")
    jpath, ppath = str(tmp_path / "j.awfmx.npz"), str(tmp_path / "p.awfmx.npz")
    jart.save_artifact(j, jpath)
    part.save_artifact(p, ppath)
    jl, pl = jart.load_artifact(jpath), part.load_artifact(ppath, device="cpu")
    assert_fmindex_equal(pl, jl)
    assert pl.num_sequences() == 2 and pl.get_header(1) == b"two" == jl.get_header(1)
    seqn, local = pl.get_local_sequence_position(8)
    assert (int(seqn), int(local)) == (1, 1)


def test_artifact_plain_awfmx_extension_roundtrip(rng, tmp_path):
    """save_artifact('x.awfmx') loads as 'x.awfmx': written through a
    file object, so numpy appends no '.npz'."""
    seq = random_sequence(rng, 1200, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    path = tmp_path / "plain.awfmx"
    pt.save_artifact(p, str(path))
    assert path.exists() and not (tmp_path / "plain.awfmx.npz").exists()
    loaded = pt.load_artifact(str(path), device="cpu")
    counts_equal(j, loaded, [random_kmer(rng, 6, DNA) for _ in range(20)])


def test_artifact_preserves_device_sa(rng, tmp_path):
    """The dense device-only SA survives the round trip, and the view a
    loaded index builds prefers it, as before the save."""
    seq = random_sequence(rng, 800, DNA)
    j, p = build_both(seq, 8, 3, DNA, device_sa_ratio=2)
    assert p.device_sa is not None
    jpath, ppath = str(tmp_path / "j.awfmx"), str(tmp_path / "p.awfmx")
    jart.save_artifact(j, jpath)
    part.save_artifact(p, ppath)
    jl, pl = jart.load_artifact(jpath), part.load_artifact(ppath, device="cpu")
    assert_fmindex_equal(pl, jl)
    assert pl.device_sa_ratio == p.device_sa_ratio == 2
    assert pl.to_device("cpu").ratio == 2
    kmers = [random_kmer(rng, 5, DNA) for _ in range(20)]
    assert_locates_equal(pt.SearchEngine(pl, device="cpu").locate(kmers),
                         jx.SearchEngine(jl).locate(kmers))


def test_ngram_build_cache_roundtrip(rng, tmp_path):
    """build_ngram_device(cache_path=...) reloads its own rows bit for bit,
    serves them to the JAX package, and refuses a stale file (prebias, n
    or corpus differ)."""
    seq = random_sequence(rng, 700, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    path = str(tmp_path / "ng.npz")
    fresh = pngram.build_ngram_device(p, 2, device="cpu", cache_path=path)
    cached = pngram.build_ngram_device(p, 2, device="cpu", cache_path=path)
    assert cached.packed.numpy().tobytes() == fresh.packed.numpy().tobytes()
    assert cached.biased == fresh.biased
    jcached = jngram.build_ngram_device(j, 2, cache_path=path)
    assert np.asarray(jcached.packed).tobytes() == fresh.packed.numpy().tobytes()
    other = pngram.build_ngram_device(p, 2, device="cpu", bias_cn=not fresh.biased, cache_path=path)
    assert other.biased == (not fresh.biased)
    tri = pngram.build_ngram_device(p, 3, device="cpu", cache_path=path)
    assert tri.n == 3 and tuple(tri.packed.shape) != tuple(fresh.packed.shape)
    _, p2 = build_both(random_sequence(rng, 900, DNA), 4, 3, DNA)
    crossed = pngram.build_ngram_device(p2, 2, device="cpu", cache_path=path)
    assert crossed.packed.shape[0] != fresh.packed.shape[0]


def _rewrite(path, payload):
    with open(path, "wb") as fh:
        np.savez(fh, **payload)


def test_artifact_version_gate(rng, tmp_path):
    """New files stamp v3 with u32 SA arrays on a narrow index; both
    loaders accept v1-v3 of one file to the same index and reject v4 by
    number."""
    seq = random_sequence(rng, 600, DNA)
    j, p = build_both(seq, 4, 3, DNA)
    path = str(tmp_path / "v.awfmx")
    part.save_artifact(p, path)
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    assert int(payload["format_version"]) == part._FORMAT_VERSION == jart._FORMAT_VERSION == 3
    assert part._READABLE_VERSIONS == jart._READABLE_VERSIONS == (1, 2, 3)
    assert payload["sampled_sa"].dtype == np.uint32
    payload["sampled_sa"] = payload["sampled_sa"].astype(np.uint64)
    for version in (2, 1):
        payload["format_version"] = np.int64(version)
        _rewrite(path, payload)
        pl, jl = part.load_artifact(path, device="cpu"), jart.load_artifact(path)
        assert pl.sampled_sa.dtype == np.uint64
        np.testing.assert_array_equal(pl.sampled_sa, p.sampled_sa)
        assert_fmindex_equal(pl, jl)
    payload["format_version"] = np.int64(4)
    _rewrite(path, payload)
    for load in (lambda: part.load_artifact(path, device="cpu"), lambda: jart.load_artifact(path)):
        with pytest.raises(ValueError, match="version 4"):
            load()


def test_artifact_without_host_seed_table(rng, tmp_path):
    """An index whose seed table lives only in the device view (a build on
    the card) saves WITHOUT it; load_artifact rebuilds it by the BFS on
    the device asked for, to the table the JAX package holds."""
    seq = random_sequence(rng, 900, DNA)
    j, p = build_both(seq, 4, 4, DNA)
    kmers = [random_kmer(rng, 6, DNA) for _ in range(30)]
    want = jx.SearchEngine(j).count(kmers)
    p.kmer_seed_table = None  # the state an index built on the card is in
    path = str(tmp_path / "ns.awfmx")
    part.save_artifact(p, path)
    with np.load(path) as z:
        assert "kmer_seed_table" not in z
    loaded = part.load_artifact(path, device="cpu")
    assert loaded._device_cache.device.type == "cpu"
    np.testing.assert_array_equal(loaded.kmer_seed_table, j.kmer_seed_table)
    np.testing.assert_array_equal(pt.SearchEngine(loaded, device="cpu").count(kmers), want)


# ---------------------------------------------------------------------------
# files crossed between the packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", ["plain", "dense-sa", "amino-noseq"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_artifact_crosses_packages(tmp_path, writer, case):
    """A file written by either package loads in the other to an index
    equal array for array and field for field, and the loaded index
    answers as the writer's."""
    rng = np.random.default_rng(0xA7F + len(case))
    alphabet = jx.AlphabetType.AMINO if case.startswith("amino") else DNA
    seq = random_sequence(rng, 1500, alphabet)
    kw = {"device_sa_ratio": 2} if case == "dense-sa" else {}
    jcfg, pcfg = configs(4, 3, alphabet, store_original_sequence=case != "amino-noseq")
    j = jx.create_index(seq, jcfg, **kw)
    p = pt.create_index(seq, pcfg, device="cpu", **kw)
    path = str(tmp_path / "x.awfmx")
    if writer == "jax":
        jart.save_artifact(j, path)
        loaded = part.load_artifact(path, device="cpu")
    else:
        part.save_artifact(p, path)
        loaded = jart.load_artifact(path)
    assert_fmindex_equal(loaded, j)
    assert_fmindex_equal(loaded, p)
    kmers = [seq[s : s + 6] for s in rng.integers(0, 1490, 40)]
    if writer == "jax":
        assert_locates_equal(pt.SearchEngine(loaded, device="cpu").locate(kmers),
                             jx.SearchEngine(j).locate(kmers))
    else:
        assert_locates_equal(jx.SearchEngine(loaded).locate(kmers),
                             pt.SearchEngine(p, device="cpu").locate(kmers))


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_omitted_seed_table_crosses_packages(rng, tmp_path, writer):
    """A file without the seed table, from either package, is rebuilt by
    the other's loader to the same table."""
    seq = random_sequence(rng, 1000, DNA)
    j, p = build_both(seq, 4, 4, DNA)
    want = j.kmer_seed_table.copy()
    path = str(tmp_path / "ns.awfmx")
    if writer == "jax":
        j.kmer_seed_table = None
        jart.save_artifact(j, path)
        loaded = part.load_artifact(path, device="cpu")
    else:
        p.kmer_seed_table = None
        part.save_artifact(p, path)
        loaded = jart.load_artifact(path)
        loaded.seed_table_host()
    with np.load(path) as z:
        assert "kmer_seed_table" not in z
    np.testing.assert_array_equal(loaded.kmer_seed_table, want)


def test_pull_device_seed_table(rng, tmp_path):
    """``pull_device_seed_table`` writes a table that lives only in the
    device view; the file then loads with no BFS and no device."""
    seq = random_sequence(rng, 800, DNA)
    j, p = build_both(seq, 4, 4, DNA)
    p.kmer_seed_table = None
    path = str(tmp_path / "pull.awfmx")
    part.save_artifact(p, path, pull_device_seed_table=True)
    with np.load(path) as z:
        np.testing.assert_array_equal(z["kmer_seed_table"], j.kmer_seed_table)
    loaded = part.load_artifact(path)  # no device: nothing to build
    assert loaded._device_cache is None
    assert_fmindex_equal(loaded, jart.load_artifact(path))


def test_load_without_device_rebuild_refuses_the_cpu(rng, tmp_path):
    """A file that needs its seed table rebuilt, loaded with no device,
    targets the card; without one it raises naming device= and does not
    carry on on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would use it")
    _, p = build_both(random_sequence(rng, 600, DNA), 4, 3, DNA)
    p.kmer_seed_table = None
    path = str(tmp_path / "ns.awfmx")
    part.save_artifact(p, path)
    with pytest.raises(RuntimeError, match="device="):
        part.load_artifact(path)
    with pytest.raises(RuntimeError, match="device="):
        pt.load_artifact(path)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_narrowed_keeps_u64_at_2_pow_32(dtype):
    """SA values are stored u32 only below 2^32 positions: at bwtLength
    2^32 both packages keep u64 (and leave u32 input as it is)."""
    values = np.array([0, 7, 2**32 - 1], dtype=dtype)
    for mod in (part, jart):
        wide = mod._narrowed(values, 2**32)
        assert wide.dtype == dtype and wide is values
        narrow = mod._narrowed(values, 2**32 - 1)
        assert narrow.dtype == np.uint32
        np.testing.assert_array_equal(narrow, values)
    big = np.array([2**32 + 5], dtype=np.uint64)
    assert part._narrowed(big, 2**33).dtype == jart._narrowed(big, 2**33).dtype == np.uint64

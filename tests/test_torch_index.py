"""Port parity: host index model, device tables and convert.py.

The port's ``DeviceIndex`` tensors must hold exactly the bytes of
``np.asarray`` of the JAX ``to_device()`` fields (u32 tables as int32
tensors of the same bytes), and convert.py must carry the JAX arrays
across unchanged. Exact comparison: tolerance 0.
"""

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch.models import convert
from avxwindowfmindex_tpu_torch.models.index import narrow_u32, widen_u32

from oracle import random_sequence
from torch_helpers import DEVICE_FIELDS, build_both, jax_device_arrays, port_device_bytes

CASES = [
    (jx.AlphabetType.DNA, 4, 3, 4000),
    (jx.AlphabetType.DNA, 8, 5, 3001),
    (jx.AlphabetType.AMINO, 8, 2, 2500),
]


@pytest.fixture(scope="module", params=CASES, ids=lambda c: f"{c[0].name}-r{c[1]}-k{c[2]}")
def both(request):
    alphabet, ratio, k, n = request.param
    rng = np.random.default_rng(0x70C4 + n)
    seq = random_sequence(rng, n, alphabet)
    j, p = build_both(seq, ratio, k, alphabet)
    return j, p


def test_device_tables_byte_equal(both):
    j, p = both
    want = jax_device_arrays(j)
    got = port_device_bytes(p.to_device("cpu"))
    for f in DEVICE_FIELDS:
        assert got[f] == want[f].tobytes(), f
    dev = p.to_device("cpu")
    assert dev.prefix_sums.dtype == torch.int32 and dev.seed_table.dtype == torch.int32
    assert dev.packed.dtype == torch.uint8 and dev.code_masks.dtype == torch.uint8


def test_host_model_equal(both):
    j, p = both
    np.testing.assert_array_equal(p.bwt_letters, j.bwt_letters)
    np.testing.assert_array_equal(p.prefix_sums, j.prefix_sums)
    np.testing.assert_array_equal(p.sampled_sa, j.sampled_sa)
    np.testing.assert_array_equal(p.milestones(), j.milestones())
    np.testing.assert_array_equal(p.seed_table_host(), j.kmer_seed_table)
    assert p.sa_guard_bytes == j.sa_guard_bytes
    assert p.bwt_length == j.bwt_length


def test_convert_device_index_round_trip(both):
    j, p = both
    arrays = jax_device_arrays(j)
    jd = j.to_device()
    dev = convert.device_index_from_numpy(
        arrays, bwt_length=jd.bwt_length, ratio=jd.ratio,
        k=jd.kmer_length_in_seed_table, alphabet=jd.alphabet, device="cpu",
    )
    got = port_device_bytes(dev)
    for f in DEVICE_FIELDS:
        assert got[f] == arrays[f].tobytes(), f
    # the converted view searches like the JAX engine
    rng = np.random.default_rng(3)
    seq = j.sequence
    kmers = [seq[s : s + 6] for s in rng.integers(0, len(seq) - 6, 40)]
    np.testing.assert_array_equal(
        pt.SearchEngine(dev, device="cpu").count(kmers), jx.SearchEngine(j).count(kmers)
    )


def test_convert_fm_index_round_trip(both):
    j, p = both
    fm = convert.fm_index_from_numpy(
        {
            "bwt_letters": j.bwt_letters, "prefix_sums": j.prefix_sums,
            "kmer_seed_table": j.kmer_seed_table, "sampled_sa": j.sampled_sa,
        },
        bwt_length=j.bwt_length,
        ratio=j.config.suffix_array_compression_ratio,
        k=j.config.kmer_length_in_seed_table,
        alphabet=j.config.alphabet_type,
        sequence=j.sequence,
        sa_guard_bytes=j.sa_guard_bytes,
    )
    got = port_device_bytes(fm.to_device("cpu"))
    want = jax_device_arrays(j)
    for f in DEVICE_FIELDS:
        assert got[f] == want[f].tobytes(), f
    assert fm.config == p.config


def test_u32_helpers_wrap():
    vals = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 2**32, -1], dtype=torch.int64)
    n = narrow_u32(vals)
    assert n.dtype == torch.int32
    np.testing.assert_array_equal(
        n.numpy().view(np.uint32), np.array([0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0, 2**32 - 1], np.uint32)
    )
    np.testing.assert_array_equal(
        widen_u32(n).numpy(), [0, 1, 2**31 - 1, 2**31, 2**32 - 1, 0, 2**32 - 1]
    )


def _hollow_index(bwt_length, ratio=8):
    """An FmIndex that claims ``bwt_length`` positions but holds four
    letters: enough for the checks to_device makes before it packs."""
    return pt.FmIndex(
        config=pt.IndexConfiguration(ratio, 2, pt.AlphabetType.DNA), bwt_length=bwt_length,
        bwt_letters=np.zeros(4, np.uint8), prefix_sums=np.zeros(6, np.uint64),
        kmer_seed_table=None, sampled_sa=None,
    )


def test_to_device_rejects_wide_positions():
    # the narrow view still refuses 2^32 positions and names the way out
    with pytest.raises(ValueError, match="2\\*\\*32.*wide=True"):
        _hollow_index(2**32).to_device("cpu", wide=False)
    # the wide view has the JAX package's two upload limits
    with pytest.raises(ValueError, match="2\\^39"):
        _hollow_index(2**39 + 1, ratio=255).to_device("cpu")
    with pytest.raises(ValueError, match="saCompressionRatio < 2\\^31"):
        _hollow_index(2**34, ratio=8).to_device("cpu")
    with pytest.raises(ValueError, match="saCompressionRatio < 2\\^31"):
        _hollow_index(2**31, ratio=1).to_device("cpu", wide=True)


def test_to_device_takes_the_wide_view_from_2_32(monkeypatch):
    """bwtLength >= 2^32 picks the wide view by itself: int64 tables over
    the one table of 256 B rows (the packer is stubbed: 2^24 real rows
    would take 4 GiB)."""
    from avxwindowfmindex_tpu_torch.models import index as index_mod

    fm = _hollow_index(2**32 + 5, ratio=8)
    seen = {}

    def fake_pack(letters, milestones, alphabet, pair=True):
        seen["called"] = pair  # the pair-fused rows
        return np.zeros((2, index_mod.device_row_bytes64(alphabet, pair)), np.uint8)

    monkeypatch.setattr(index_mod, "pack_device_blocks64", fake_pack)
    monkeypatch.setattr(pt.FmIndex, "milestones", lambda self: np.zeros((2, 6), np.uint64))
    dev = fm.to_device("cpu")
    assert seen["called"] and dev.wide and dev.packed is dev.packed_pair
    assert dev.packed.shape[1] == 256 and dev.plane_stride == 64 and dev.milestone_bytes == 8
    assert dev.prefix_sums.dtype == torch.int64 and dev.seed_table.dtype == torch.int64
    assert dev.bwt_length == 2**32 + 5
    assert fm.to_device("cpu") is dev


def test_create_index_rejects_device_sa_ratio():
    # the JAX guards: a ratio below 1 is refused; one no denser than the
    # config ratio is ignored (build.py:105-117 of the JAX package)
    with pytest.raises(ValueError, match="device_sa_ratio"):
        pt.create_index(b"ACGTACGT", pt.IndexConfiguration(8, 2), device_sa_ratio=0, device="cpu")
    idx = pt.create_index(b"ACGTACGT", pt.IndexConfiguration(8, 2), device_sa_ratio=8, device="cpu")
    assert idx.device_sa is None and idx.device_sa_ratio is None
    assert idx.to_device("cpu").ratio == 8


def test_create_index_requires_a_device():
    with pytest.raises(TypeError):
        pt.create_index(b"ACGTACGT", pt.IndexConfiguration(8, 2))


def test_mixed_case_amino_warns():
    cfg = pt.IndexConfiguration(4, 2, pt.AlphabetType.AMINO)
    with pytest.warns(UserWarning, match="mixed-case amino"):
        pt.create_index(b"ACDEFghik", cfg, device="cpu")

"""Port parity: the k-mer seed table, absent k-mers included.

The BFS steps unconditionally (``backward_step(check_valid=False)``), so
an absent k-mer keeps the stepped-through ``start > end`` values that the
reference stores and the ``.awfmi`` bytes depend on. The port's table
must equal the JAX package's entry for entry. Exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
from avxwindowfmindex_tpu_torch.ops import rank as prank
from avxwindowfmindex_tpu_torch.ops import seed_table

from oracle import random_sequence
from torch_helpers import build_both

CASES = [
    (jx.AlphabetType.DNA, 2, 1500),
    (jx.AlphabetType.DNA, 4, 3000),
    (jx.AlphabetType.DNA, 6, 8000),
    (jx.AlphabetType.AMINO, 2, 2000),
    (jx.AlphabetType.AMINO, 3, 4000),
]


@pytest.mark.parametrize("alphabet,k,n", CASES, ids=lambda v: str(getattr(v, "name", v)))
def test_seed_table_equal_including_absent_kmers(alphabet, k, n):
    rng = np.random.default_rng(0x5EED + k * 131 + n)
    seq = random_sequence(rng, n, alphabet)
    j, p = build_both(seq, 8, k, alphabet)
    want = j.kmer_seed_table
    got = p.seed_table_host()
    assert got.shape == want.shape == (j.cardinality**k, 2)
    np.testing.assert_array_equal(got, want)
    if j.cardinality**k * 2 > n:
        # absent k-mers exist and keep their stepped-through (start > end)
        # values, which differ from k-mer to k-mer
        absent = got[got[:, 0] > got[:, 1]]
        assert len(absent) and len(np.unique(absent[:, 0])) > 1
    np.testing.assert_array_equal(
        p.to_device("cpu").seed_table.numpy().view(np.uint32),
        np.asarray(j.to_device().seed_table),
    )


def test_seed_table_chunked_and_plain_agree():
    rng = np.random.default_rng(21)
    seq = random_sequence(rng, 5000, jx.AlphabetType.DNA)
    _, p = build_both(seq, 4, 5, jx.AlphabetType.DNA)
    dev = p.to_device("cpu")
    whole = dev.seed_table
    chunked = seed_table.build_seed_table(dev, 4, 5, p.prefix_sums, chunk=7)
    plain = seed_table.build_seed_table(
        dev, 4, 5, p.prefix_sums, occurrence_fn=prank.occurrence_plain
    )
    assert torch.equal(whole, chunked)
    assert torch.equal(whole, plain)


def test_seed_table_rejects_int32_overflow():
    rng = np.random.default_rng(22)
    seq = random_sequence(rng, 500, jx.AlphabetType.AMINO)
    _, p = build_both(seq, 4, 2, jx.AlphabetType.AMINO)
    with pytest.raises(NotImplementedError, match="exceeds the int32"):
        seed_table.build_seed_table(p.to_device("cpu"), 20, 8, p.prefix_sums)

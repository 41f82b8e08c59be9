"""The yardstick: fixed sizes, peaks and least-time arithmetic.

Everything here is frozen with the benchmark, so a roofline share does
not move when the program changes its own row layouts. Bytes are
counted in the reference library's layout (AvxWindowFmIndex), not in
the port's:

- a BWT block of 256 positions is 160 B (nucleotide) or 352 B (amino),
  ``src/AwFmIndex.h:20,55-65`` of the reference (BASELINE.md);
- a seed-table entry is 16 B, two u64 range ends (``README.md:196-202``:
  4^k x 16 B);
- the sampled suffix array is bit-packed at the width of the largest
  position (``AwFmFile.c``'s compressed SA);
- the inputs as the request hands them over, the outputs as the
  request needs them.

Operations follow the reference's rank step (BASELINE.md: ``<= 4 SIMD
logic ops + 4x 64-bit popcnt`` a step): one 256-bit logic op a bit
plane plus one for the position mask, 8 int32 lanes each, 8 popcount
words and one milestone add, counted as int32 operations.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM, published
INT_OPS_PER_S = 67e12  # float32 outside the tensor cores, standing in for int32
POSITIONS_PER_BLOCK = 256
BLOCK_BYTES = {"dna": 160, "amino": 352}
BIT_PLANES = {"dna": 3, "amino": 5}
CARDINALITY = {"dna": 4, "amino": 20}
SEED_ENTRY_BYTES = 16


def bytes_bound_ms(tables, stream_bytes: int) -> float:
    """Bytes moved once over 3.35 TB/s: ``tables`` (rows, bytes a visit
    needs, visits), distinct rows under uniformly random visits, plus the
    inputs and outputs.

    Frozen copy of ``avxwindowfmindex_tpu_torch/tools/kernel_ab.py:
    bytes_bound_ms`` (the expectation N(1 - exp(-v/N)) of distinct rows
    among v uniform visits of N rows)."""
    once = float(stream_bytes)
    for nb, need, visits in tables:
        once += nb * (1.0 - math.exp(-visits / nb)) * need
    return once / HBM_BYTES_PER_S * 1e3


def kmer_starts(rng, n: int, length: int, count: int):
    """``count`` uniform starts of ``length``-letter windows of an
    ``n``-letter text.

    Frozen copy of the k-mer sampling of ``avxwindowfmindex_tpu_torch/
    tools/bench.py:228-231`` (and ``:325-327``, ``tools/kernel_ab.py:
    _sampled``): starts drawn from ``[0, n - length)``, the windows
    ``seq[start:start + length]``."""
    return rng.integers(0, n - length, size=count)


def num_blocks(bwt_length: int) -> int:
    return 1 + (bwt_length - 1) // POSITIONS_PER_BLOCK


def position_bits(bwt_length: int) -> int:
    """Bits of the largest position (the reference's packed SA width)."""
    return max(1, (bwt_length - 1).bit_length())


def ops_per_visit(alphabet: str) -> int:
    return 8 * (BIT_PLANES[alphabet] + 1) + 8 + 1


def least_ms(tables, stream_bytes: int, visits: int, alphabet: str):
    """(least ms, what bounds it): the larger of the bytes bound and the
    integer operations over 67 TOP/s."""
    by_bytes = bytes_bound_ms(tables, stream_bytes)
    by_ops = visits * ops_per_visit(alphabet) / INT_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "ops")


def ranges_least_ms(*, alphabet: str, bwt_length: int, seed_k: int, queries: int,
                    seeded: int, steps: int, input_bytes: int):
    """The ranges layer of one request: ``steps`` backward steps (one per
    letter after the seed, or after the first letter of an unseeded
    query), each visiting the block of both range ends; one seed-table
    entry a seeded query; the letters as handed over in; two positions a
    query out."""
    nb = num_blocks(bwt_length)
    visits = 2 * steps
    tables = [(nb, BLOCK_BYTES[alphabet], visits)]
    if seeded:
        tables.append((CARDINALITY[alphabet] ** seed_k, SEED_ENTRY_BYTES, seeded))
    out = queries * 2 * math.ceil(position_bits(bwt_length) / 8)
    return least_ms(tables, input_bytes + out, visits, alphabet)


def hits_least_ms(*, alphabet: str, bwt_length: int, sa_ratio: int, queries: int,
                  hits: int):
    """The hits layer of one request: ``sa_ratio - 1`` LF visits a hit
    (the expected walk to a sampled BWT position), one packed SA value a
    hit; two positions a query in, one position a hit out."""
    nb = num_blocks(bwt_length)
    width = position_bits(bwt_length)
    visits = (sa_ratio - 1) * hits
    samples = 1 + (bwt_length - 1) // sa_ratio
    tables = [(nb, BLOCK_BYTES[alphabet], visits), (samples, width / 8, hits)]
    pos_bytes = math.ceil(width / 8)
    stream = queries * 2 * pos_bytes + hits * pos_bytes
    return least_ms(tables, stream, visits, alphabet)

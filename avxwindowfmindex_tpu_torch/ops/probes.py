"""Gather-rate probes: K5 (random row gather + reduce) and K6 (slab gather).

The JAX repository measured how fast a TPU reads random rows with four
Pallas kernels under ``experiments/``:

  P2 ``pallas_gather_bench.py:89``   a ring of K row DMAs in flight over a
                                      1 GiB table of R-byte rows, every
                                      byte of every row summed into one
                                      int32 (wrapping);
  P3 ``pallas_aligned_bench.py:37``  the same ring over 1 KB rows, only
                                      the first 128 B of each summed;
  P4 ``gather_pair_bench.py:137``    the P2 ring with one partial sum per
                                      grid step (CHUNK indices);
  P5 ``ab_r5_pallas_gather.py:85``   a row gather out of an on-chip slab,
                                      chained by ``idx <- (row[0] +
                                      row[37]) mod S``.

K5 (``csrc/awfm_probes.cu``) is the port of P2, P3 and P4: one int32
partial sum per CHUNK of indices (P4's output; P2's and P3's scalar is
their wrapped sum, :func:`wrapped_total`), plus a walk entry that the
bench's calibration runs (``utils/roofline.calibrate_gather_rates``). K6
is the port of P5. Each dispatch wrapper below launches its kernel for
CUDA tensors and runs the plain version beside it for CPU tensors.

An index outside the table is clamped to the last row, as XLA's gather
clamps, in the kernels and the plain versions alike.

``sector_mask`` (the walk entry): the card moves memory in 32 B sectors,
and a search step reads only some of a row's (the first 32 B of each
64 B plane and the milestone word, ``utils/roofline.first_block_sector_mask``).
Bit s of the mask set means that sector s of every visited row, bytes
[32 s, 32 s + 32), is read and enters the sum; the default, all bits,
is ``bench.py``'s walk over whole rows. The calibration walks each table
with the mask of its step, so a rate it measures is one of visits that
touch what a step touches.
"""

from __future__ import annotations

import torch

from ..models.index import MASK32, narrow_u32
from .rank import device_kind

#: Row widths K5 is instantiated for: the experiments' 128, 512 and
#: 1024 B rows and the index's 128, 256 and 384 B tables.
K5_ROW_BYTES = (128, 256, 384, 512, 1024)
#: Row widths K5's walk entry is instantiated for: those and the n = 3 n-gram rows.
K5_WALK_ROW_BYTES = (128, 256, 384, 512, 768, 1024)
#: Lanes a chain of K5's walk: each loads a share of the row's pieces.
K5_WALK_LANES = (1, 4)
#: Ring depths (16 B pieces in flight per lane) K5 is instantiated for.
K5_RING_DEPTHS = (2, 4, 8, 16, 32)
SLAB_LANES = 128  # K6 rows: 128 u32 words = 512 B
ALL_SECTORS = 0xFFFFFFFF


def _clamped(idx: torch.Tensor, nb: int) -> torch.Tensor:
    return idx.to(torch.int64).clamp(0, nb - 1)


# ---------------------------------------------------------------------------
# K5: random row gather + reduce (P2, P3, P4)
# ---------------------------------------------------------------------------

def gather_reduce_plain(table: torch.Tensor, idx: torch.Tensor, sum_bytes: int,
                        chunk: int) -> torch.Tensor:
    """Plain torch version of K5 -> (ceil(n / chunk),) int32.

    Entry c is the int32 (wrapping) sum, over indices c*chunk ..
    (c+1)*chunk - 1, of the first ``sum_bytes`` bytes of each index's
    row of the uint8 table."""
    per_row = table[_clamped(idx, table.shape[0]), :sum_bytes].to(torch.int64).sum(1)
    pad = -per_row.shape[0] % chunk
    per_row = torch.nn.functional.pad(per_row, (0, pad))
    return narrow_u32(per_row.reshape(-1, chunk).sum(1))


def gather_reduce(table: torch.Tensor, idx: torch.Tensor, *, sum_bytes: int,
                  chunk: int, ring: int = 8) -> torch.Tensor:
    """K5 for CUDA tensors, the plain version for CPU ones. ``ring`` (P2's
    K) is the number of 16 B row pieces each lane of the kernel asks for,
    into its registers, before it sums the first: K rows a lane when a
    lane takes one piece of a row (``sum_bytes`` up to 512, 8 to 32 lanes
    a row), K / 2 for a 1 KB sum (32 lanes, two pieces each). The sums do
    not depend on it."""
    if device_kind(table) == "cuda":
        from . import kernels

        return kernels.k5_gather_reduce(table, idx, sum_bytes, chunk, ring)
    return gather_reduce_plain(table, idx, sum_bytes, chunk)


def wrapped_total(partials: torch.Tensor) -> int:
    """The int32 (wrapping) sum of K5's partials: P2's and P3's scalar."""
    t = int(partials.to(torch.int64).sum()) & MASK32
    return t - 2**32 if t >= 2**31 else t


def sector_columns(row_bytes: int, sector_mask: int) -> list:
    """The byte columns of a row that lie in the sectors of ``sector_mask``."""
    return [c for c in range(row_bytes) if (sector_mask >> (c // 32)) & 1]


def gather_walk_plain(table: torch.Tensor, idx: torch.Tensor, seg: int,
                      sector_mask: int = ALL_SECTORS) -> torch.Tensor:
    """Plain torch version of K5's walk entry -> (n,) int32 indices after
    ``seg`` steps of ``idx <- (idx * 1103515245 + sum of the row's bytes
    + 12345) mod nb`` in u32 (``bench.py:_calibrate_gather_rates``), the
    sum over the bytes of the sectors in ``sector_mask``."""
    nb, row_bytes = table.shape
    idx = _clamped(idx, nb)
    cols = sector_columns(row_bytes, sector_mask)
    if len(cols) < row_bytes:
        table = table[:, torch.tensor(cols, dtype=torch.int64, device=table.device)]
    for _ in range(seg):
        s = table[idx].to(torch.int64).sum(1)
        idx = ((idx * 1103515245 + s + 12345) & MASK32) % nb
    return idx.to(torch.int32)


def gather_walk(table: torch.Tensor, idx: torch.Tensor, seg: int,
                sector_mask: int = ALL_SECTORS, lanes: int = 1) -> torch.Tensor:
    """K5's walk entry for CUDA tensors (all ``seg`` steps in one launch,
    ``lanes`` lanes a chain), the plain version for CPU ones, where
    ``lanes`` changes nothing but is checked."""
    if device_kind(table) == "cuda":
        from . import kernels

        return kernels.k5_gather_walk(table, idx, seg, sector_mask, lanes)
    if lanes not in K5_WALK_LANES:
        raise ValueError(f"lanes must be one of {K5_WALK_LANES}")
    return gather_walk_plain(table, idx, seg, sector_mask)


# ---------------------------------------------------------------------------
# K6: slab gather (P5)
# ---------------------------------------------------------------------------

def slab_gather_plain(slab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain torch version of K6: ``out[i, :] = slab[idx[i], :]``."""
    return slab[_clamped(idx, slab.shape[0])]


def slab_gather(slab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K6 for CUDA tensors, the plain version for CPU ones."""
    if device_kind(slab) == "cuda":
        from . import kernels

        return kernels.k6_slab_gather(slab, idx)
    return slab_gather_plain(slab, idx)


def slab_chain_plain(slab: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    """Plain torch version of K6's chained entry -> (n,) int32 indices
    after ``seg`` steps of ``idx <- (row[0] + row[37]) mod S``, the add
    in u32 (``ab_r5_pallas_gather.py:k1_chain``)."""
    s = slab.shape[0]
    idx = _clamped(idx, s)
    for _ in range(seg):
        rows = slab[idx].to(torch.int64) & MASK32
        idx = ((rows[:, 0] + rows[:, 37]) & MASK32) % s
    return idx.to(torch.int32)


def slab_chain(slab: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    """K6's chained entry for CUDA tensors (all ``seg`` steps in one
    launch), the plain version for CPU ones."""
    if device_kind(slab) == "cuda":
        from . import kernels

        return kernels.k6_slab_chain(slab, idx, seg)
    return slab_chain_plain(slab, idx, seg)

"""Masked rank over one shard of the range-sharded engine: plain torch
versions and dispatch wrappers.

Counterpart of the per-shard bodies of
``avxwindowfmindex_tpu/parallel/range_sharded.py``. A shard holds the
block rows of global blocks ``first_block .. first_block + rows - 1``
(narrow block rows, or the compact wide rows) and the sampled-SA entries
``first_sample ..``; every position of a batch goes to every shard, and
a shard answers for the positions it owns and gives 0 elsewhere, so the
sum of the shards' outputs is the value (each position is owned by one
shard at most). The rules follow the JAX functions literally:

  ownership   the global block is bits 8..39 of the position read as
              int32 (a narrow u32 position: ``pos // 256``; a wide one
              with bit 39 set reads negative), less ``first_block`` in
              int32 arithmetic; owned when it lies in [0, rows)
              (``_local_occurrence`` :54, ``_local_rows64`` :85);
  occ         occ(letter, pos) of the owned row (``_count_rows``);
  LF step     the letter at pos and occ(min(letter, ambiguity letter),
              pos), masked; the caller sums them over the shards and
              forms the LF after the sum (``lf_from_letter_occ``), as the
              JAX segment does after its stacked psum (:449 wide, :493
              narrow) -- a lane learns its letter only from its owner;
  SA gather   the sample index ``p // ratio`` (as int32), owned by the
              shard whose sample range holds it (:557 wide, :572 narrow),
              then, after the sum, the wrap-aware mod (``resolve_hits``).

``occurrence`` and ``letter_occ`` launch K1R (K1Rw for a wide shard) for
CUDA tensors and take the ``*_plain`` versions only for CPU tensors. The
SA gather stays torch ops on either device: the JAX package leaves it to
XLA, and no Pallas kernel stands behind it.
"""

from __future__ import annotations

import torch

from ..models.index import narrow_u32
from . import rank

POSITIONS_PER_BLOCK = rank.POSITIONS_PER_BLOCK


def _int32(x: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 and read as int32, in int64."""
    return narrow_u32(x).to(torch.int64)


def owned_rows(dev, positions: torch.Tensor, first_block: int):
    """(row, owned): the shard's row of each position's block, clamped to
    its rows, and whether the shard owns it."""
    pos = positions.to(torch.int64) & dev.pos_mask
    local = _int32(_int32(pos >> 8) - first_block)
    nb = dev.packed.shape[0]
    return local.clamp(0, nb - 1), (local >= 0) & (local < nb)


def local_occurrence_plain(dev, positions: torch.Tensor, letters: torch.Tensor,
                           first_block: int) -> torch.Tensor:
    """occ(letter, pos) for the positions the shard owns; 0 elsewhere
    (``_local_occurrence``; ``_local_rows64`` + ``_count_rows64`` for a
    wide shard) -> (B,) int64."""
    row, owned = owned_rows(dev, positions, first_block)
    local = positions.to(torch.int64) & (POSITIONS_PER_BLOCK - 1)
    occ = rank._count_rows(dev, dev.packed[row], local, letters.to(torch.int64))
    return torch.where(owned, occ, 0)


def local_letter_occ_plain(dev, positions: torch.Tensor, first_block: int):
    """(letter, occ(min(letter, ambiguity letter), pos)) for the positions
    the shard owns, (0, 0) elsewhere -> two (B,) int64: the per-shard half
    of the sharded LF step."""
    row, owned = owned_rows(dev, positions, first_block)
    rows = dev.packed[row]
    local = positions.to(torch.int64) & (POSITIONS_PER_BLOCK - 1)
    lett = rank.letter_at_rows(dev, rows, local)
    occ = rank._count_rows(dev, rows, local, torch.clamp(lett, max=dev.cardinality))
    return torch.where(owned, lett, 0), torch.where(owned, occ, 0)


def occurrence(dev, positions: torch.Tensor, letters: torch.Tensor,
               first_block: int) -> torch.Tensor:
    """The shard's masked occ: K1R (K1Rw for a wide shard) for CUDA
    tensors, the plain version for CPU ones."""
    if rank.device_kind(positions) == "cuda":
        from . import kernels

        return kernels.k1r_occurrence(
            dev, positions.to(torch.int64).contiguous(),
            letters.to(torch.int32).contiguous(), first_block,
        )
    return local_occurrence_plain(dev, positions, letters, first_block)


def letter_occ(dev, positions: torch.Tensor, first_block: int):
    """The shard's masked (letter, occ), both int64: K1R's (K1Rw's) letter
    mode for CUDA tensors, the plain version for CPU ones."""
    if rank.device_kind(positions) == "cuda":
        from . import kernels

        lett, occ = kernels.k1r_letter_occ(
            dev, positions.to(torch.int64).contiguous(), first_block)
        return lett.to(torch.int64), occ
    return local_letter_occ_plain(dev, positions, first_block)


def local_samples(dev, positions: torch.Tensor, first_sample: int) -> torch.Tensor:
    """SA[p // ratio] for the sample indices the shard owns (its samples
    are global ``first_sample ..``), 0 elsewhere -> (B,) int64."""
    idx = _int32((positions.to(torch.int64) & dev.pos_mask) // dev.ratio)
    local = _int32(idx - first_sample)
    n = dev.sampled_sa.shape[0]
    owned = (local >= 0) & (local < n)
    return torch.where(owned, dev.widen(dev.sampled_sa)[local.clamp(0, n - 1)], 0)


def resolve_hits(dev, sa: torch.Tensor, off: torch.Tensor) -> torch.Tensor:
    """(sa + off) mod bwtLength as one wrap-aware conditional subtract:
    a narrow sum may pass 2^32 (bwtLength > 2^31), so it also counts as
    over when it wrapped below ``sa`` (search.py:_resolve_samples;
    ``rank64.mod_bwt64`` for u64 values)."""
    h = (sa + off) & dev.pos_mask
    over = h >= dev.bwt_length
    if not dev.wide:
        over = over | (h < sa)
    return torch.where(over, h - dev.bwt_length, h) & dev.pos_mask

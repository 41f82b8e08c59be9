"""Rank over the shards of the range-sharded engine: the route, the
shards' steps over their slices, plain torch versions and dispatch
wrappers.

Counterpart of the per-shard bodies of
``avxwindowfmindex_tpu/parallel/range_sharded.py`` and the psum that
assembles them. A shard holds the block rows of global blocks
``first_block .. first_block + rows - 1`` (narrow block rows, or the
compact wide rows) and the sampled-SA entries ``first_sample ..``. Where
the JAX engine hands every lane of a step to every shard and sums, here a
step is routed: each position goes once to the shard that owns it, which
computes the step's whole value for it and stores it at the lane's place.
The rules follow the JAX functions literally:

  ownership   the global block is bits 8..39 of the position read as
              int32 (a narrow u32 position: ``pos // 256``; a wide one
              with bit 39 set reads negative), less ``first_block`` in
              int32 arithmetic; owned when it lies in [0, rows)
              (``_local_occurrence`` :54, ``_local_rows64`` :85). Over
              shards of ``bps`` blocks each, the owner of block b is b //
              bps when 0 <= b < n * bps, and no shard owns it otherwise
              (``owner_plain``): the route's rule;
  occ         occ(letter, pos) of the owned row (``_count_rows``); a lane
              no shard owns gets 0, what the psum of zeros gives;
  LF step     the letter at pos and occ(min(letter, ambiguity letter),
              pos), then LF = C[l] + occ - 1, sentinel -> 0
              (``lf_from_letter_occ``), formed by the owner (the JAX
              segment forms it after its stacked psum, :449 wide, :493
              narrow; a lane learns its letter only from its owner, and
              the owner has it). A lane no shard owns gets letter 0 and
              ``lf_from_letter_occ(0, 0)``, what the psum of zeros gives;
              a lane at a sample (p % ratio == 0) keeps (p, off), and
              every other lane gets off + 1;
  SA gather   the sample index ``p // ratio`` (as int32), owned by the
              shard whose sample range holds it (:557 wide, :572 narrow),
              then, after the sum, the wrap-aware mod (``resolve_hits``).

``route``, ``shard_occurrence`` and ``shard_lf`` launch the route and
K1R's two modes (K1Rw for a wide shard) for CUDA tensors and take the
``*_plain`` versions only for CPU tensors. ``local_occurrence_plain`` and
``local_letter_occ_plain``, the JAX-literal masked bodies, are the oracle
the routed versions are held to. The SA gather stays torch ops on either
device, summed over the shards: the JAX package leaves it to XLA, and no
Pallas kernel stands behind it.
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


def owner_plain(positions: torch.Tensor, n_shards: int, blocks_per_shard: int,
                wide: bool) -> torch.Tensor:
    """The shard that owns each position's block over ``n_shards`` shards
    of ``blocks_per_shard`` blocks, or -1 -> (B,) int64."""
    pos = positions.to(torch.int64)
    if not wide:
        pos = pos & 0xFFFFFFFF
    blk = _int32(pos >> 8)
    owned = (blk >= 0) & (blk < n_shards * blocks_per_shard)
    return torch.where(owned, blk // blocks_per_shard, -1)


def _positions(positions: torch.Tensor, wide: bool) -> torch.Tensor:
    """Positions as the route stores them: u32 values when narrow."""
    return positions if wide else positions & 0xFFFFFFFF


def route_plain(positions: torch.Tensor, out: torch.Tensor, n_shards: int,
                blocks_per_shard: int, wide: bool, unowned: int, counts: torch.Tensor,
                ratio: int = 0, off=None, letters=None):
    """The route (``kernels.k1r_route``'s contract), with the slices in
    lane order: returns ``(slot_pos, slot_lane)`` and fills ``counts``;
    writes ``unowned`` (and letter 0) for the lanes no shard owns and, in
    LF mode (``ratio`` > 0), off + 1 for every lane not at a sample."""
    n = positions.shape[0]
    if n >= 2**31:
        raise ValueError(f"the route takes fewer than 2^31 lanes, got {n}")
    pos = positions.to(torch.int64)
    shard = owner_plain(pos, n_shards, blocks_per_shard, wide)
    stepped = torch.ones_like(shard, dtype=torch.bool)
    if ratio:
        rem = _u64_mod(pos, ratio) if wide else _positions(pos, wide) % ratio
        stepped = rem != 0
        shard = torch.where(stepped, shard, -2)
    routed = shard >= 0
    key = torch.where(routed, shard, n_shards)
    order = torch.sort(key, stable=True).indices
    total = int(routed.sum())
    lanes = order[:total]
    slot_pos = torch.empty(n, dtype=torch.int64, device=pos.device)
    slot_lane = torch.empty(n, dtype=torch.int32, device=pos.device)
    slot_pos[:total] = _positions(pos, wide)[lanes]
    slot_lane[:total] = lanes.to(torch.int32)
    counts[:n_shards] = torch.bincount(shard[routed], minlength=n_shards).to(torch.int32)
    counts[n_shards] = 0
    none = shard == -1
    out[none] = unowned
    if letters is not None:
        letters[none] = 0
    if off is not None:
        off += stepped.to(off.dtype)
    return slot_pos, slot_lane


def _u64_mod(values: torch.Tensor, m: int) -> torch.Tensor:
    """u64 values held in int64, mod m (0 < m < 2^62)."""
    low = values & (2**62 - 1)
    top = (values >> 62) & 3  # the two top bits, as 0..3
    return (low % m + (top * ((2**62) % m)) % m) % m


def _slice_plain(slot_pos, slot_lane, counts, shard: int):
    """(positions, lanes) of shard ``shard``'s slice; lanes None for a
    slice copied to the shard's device."""
    if slot_lane is None:
        return slot_pos, None
    c = [int(x) for x in counts.tolist()]
    begin = sum(c[:shard])
    end = begin + c[shard]
    return slot_pos[begin:end], slot_lane[begin:end].to(torch.int64)


def _shard_rows(dev, pos: torch.Tensor, first_block: int):
    """The shard's rows of routed positions and their block-local offsets."""
    row, owned = owned_rows(dev, pos, first_block)
    if not bool(owned.all()):
        raise ValueError("a slice holds a position its shard does not own")
    return dev.packed[row], pos & (POSITIONS_PER_BLOCK - 1)


def shard_occurrence_plain(dev, first_block: int, slot_pos, slot_lane, counts, shard: int,
                           letters: torch.Tensor, out: torch.Tensor, count: int = 0) -> None:
    """``kernels.k1r_occurrence``'s contract: out[lane] = occ(letters[lane],
    pos) over the shard's slice."""
    pos, lanes = _slice_plain(slot_pos, slot_lane, counts, shard)
    rows, local = _shard_rows(dev, pos, first_block)
    at = lanes if lanes is not None else torch.arange(pos.shape[0], device=pos.device)
    out[at] = rank._count_rows(dev, rows, local, letters[at].to(torch.int64))


def shard_lf_plain(dev, first_block: int, slot_pos, slot_lane, counts, shard: int,
                   p: torch.Tensor, letters=None, count: int = 0) -> None:
    """``kernels.k1r_lf``'s contract: p[lane] = LF(pos) and letters[lane] =
    the letter at pos over the shard's slice."""
    pos, lanes = _slice_plain(slot_pos, slot_lane, counts, shard)
    rows, local = _shard_rows(dev, pos, first_block)
    lett = rank.letter_at_rows(dev, rows, local)
    occ = rank._count_rows(dev, rows, local, torch.clamp(lett, max=dev.cardinality))
    at = lanes if lanes is not None else torch.arange(pos.shape[0], device=pos.device)
    p[at] = rank.lf_from_letter_occ(dev, lett, occ)
    if letters is not None:
        letters[at] = lett.to(letters.dtype)


def route(positions: torch.Tensor, out: torch.Tensor, n_shards: int, blocks_per_shard: int,
          wide: bool, unowned: int, counts: torch.Tensor, ratio: int = 0, off=None,
          letters=None):
    """The route: ``kernels.k1r_route`` for CUDA tensors, the plain version
    for CPU ones."""
    if rank.device_kind(positions) == "cuda":
        from . import kernels

        return kernels.k1r_route(positions, out, n_shards, blocks_per_shard, wide, unowned,
                                 counts, ratio, off, letters)
    return route_plain(positions, out, n_shards, blocks_per_shard, wide, unowned, counts,
                       ratio, off, letters)


def shard_occurrence(dev, first_block: int, slot_pos, slot_lane, counts, shard: int,
                     letters: torch.Tensor, out: torch.Tensor, count: int = 0) -> None:
    """A shard's occ over its slice: K1R (K1Rw for a wide shard) for CUDA
    tensors, the plain version for CPU ones."""
    if rank.device_kind(slot_pos) == "cuda":
        from . import kernels

        return kernels.k1r_occurrence(dev, first_block, slot_pos, slot_lane, counts, shard,
                                      letters, out, count)
    return shard_occurrence_plain(dev, first_block, slot_pos, slot_lane, counts, shard,
                                  letters, out, count)


def shard_lf(dev, first_block: int, slot_pos, slot_lane, counts, shard: int,
             p: torch.Tensor, letters=None, count: int = 0) -> None:
    """A shard's LF step over its slice: K1R's (K1Rw's) LF mode for CUDA
    tensors, the plain version for CPU ones."""
    if rank.device_kind(slot_pos) == "cuda":
        from . import kernels

        return kernels.k1r_lf(dev, first_block, slot_pos, slot_lane, counts, shard, p,
                              letters, count)
    return shard_lf_plain(dev, first_block, slot_pos, slot_lane, counts, shard, p, letters,
                          count)


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

"""Occurrence (rank) primitives: plain torch versions and dispatch wrappers.

Counterpart of ``avxwindowfmindex_tpu/ops/rank.py`` and, for the wide
view, of ``ops/rank64.py``, with the same math over the same fused rows
(models/index.py):

    occ(l, pos) = milestone[pos/256, l] + popcount(match(l) & incl_mask(pos%256))

One body serves both widths: the row geometry (plane stride, milestone
width, which table), the position mask and the block-index rule come
from the view.

Narrow positions are u32 values carried in int64 tensors. They wrap mod
2^32 (``start - 1`` at ``start == 0`` is 0xFFFFFFFF), and a block index
past the table clamps to the last row, exactly as the JAX gathers do
under XLA's clamping semantics; torch indexing would raise instead.

Wide positions are u64 values carried in int64 tensors: add and subtract
wrap mod 2^64 by two's complement, compares and shifts are written for
unsigned values (``le_unsigned``, ``_gather_rows``). The block index is
the JAX wide path's (ops/rank64.py ``_gather_rows64``): the low 32 bits
of ``pos >> 8`` read as int32, a negative value taken from the end of
the table (plus num_blocks), then clamped to [0, num_blocks - 1]. So
``start - 1`` at ``start == 0`` (block -1) reads the last row, as the
narrow path does, while other out-of-range positions may clamp to row 0.

The letter selects are one-hot as in JAX: a letter above the ambiguity
index has code 0 and milestone 0, and one above the sentinel has C = 0.

``occurrence`` and ``letter_and_lf_at`` are the dispatch wrappers of
K1 and K1w (ops/kernels.py): they launch the kernel for CUDA tensors and
take the ``*_plain`` versions below only for CPU tensors. ``single_step``
and ``single_lf`` do the same for one range or one position passed by
value (K1's step and LF-at modes), by the view's device.

A step's first-block class reads the block rows, as K2 and K4 do on the
card: a narrow view keeps them beside its pair rows, and a wide view's
block rows are its pair-fused rows. A view without pair rows has no pair
step (``backward_step_pair`` refuses it), so its wider ranges take the
classic two-row ``backward_step``.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..models.index import MASK32

POSITIONS_PER_BLOCK = 256

# popcount of every byte value (torch has no popcount op)
_POPCOUNT8 = torch.tensor([bin(v).count("1") for v in range(256)], dtype=torch.int64)


def _popcount_sum(x: torch.Tensor) -> torch.Tensor:
    """Row sums of the byte popcounts of a (B, W) uint8 tensor -> (B,) int64."""
    return _POPCOUNT8.to(x.device)[x.long()].sum(dim=1)


def device_kind(t: torch.Tensor) -> str:
    """'cuda' or 'cpu' for a tensor the wrappers accept; raises otherwise."""
    if t.device.type in ("cuda", "cpu"):
        return t.device.type
    raise ValueError(f"unsupported device {t.device}")


# ---------------------------------------------------------------------------
# Row helpers (plain torch)
# ---------------------------------------------------------------------------

_SIGN64 = -(2**63)


def le_unsigned(a: torch.Tensor, b: torch.Tensor, wide: bool) -> torch.Tensor:
    """a <= b for position values in int64 tensors: u32 values compare
    as they are, u64 values after flipping the sign bit."""
    if not wide:
        return a <= b
    return (a ^ _SIGN64) <= (b ^ _SIGN64)


def block_index(nb: int, positions: torch.Tensor, wide: bool) -> torch.Tensor:
    """Row of each position in a table of ``nb`` rows under the narrow
    or the wide block-index rule (module docstring), in [0, nb - 1]."""
    pos = positions.to(torch.int64)
    if not wide:
        return torch.clamp((pos & MASK32) >> 8, max=nb - 1)
    blk = (pos >> 8) & MASK32
    blk = torch.where(blk >= 2**31, blk - 2**32, blk)
    return torch.where(blk < 0, blk + nb, blk).clamp(0, nb - 1)


def _gather_rows(table: torch.Tensor, positions: torch.Tensor, wide: bool = False):
    """(rows, local): the table row of each position's block and pos & 255."""
    pos = positions.to(torch.int64)
    return table[block_index(table.shape[0], pos, wide)], pos & (POSITIONS_PER_BLOCK - 1)


def _code_masks(dev, letters: torch.Tensor) -> torch.Tensor:
    """(B, n_planes) uint8 0xFF/0 code masks; zero above the ambiguity index."""
    ok = (letters >= 0) & (letters <= dev.cardinality)
    cm = dev.code_masks[letters.clamp(0, dev.cardinality)]
    return cm * ok[:, None].to(torch.uint8)


def _match_bytes(dev, rows: torch.Tensor, letters: torch.Tensor, plane_bytes: int,
                 stride: int):
    """(B, plane_bytes) uint8 whose set bits mark positions equal to the
    letter, over the first plane_bytes of each plane (``stride`` apart)."""
    cms = _code_masks(dev, letters)
    diff = None
    for i in range(dev.n_planes):
        x = rows[:, i * stride : i * stride + plane_bytes] ^ cms[:, i : i + 1]
        diff = x if diff is None else (diff | x)
    return torch.bitwise_not(diff)


def _inclusive_mask(local: torch.Tensor, plane_bytes: int) -> torch.Tensor:
    """(B, plane_bytes) uint8 keeping bits 0..local inclusive."""
    byte_idx = (local >> 3)[:, None]
    low = ((2 << (local & 7)) - 1)[:, None]  # 2 << 7 = 256 -> 255: full byte
    iota = torch.arange(plane_bytes, device=local.device)[None, :]
    mask = torch.where(
        iota < byte_idx, 0xFF, torch.where(iota == byte_idx, low & 0xFF, 0)
    )
    return mask.to(torch.uint8)


def _milestone(dev, rows: torch.Tensor, letters: torch.Tensor, offset: int):
    """Little-endian milestone (u32, or u64 in a wide row) of each row's
    letter; 0 above the ambiguity index. The byte fields are disjoint,
    so the int64 sum is their OR, the top byte of a u64 wrapping into
    the sign bit."""
    w = dev.milestone_bytes
    ok = (letters >= 0) & (letters <= dev.cardinality)
    lc = letters.clamp(0, dev.cardinality).to(torch.int64)
    idx = offset + w * lc[:, None] + torch.arange(w, device=rows.device)[None, :]
    b = rows.gather(1, idx).to(torch.int64)
    shifts = 8 * torch.arange(w, device=rows.device)
    return torch.where(ok, (b << shifts).sum(dim=1), 0)


def _prefix_sum_select(dev, letters: torch.Tensor) -> torch.Tensor:
    """C[letter] as int64; 0 above the sentinel index."""
    ok = (letters >= 0) & (letters <= dev.cardinality + 1)
    ps = dev.widen(dev.prefix_sums)
    return torch.where(ok, ps[letters.clamp(0, dev.cardinality + 1).long()], 0)


def _count_rows(dev, rows, local, letters):
    match = _match_bytes(dev, rows, letters, 32, dev.plane_stride)
    cnt = _popcount_sum(match & _inclusive_mask(local, 32))
    return (_milestone(dev, rows, letters, dev.milestone_offset) + cnt) & dev.pos_mask


# ---------------------------------------------------------------------------
# K1: occurrence and letter/LF
# ---------------------------------------------------------------------------

def occurrence_plain(dev, positions: torch.Tensor, letters: torch.Tensor):
    """Batched occ(l, pos), inclusive of pos -> (B,) int64 holding u32
    values (u64 for a wide view)."""
    rows, local = _gather_rows(dev.packed, positions, dev.wide)
    return _count_rows(dev, rows, local, letters.to(torch.int64))


def occurrence(dev, positions: torch.Tensor, letters: torch.Tensor):
    """occ(l, pos): K1 (K1w for a wide view) for CUDA tensors, the plain
    version for CPU ones."""
    if device_kind(positions) == "cuda":
        from . import kernels

        return kernels.k1_occurrence(
            dev, positions.to(torch.int64).contiguous(),
            letters.to(torch.int32).contiguous(),
        )
    return occurrence_plain(dev, positions, letters)


def letter_at_rows(dev, rows: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """Letter index at each row's local position (one bit per plane,
    then the code inverse-mapped through vec_to_index)."""
    byte_col = (local >> 3)[:, None]
    bit = local & 7
    code = torch.zeros_like(local)
    for i in range(dev.n_planes):
        byte = rows.gather(1, byte_col + i * dev.plane_stride)[:, 0].to(torch.int64)
        code = code | (((byte >> bit) & 1) << i)
    return dev.vec_to_index.to(torch.int64)[code]


def lf_from_letter_occ(dev, lett: torch.Tensor, occ: torch.Tensor) -> torch.Tensor:
    """LF = C[l] + occ - 1 of letters ``lett`` and ``occ`` = occ(min(l,
    ambiguity letter), p), wrapped to the view's width; the sentinel maps
    to 0 (AwFmSearch.c:369-427)."""
    lclip = torch.clamp(lett, max=dev.cardinality)
    lf = (_prefix_sum_select(dev, lclip) + occ - 1) & dev.pos_mask
    return torch.where(lett == dev.sentinel, 0, lf)


def letter_and_lf_plain(dev, positions: torch.Tensor):
    """(letters, LF): LF(p) = C[l] + occ(l, p) - 1 with l the letter at
    p; the sentinel maps to 0 (AwFmSearch.c:369-427)."""
    rows, local = _gather_rows(dev.packed, positions, dev.wide)
    lett = letter_at_rows(dev, rows, local)
    occ = _count_rows(dev, rows, local, torch.clamp(lett, max=dev.cardinality))
    return lett, lf_from_letter_occ(dev, lett, occ)


def letter_and_lf_at(dev, positions: torch.Tensor):
    """(letters, LF): K1's (K1w's) LF mode for CUDA tensors, plain for CPU ones."""
    if device_kind(positions) == "cuda":
        from . import kernels

        lett, lf = kernels.k1_letter_and_lf(dev, positions.to(torch.int64).contiguous())
        return lett.to(torch.int64), lf
    return letter_and_lf_plain(dev, positions)


# ---------------------------------------------------------------------------
# K1 for one range or one position (the single-query API)
# ---------------------------------------------------------------------------

def int64_of(value: int) -> int:
    """The int64 that holds the bits of a u64 value."""
    return value - 2**64 if value >= 2**63 else value


def word_mask(dev) -> int:
    """``dev.pos_mask`` for Python ints: 2^32 - 1, or 2^64 - 1 for a wide
    view (whose ``pos_mask`` is the int64 -1 that tensors take)."""
    return 2**64 - 1 if dev.wide else MASK32


def step_args(dev, start: int, end: int, letter: int) -> Tuple[int, int, int]:
    """(start, end, letter) as K1's step mode takes them by value: the
    positions wrapped to the view's width (u32 or u64, as
    ``backward_step``'s ``& pos_mask``), the letter a u32 of at most 255.
    Every letter outside [0, 255] is above the sentinel index, as 255 is
    (C = 0, code 0, no milestone), so the clamp changes no answer."""
    mask = word_mask(dev)
    letter = int(letter)
    return int(start) & mask, int(end) & mask, letter if 0 <= letter <= 255 else 255


def step_plain(dev, start: int, end: int, letter: int) -> Tuple[int, int]:
    """The plain version of K1's step mode, on arguments as :func:`step_args`
    packs them: ``backward_step(check_valid=False)`` over
    ``occurrence_plain`` on the one range; (newStart, newEnd) as u32 (u64)
    ints, the words the kernel writes."""
    def one(v):
        return torch.tensor([int64_of(v)], dtype=torch.int64, device=dev.device)

    s, e = backward_step(dev, one(start), one(end), one(letter), check_valid=False,
                         occurrence_fn=occurrence_plain)
    return int(s[0]) & word_mask(dev), int(e[0]) & word_mask(dev)


def single_step(dev, start: int, end: int, letter: int) -> Tuple[int, int]:
    """One unconditional backward step of one range (``search.py:
    iterative_step_backward_search``): K1's step mode (``kernels.k1_step``)
    for a view on the card, :func:`step_plain` for one on the CPU."""
    args = step_args(dev, start, end, letter)
    if device_kind(dev.packed) == "cuda":
        from . import kernels

        return kernels.k1_step(dev, *args)
    return step_plain(dev, *args)


def lf_at_plain(dev, position: int) -> Tuple[int, int]:
    """The plain version of K1's LF mode for one position (a u32 or u64
    value): (letter at it, LF) as ints, the sentinel's LF 0."""
    lett, lf = letter_and_lf_plain(
        dev, torch.tensor([int64_of(position)], dtype=torch.int64, device=dev.device))
    return int(lett[0]), int(lf[0]) & word_mask(dev)


def single_lf(dev, position: int) -> Tuple[int, int]:
    """(letter, LF) at one position wrapped to the view's width
    (``search.py:backtrace_return_previous_letter_index``): K1's LF mode by
    value (``kernels.k1_lf_at``) on the card, :func:`lf_at_plain` on the CPU."""
    position = int(position) & word_mask(dev)
    if device_kind(dev.packed) == "cuda":
        from . import kernels

        return kernels.k1_lf_at(dev, position)
    return lf_at_plain(dev, position)


# ---------------------------------------------------------------------------
# Backward steps
# ---------------------------------------------------------------------------

def backward_step(dev, start, end, letters, active=None, check_valid=True,
                  occurrence_fn=None):
    """One batched backward-search step (AwFmSearch.c:42-159).

    newStart = C[l] + occ(l, start-1);  newEnd = C[l] + occ(l, end) - 1

    With ``check_valid`` only rows where ``active & (start <= end)`` are
    updated; the seed-table builder steps unconditionally
    (``check_valid=False``). ``occurrence_fn`` defaults to the K1
    dispatch wrapper; pass ``occurrence_plain`` to force the plain one.
    """
    occ_fn = occurrence if occurrence_fn is None else occurrence_fn
    mask = dev.pos_mask
    start = start.to(torch.int64) & mask
    end = end.to(torch.int64) & mask
    letters = letters.to(torch.int64)
    b = start.shape[0]
    c = _prefix_sum_select(dev, letters)
    occ = occ_fn(dev, torch.cat([(start - 1) & mask, end]), torch.cat([letters, letters]))
    new_start = (c + occ[:b]) & mask
    new_end = (c + occ[b:] - 1) & mask
    keep = None
    if check_valid:
        keep = le_unsigned(start, end, dev.wide)
    if active is not None:
        keep = active if keep is None else (active & keep)
    if keep is None:
        return new_start, new_end
    return torch.where(keep, new_start, start), torch.where(keep, new_end, end)


def window_delta(start, end, pos_mask: int):
    """Offset of ``end`` from the start of the block that holds ``start -
    1``, as the unsigned value K2 and K4 pick a step's window class from
    (a u64 value of 2^63 and more reads negative)."""
    pos_s = (start - 1) & pos_mask
    return (end - (pos_s & ~0xFF)) & pos_mask


def window_classes(start, end, keep, pos_mask: int = MASK32) -> torch.Tensor:
    """(3,) int64: how many of the steps marked by ``keep`` fall in each
    window class: delta < 256 (both ends in the first block of the row),
    256 <= delta < 512 (the whole pair window), and wider (two rows)."""
    delta = window_delta(start.to(torch.int64) & pos_mask, end.to(torch.int64) & pos_mask,
                         pos_mask)
    first = (delta >= 0) & (delta < 256)
    window = (delta >= 256) & (delta < 512)
    return torch.stack([(keep & first).sum(), (keep & window).sum(),
                        (keep & ~first & ~window).sum()])


def backward_step_first_block(dev, start, end, letters, active=None):
    """The first-block class of a step: for a range with both ends in
    the first block of its row (delta < 256) it reads only the first
    32 B of each plane and the letter's milestone of the block row (a
    wide view's pair-fused row, planes 64 B apart), with or without pair
    rows, and gives what :func:`backward_step_pair` (:func:`backward_step`)
    gives.

    Returns (new_start, new_end, first): ``first`` marks the valid,
    active rows of that class; every other row keeps its range.
    """
    mask = dev.pos_mask
    start = start.to(torch.int64) & mask
    end = end.to(torch.int64) & mask
    letters = letters.to(torch.int64)
    c = _prefix_sum_select(dev, letters)
    pos_s = (start - 1) & mask
    rows, local_s = _gather_rows(dev.packed, pos_s, dev.wide)
    delta = window_delta(start, end, mask)
    first = (delta >= 0) & (delta < 256) & le_unsigned(start, end, dev.wide)
    if active is not None:
        first = first & active
    match = _match_bytes(dev, rows, letters, 32, dev.plane_stride)
    occ_s = _popcount_sum(match & _inclusive_mask(local_s, 32))
    occ_e = _popcount_sum(match & _inclusive_mask(delta.clamp(0, 255), 32))
    ms = _milestone(dev, rows, letters, dev.milestone_offset)
    new_start = (c + ms + occ_s) & mask
    new_end = (c + ms + occ_e - 1) & mask
    return torch.where(first, new_start, start), torch.where(first, new_end, end), first


def backward_step_pair(dev, start, end, letters, bad, active=None):
    """One-gather pair-row step; flags ranges wider than the pair window.

    Returns (new_start, new_end, bad) exactly as the JAX function does:
    a row whose end lies past the 512-position window gets a clamped
    (wrong) end and its flag set. The window offset is compared
    unsigned at the full position width before any narrowing
    (ops/rank.py:382-388 and ops/rank64.py:470-473 of the JAX package);
    the clamped end comes from its low 32 bits, as there. A view
    without pair rows has no such step.
    """
    if not dev.pair_rows:
        raise ValueError("the view has no pair rows (to_device(pair_rows=False))")
    mask = dev.pos_mask
    start = start.to(torch.int64) & mask
    end = end.to(torch.int64) & mask
    letters = letters.to(torch.int64)
    c = _prefix_sum_select(dev, letters)
    pos_s = (start - 1) & mask
    rows, local_s = _gather_rows(dev.packed_pair, pos_s, dev.wide)
    delta_e = (end - (pos_s & ~0xFF)) & mask
    overflow = (delta_e < 0) | (delta_e >= 512)  # negative: u64 above 2^63
    local_e = torch.clamp(delta_e & MASK32, max=511)
    match = _match_bytes(dev, rows, letters, 64, 64)
    occ_s = _popcount_sum(match & _inclusive_mask(local_s, 64))
    occ_e = _popcount_sum(match & _inclusive_mask(local_e, 64))
    ms = _milestone(dev, rows, letters, dev.pair_milestone_offset)
    new_start = (c + ms + occ_s) & mask
    new_end = (c + ms + occ_e - 1) & mask
    keep = le_unsigned(start, end, dev.wide)
    if active is not None:
        keep = keep & active
    bad = bad | (overflow & keep)
    return torch.where(keep, new_start, start), torch.where(keep, new_end, end), bad

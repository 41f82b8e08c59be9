"""Batched FM-index search: count and locate on a torch device.

Counterpart of ``avxwindowfmindex_tpu/search.py`` (``SearchEngine``,
``_total_hits``, the enumerate step, the on-disk SA resolve). The JAX
package's search is a pipeline of XLA programs — seed lookup, lock-step
backward steps with a pair-window flag and an exact re-run, range
enumeration, a compacting LF backtrace, the sampled-SA resolve. Here it
is a few kernels around one plain torch step:

  ranges     K2 (``search_ranges``): two lanes per query do the seed
             lookup (or the whole-letter initial range) and every
             backward step; a step reads its pair row by window class
             (the first block's sectors when both ends of the range lie
             there, else the whole 512-position window) and a wider range
             two block rows, so no query is flagged or re-run;
             K4 (``ngram_ranges``, ``NgramSearchEngine``): the same for
             a uniform clean batch, n letters per step over the n-gram
             pair rows (ops/ngram.py), then the m mod n tail letters;
  enumerate  plain torch ops (``enumerate_range_positions``): ranges to
             flat BWT positions, in range order; K7 (``enumerate_flat``):
             the same into a fixed capacity with query ids and a mask,
             a prefix sum of the counts and one pass over the slots;
  locate     K3 (``backtrace_resolve``): each hit is walked with LF to a
             sampled position and its suffix-array value resolved; a
             lane whose walk has ended takes the next hit (K3w: one
             thread per hit).
             ``locate_flat_device`` and ``locate_first_hit`` run it on
             device-resident ranges with no host readback.

Each of ``search_ranges``, ``ngram_ranges``, ``enumerate_flat`` and
``backtrace_resolve`` launches its kernel for CUDA tensors and runs the
plain version beside it only for CPU tensors. Results equal the JAX
package's bit for bit.

The batched functions of the device path open spans
(``utils/metrics.span``; ranges only while a profiler records):
``awfm.ranges`` (``search_ranges``, ``ngram_ranges``), ``awfm.counts``
(``range_counts``), ``awfm.locate`` (``locate_flat_device``) around
``awfm.enumerate`` (``enumerate_flat``) and ``awfm.backtrace``
(``backtrace_resolve``); each kernel's launch has its own
(``awfm.launch.<kernel>``, ``ops/kernels.py``).

A wide view (``DeviceIndex.wide``: positions >= 2^32, or forced with
``to_device(device, wide=True)``) runs through the same functions: the
JAX package's second engine (``search64.py`` over (hi, lo) u32 pairs) is
int64 arithmetic here, and ``search_ranges`` / ``backtrace_resolve``
launch K2w / K3w, the 64-bit instantiations of K2 / K3. Positions are
u64 values in int64 tensors; every real one is below 2^39, so it is
non-negative and ``%``, ``//`` and sums act as on u64. The n-gram engine
stays narrow-only, as in the JAX package.

A view without pair rows (``to_device(device, pair_rows=False)``, or
``pair_rows=False`` on the engines) runs through the same functions too:
its steps read the first block's sectors of the block row, or two block
rows, through K2's and K4's block-row forms (narrow) and K2w's compact
form (wide amino); K1, K3 and their wide forms read the block rows of
any view.

The single-query parity API (AwFmSearch.c's per-query functions) is at
the end of the module: each call runs one query through the same
kernels, on the ``device`` it is given.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .models import alphabet as alpha
from .models.config import AlphabetType
from .models.index import MASK32, DeviceIndex, FmIndex, as_device, view_has_pair_rows
from .ops import ngram as ngram_ops
from .ops import rank as rank_ops
from .utils import metrics


def _round_up_pow2(n: int, floor: int = 16) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# K2: final BWT ranges
# ---------------------------------------------------------------------------

def _step_exact(dev, start, end, letters, active, classes=None):
    """One exact backward step the way K2 takes it, by window class: the
    first block's sectors of the block row, the whole pair window, or the
    two-row classic step outside it. In a view without pair rows, the
    first block's sectors of the block row, else the two-row step.
    ``classes``: a (3,) int64 tensor that gains the number of rows
    stepped in each class."""
    fs, fe, first = rank_ops.backward_step_first_block(dev, start, end, letters, active)
    cs, ce = rank_ops.backward_step(
        dev, start, end, letters, active, occurrence_fn=rank_ops.occurrence_plain
    )
    if classes is not None:
        keep = rank_ops.le_unsigned(start & dev.pos_mask, end & dev.pos_mask, dev.wide)
        if active is not None:
            keep = keep & active
        classes += rank_ops.window_classes(start, end, keep, dev.pos_mask)
    if dev.pair_rows:
        bad = torch.zeros(start.shape, dtype=torch.bool, device=start.device)
        ps, pe, bad = rank_ops.backward_step_pair(dev, start, end, letters, bad, active)
        cs, ce = torch.where(bad, cs, ps), torch.where(bad, ce, pe)
    return torch.where(first, fs, cs), torch.where(first, fe, ce)


def _seed_lookup(dev, mat, lengths):
    """(B, 2) int64 seed-table ranges of the last k letters of each row
    of the int64 letter matrix: the base-|A| radix, leftmost most
    significant, clamped to the table."""
    device = mat.device
    l_pad = mat.shape[1]
    k = dev.kmer_length_in_seed_table
    idxs = (lengths[:, None] - k + torch.arange(k, device=device)[None, :]).clamp(0, l_pad - 1)
    powers = torch.tensor([dev.cardinality ** (k - 1 - j) for j in range(k)], device=device)
    tidx = ((mat.gather(1, idxs) * powers).sum(dim=1) & MASK32).clamp(
        max=dev.seed_table.shape[0] - 1
    )
    return dev.widen(dev.seed_table[tidx])


def ranges_plain(dev, mat, lengths, seeded, classes=None):
    """Plain torch version of K2 and K2w -> (start, end), (B,) int64
    holding u32 values (u64 for a wide view). ``classes``: a (3,) int64
    tensor that gains the steps taken in each window class
    (``ops/rank.window_classes``).

    mat (B, L) letter indices; lengths (B,); seeded (B,) bool/uint8:
    seed-table lookup of the last k letters (``_seed_lookup``) where
    set, else the last letter's prefix-sum range (``_initial_range``);
    then one step per remaining letter, right to left, while the range
    is valid.
    """
    mat = mat.to(torch.int64)
    lengths = lengths.to(torch.int64)
    seeded = seeded.to(torch.bool)
    start, end, nxt = initial_ranges(dev, mat, lengths, seeded)
    for t in range(int(nxt.max()) + 1 if mat.shape[0] else 0):
        p = nxt - t
        start, end = _step_exact(dev, start, end, step_letters(mat, p), p >= 0, classes)
    return start, end


def initial_ranges(dev, mat, lengths, seeded):
    """(start, end, nxt) before the backward steps of an int64 letter
    matrix: the seed-table range of the last k letters where ``seeded``
    (``_seed_lookup``), else the last letter's prefix-sum range
    (``_initial_range``); ``nxt``: the column of each query's first step
    (negative: none)."""
    card = dev.cardinality
    seed = _seed_lookup(dev, mat, lengths)
    ps = dev.widen(dev.prefix_sums)
    last = mat.gather(1, (lengths - 1).clamp(min=0)[:, None])[:, 0]
    init_s = ps[last.clamp(max=card + 1)]
    init_e = (ps[(last + 1).clamp(max=card + 1)] - 1) & dev.pos_mask
    start = torch.where(seeded, seed[:, 0], init_s)
    end = torch.where(seeded, seed[:, 1], init_e)
    nxt = torch.where(seeded, lengths - dev.kmer_length_in_seed_table - 1, lengths - 2)
    return start, end, nxt


def step_letters(mat, p):
    """The letter of each row of ``mat`` at column ``p``, clamped to the matrix."""
    return mat.gather(1, p.clamp(0, mat.shape[1] - 1)[:, None])[:, 0]


def search_ranges(dev, mat, lengths, seeded):
    """Final (start, end) ranges: K2 (K2w for a wide view) for CUDA
    tensors, plain for CPU ones. Span ``awfm.ranges``."""
    with metrics.span("ranges"):
        if rank_ops.device_kind(mat) == "cuda":
            from .ops import kernels

            return kernels.k2_ranges(
                dev, mat.to(torch.uint8).contiguous(),
                lengths.to(torch.int32).contiguous(),
                seeded.to(torch.uint8).contiguous(),
            )
        return ranges_plain(dev, mat, lengths, seeded)


# ---------------------------------------------------------------------------
# K4: final BWT ranges through the n-gram table
# ---------------------------------------------------------------------------

def _ngram_step_exact(ng, start, end, letters, classes=None):
    """One exact n-gram step the way K4 takes it, by window class: the
    first block's sectors of the row, the whole pair window, or the
    two-row step outside it. ``classes`` as in :func:`_step_exact`."""
    bad = torch.zeros(start.shape, dtype=torch.bool, device=start.device)
    fs, fe, first = ngram_ops.ngram_backward_step_first_block(ng, start, end, letters)
    ps, pe, bad = ngram_ops.ngram_backward_step_pair(ng, start, end, letters, bad)
    cs, ce = ngram_ops.ngram_backward_step(ng, start, end, letters)
    if classes is not None:
        keep = (start & MASK32) <= (end & MASK32)
        classes += rank_ops.window_classes(start, end, keep)
    return (torch.where(first, fs, torch.where(bad, cs, ps)),
            torch.where(first, fe, torch.where(bad, ce, pe)))


def new_step_classes(device) -> dict:
    """Zeroed per-table step counts by window class, for ``classes=``:
    ``"ngram_pair"`` (K4's n-gram steps) and ``"pair"`` (K2's steps, K4's
    tail), each (3,) int64: first block, pair window, two rows."""
    return {t: torch.zeros(3, dtype=torch.int64, device=device) for t in ("ngram_pair", "pair")}


def ngram_ranges_plain(dev, ng, mat, kmer_len: int, classes=None):
    """Plain torch version of K4 -> (start, end), (B,) int64 u32 values.
    ``classes``: a dict from :func:`new_step_classes` that gains the steps
    taken in each window class, by table.

    mat (B, L) letter indices of a uniform batch of length kmer_len > k
    with letters < 4: the seed lookup of the last k letters, then
    floor(m/n) n-gram steps (m = kmer_len - k; step t prepends columns
    m - n(t+1) .. m - nt - 1, leftmost first), then the m mod n leftmost
    letters as single steps, right to left.
    """
    mat = mat.to(torch.int64)
    n = ng.n
    m = kmer_len - dev.kmer_length_in_seed_table
    lengths = torch.full(mat.shape[:1], kmer_len, dtype=torch.int64, device=mat.device)
    seed = _seed_lookup(dev, mat, lengths)
    start, end = seed[:, 0], seed[:, 1]
    for t in range(m // n):
        cols = [m - n * (t + 1) + j for j in range(n)]
        start, end = _ngram_step_exact(
            ng, start, end, [mat[:, c] for c in cols],
            None if classes is None else classes["ngram_pair"],
        )
    for c in range(m % n - 1, -1, -1):
        start, end = _step_exact(
            dev, start, end, mat[:, c], None, None if classes is None else classes["pair"]
        )
    return start, end


def ngram_ranges(dev, ng, mat, kmer_len: int):
    """Final (start, end) ranges of a uniform clean batch through the
    n-gram table: K4 for CUDA tensors, the plain version for CPU ones.
    Span ``awfm.ranges``."""
    with metrics.span("ranges"):
        if rank_ops.device_kind(mat) == "cuda":
            from .ops import kernels

            return kernels.k4_ngram_ranges(dev, ng, mat.to(torch.uint8).contiguous(), kmer_len)
        return ngram_ranges_plain(dev, ng, mat, kmer_len)


# ---------------------------------------------------------------------------
# K3: backtrace + resolve
# ---------------------------------------------------------------------------

def backtrace_resolve_plain(dev, positions):
    """Plain torch version of K3 and K3w.

    Walks ``p = LF(p); off += 1`` until ``p % ratio == 0``
    (AwFmParallelSearch.c:343-354; ratio 1 walks nothing). With the
    sampled SA resident it returns the hits ``(SA[p/ratio] + off) mod
    bwtLength`` (int64); with the SA on disk, ``(p, off)``. The walk is
    bounded by bwtLength steps, as in K3, so a malformed index cannot
    spin forever.
    """
    p = positions.to(torch.int64) & dev.pos_mask
    off = torch.zeros_like(p)
    todo = torch.nonzero(p % dev.ratio != 0)[:, 0]
    steps = 0
    while todo.numel() and steps < dev.bwt_length:
        _, lf = rank_ops.letter_and_lf_plain(dev, p[todo])
        p[todo] = lf
        off[todo] += 1
        todo = todo[lf % dev.ratio != 0]
        steps += 1
    if dev.sampled_sa is None:
        return p, off
    sa = dev.widen(dev.sampled_sa)[p // dev.ratio]
    return (sa + off) % dev.bwt_length


def backtrace_resolve(dev, positions):
    """K3 (K3w for a wide view) for CUDA tensors, the plain version for
    CPU ones. Span ``awfm.backtrace``."""
    with metrics.span("backtrace"):
        if rank_ops.device_kind(positions) == "cuda":
            from .ops import kernels

            return kernels.k3_backtrace_resolve(dev, positions.to(torch.int64).contiguous())
        return backtrace_resolve_plain(dev, positions)


# ---------------------------------------------------------------------------
# Enumerate
# ---------------------------------------------------------------------------

def range_counts(start: torch.Tensor, end: torch.Tensor, wide: bool = False) -> torch.Tensor:
    """Hits per range: end - start + 1 where start <= end, else 0 (int64).
    ``wide``: the ranges are u64 values in int64 tensors (a wide view's),
    compared unsigned. Span ``awfm.counts``."""
    with metrics.span("counts"):
        return torch.where(rank_ops.le_unsigned(start, end, wide), end - start + 1, 0)


def total_hits_host(start: torch.Tensor, end: torch.Tensor, wide: bool = False) -> int:
    """Exact total hit count of a range batch as a Python int
    (``_total_hits`` / ``total_hits_host``: int64 sums cannot wrap the
    way the JAX package's u32 lanes had to guard)."""
    return int(range_counts(start, end, wide).sum())


def enumerate_range_positions(start: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """Flat BWT positions of every hit, grouped by query in range order
    (``_flat_positions`` / ``_enumerate_delta``)."""
    total = int(counts.sum())
    device = start.device
    qid = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=device), counts, output_size=total
    )
    seg_off = torch.cumsum(counts, 0) - counts
    return start[qid] + torch.arange(total, device=device) - seg_off[qid]


def enumerate_flat_plain(start: torch.Tensor, end: torch.Tensor, *, capacity: int,
                         wide: bool = False):
    """Plain torch version of K7: ``enumerate_flat``'s outputs from a
    chain of torch ops on any device."""
    device = start.device
    if start.shape[0] == 0:
        z = torch.zeros(capacity, dtype=torch.int64, device=device)
        return z, z.to(torch.int32), torch.zeros(capacity, dtype=torch.bool, device=device)
    counts = range_counts(start, end, wide).clamp(max=capacity)
    seg_off = torch.cumsum(counts, 0) - counts
    # one mark per query at its segment start (zero-count queries stack
    # on the next start, so the cumsum skips their ids); marks at or past
    # capacity fall into the dropped last slot
    marks = torch.zeros(capacity + 1, dtype=torch.int64, device=device)
    marks.index_add_(0, seg_off.clamp(max=capacity), torch.ones_like(seg_off))
    qid = (torch.cumsum(marks[:capacity], 0) - 1).clamp(min=0)
    iota = torch.arange(capacity, dtype=torch.int64, device=device)
    mask = iota < counts.sum()
    pos = start[qid] + iota - seg_off[qid]
    if not wide:
        pos = pos & MASK32
    zero = torch.zeros((), dtype=torch.int64, device=device)
    return (
        torch.where(mask, pos, zero),
        torch.where(mask, qid, zero).to(torch.int32),
        mask,
    )


def enumerate_flat(start: torch.Tensor, end: torch.Tensor, *, capacity: int,
                   wide: bool = False):
    """Flatten BWT ranges into per-hit positions of a fixed ``capacity``,
    on the device (``enumerate_range_positions(start, end, capacity=)``
    of the JAX package).

    Returns (positions int64 u32 values, query ids int32, valid mask),
    each (capacity,). Hits are grouped by query in range order; slots
    past the total hold 0 with the mask False. A range's count is
    clamped at ``capacity``, and hits past ``capacity`` are dropped. No
    value is read back to the host. With ``wide`` the ranges and the
    positions are u64 values and nothing wraps at 2^32. K7 for CUDA
    tensors (two launches, nothing but its outputs and scratch allocated
    around them), the plain version for CPU ones. Span ``awfm.enumerate``.
    """
    if not 0 <= capacity < 2**31:
        raise ValueError("capacity must be in [0, 2^31)")
    with metrics.span("enumerate"):
        if rank_ops.device_kind(start) == "cuda":
            from .ops import kernels

            return kernels.k7_enumerate(start.to(torch.int64).contiguous(),
                                        end.to(torch.int64).contiguous(), capacity, wide)
        return enumerate_flat_plain(start, end, capacity=capacity, wide=wide)


def locate_flat_device(dev, start: torch.Tensor, end: torch.Tensor, *, capacity: int):
    """Full-hit-list locate staying on the device: enumerate, then the
    backtrace and resolve of every slot (K3 or K3w on the card). Returns
    (hits int64, query ids int32, valid mask), each (capacity,), as the
    JAX package's ``locate_flat_device``: masked slots resolve position 0
    and must be ignored. Span ``awfm.locate``, around ``awfm.enumerate``
    and ``awfm.backtrace``."""
    if dev.sampled_sa is None:
        raise ValueError("locate_flat_device needs the sampled suffix array on the device")
    with metrics.span("locate"):
        pos, qid, mask = enumerate_flat(start, end, capacity=capacity, wide=dev.wide)
        return backtrace_resolve(dev, pos), qid, mask


def locate_first_hit(dev, start: torch.Tensor, end: torch.Tensor) -> torch.Tensor:
    """The database position of each range's first BWT row (0 for an
    empty range), on the device: ``bench.py``'s first-hit locate, the
    per-hit backtrace cost in isolation."""
    if dev.sampled_sa is None:
        raise ValueError("locate_first_hit needs the sampled suffix array on the device")
    valid = rank_ops.le_unsigned(start, end, dev.wide)
    zero = torch.zeros((), dtype=torch.int64, device=start.device)
    hits = backtrace_resolve(dev, torch.where(valid, start, zero))
    return torch.where(valid, hits, zero)


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------

class SearchEngine:
    """Batched count/locate over an index resident on ``device``.

    ``wide`` and ``pair_rows`` are passed to ``FmIndex.to_device``: None
    picks the 64-bit view for bwtLength >= 2^32, True forces it on a
    smaller index; ``pair_rows=False`` builds the view without pair rows
    (None: the installed view's layout, else pair rows). The answers are
    the same either way. A ``DeviceIndex`` brings its own width and
    layout."""

    def __init__(self, index: Union[FmIndex, DeviceIndex], *, device,
                 wide: Optional[bool] = None, pair_rows: Optional[bool] = None):
        self.device = as_device(device)
        if isinstance(index, FmIndex):
            self.host_index = index
            self.dev = index.to_device(self.device, wide=wide, pair_rows=pair_rows)
        else:
            if wide is not None and wide != index.wide:
                raise ValueError("a DeviceIndex brings its own width")
            if pair_rows is not None and index.pair_rows != view_has_pair_rows(
                    index.alphabet, index.wide, pair_rows):
                raise ValueError("a DeviceIndex brings its own layout (pair_rows)")
            if index.shard:
                raise ValueError("a shard of the range-sharded engine is no whole view")
            if index.device != self.device:
                raise ValueError(
                    f"DeviceIndex lives on {index.device}, not {self.device}"
                )
            self.host_index = None
            self.dev = index
        self.wide = self.dev.wide
        self._ascii_lut = (
            alpha.AA_ASCII_TO_INDEX
            if self.dev.alphabet == AlphabetType.AMINO
            else alpha.NT_ASCII_TO_INDEX
        )

    # -- encoding -----------------------------------------------------------

    def encode_kmers(self, kmers: Sequence[Union[str, bytes]]):
        """ASCII kmers -> (padded letter-index matrix, lengths, n).

        Pads the batch to a power-of-two size with 'A'*L rows (their
        results are dropped) and the length axis to a multiple of 4,
        exactly as the JAX package does.
        """
        n = len(kmers)
        if n == 0:
            raise ValueError("kmers must be non-empty")
        if all(type(k) is bytes for k in kmers):
            lengths = np.fromiter(map(len, kmers), dtype=np.int32, count=n)
            if lengths.min() < 1:
                raise ValueError("kmers must be non-empty")
            if (lengths == lengths[0]).all():
                length = int(lengths[0])
                flat = np.frombuffer(b"".join(kmers), dtype=np.uint8)
                rows = self._ascii_lut[flat].reshape(n, length)
                b_pad = _round_up_pow2(n)
                mat = np.zeros((b_pad, _round_up(length, 4)), dtype=np.uint8)
                mat[:n, :length] = rows
                return mat, np.full(b_pad, length, dtype=np.int32), n
        encoded = [
            self._ascii_lut[np.frombuffer(
                k.encode() if isinstance(k, str) else k, dtype=np.uint8
            )]
            for k in kmers
        ]
        lengths = np.array([len(e) for e in encoded], dtype=np.int32)
        if lengths.min() < 1:
            raise ValueError("kmers must be non-empty")
        b_pad = _round_up_pow2(len(encoded))
        mat = np.zeros((b_pad, _round_up(int(lengths.max()), 4)), dtype=np.uint8)
        for i, e in enumerate(encoded):
            mat[i, : len(e)] = e
        # pad rows take the first real kmer's length, sharing its seed
        # eligibility
        lengths_padded = np.full(b_pad, lengths[0], dtype=np.int32)
        lengths_padded[: len(lengths)] = lengths
        return mat, lengths_padded, len(kmers)

    def _seed_eligibility(self, mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """awFmQueryCanUseKmerTable (AwFmKmerTable.c:4-19): length >= k and
        no ambiguity letter among the last k letters."""
        k = self.dev.kmer_length_in_seed_table
        card = self.dev.cardinality
        _, l_pad = mat.shape
        idxs = np.clip(lengths[:, None] - k + np.arange(k)[None, :], 0, l_pad - 1)
        last_k = np.take_along_axis(mat, idxs, axis=1)
        return (lengths >= k) & (last_k < card).all(axis=1)

    # -- range search -------------------------------------------------------

    def _ranges_device(self, mat: np.ndarray, lengths: np.ndarray):
        """(start, end) int64 tensors on the device for an encoded batch.

        Seed-eligible and ineligible queries are partitioned by a
        per-query flag that K2 reads, so both run in one launch."""
        seeded = self._seed_eligibility(mat, lengths)
        return search_ranges(
            self.dev,
            torch.from_numpy(mat).to(self.device),
            torch.from_numpy(lengths.astype(np.int32)).to(self.device),
            torch.from_numpy(seeded.astype(np.uint8)).to(self.device),
        )

    def find_ranges_encoded(self, mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Final BWT ranges for an encoded batch -> (B, 2) uint64 host array."""
        start, end = self._ranges_device(mat, lengths)
        return torch.stack([start, end], dim=1).cpu().numpy().astype(np.uint64)

    def find_ranges(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        mat, lengths, n = self.encode_kmers(kmers)
        return self.find_ranges_encoded(mat, lengths)[:n]

    # -- public count / locate ---------------------------------------------

    def count(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """Occurrences of each kmer (awFmParallelSearchCount parity)."""
        metrics.counter("search.count.queries").add(len(kmers))
        with metrics.timer("search.count.seconds"):
            mat, lengths, n = self.encode_kmers(kmers)
            start, end = self._ranges_device(mat, lengths)
            return range_counts(start[:n], end[:n], self.wide).cpu().numpy().astype(np.uint64)

    def locate(self, kmers: Sequence[Union[str, bytes]]) -> List[np.ndarray]:
        """Database hit positions per kmer, in range order
        (awFmParallelSearchLocate parity)."""
        hits, counts = self._locate_flat(kmers)
        return np.split(hits, np.cumsum(counts)[:-1])

    def _locate_flat(self, kmers: Sequence[Union[str, bytes]]):
        """(every kmer's hits in range order, one flat uint64 array; the
        hits per kmer): ``locate`` before its split into one array per
        kmer, which callers that merge hits (the chunked corpus) skip."""
        metrics.counter("search.locate.queries").add(len(kmers))
        with metrics.timer("search.locate.seconds"):
            mat, lengths, n = self.encode_kmers(kmers)
            start, end = self._ranges_device(mat, lengths)
            counts = range_counts(start[:n], end[:n], self.wide)
            hits = self._resolve(enumerate_range_positions(start[:n], counts))
            counts = counts.cpu().numpy()
        metrics.counter("search.locate.hits").add(int(counts.sum()))
        return hits, counts

    def resolve_positions(self, bwt_positions: np.ndarray) -> np.ndarray:
        """Backtrace + resolve a flat array of BWT positions to hits."""
        if len(bwt_positions) == 0:
            return np.empty(0, dtype=np.uint64)
        pos = torch.from_numpy(np.asarray(bwt_positions).astype(np.int64))
        return self._resolve(pos.to(self.device))

    def _sa_on_disk(self) -> bool:
        """True when the sampled SA is read from the index file; raises
        when it is neither in memory nor backed by a file."""
        if self.dev.sampled_sa is not None:
            return False
        if self.host_index is None or self.host_index.file_path is None:
            raise ValueError(
                "suffix array not in memory and no backing file to read "
                "from (build or load the index with a file_src)"
            )
        return True

    def _resolve(self, positions: torch.Tensor) -> np.ndarray:
        if not self._sa_on_disk():
            return backtrace_resolve(self.dev, positions).cpu().numpy().astype(np.uint64)
        p, off = backtrace_resolve(self.dev, positions)
        return self._resolve_from_file(p.cpu().numpy(), off.cpu().numpy())

    def _resolve_from_file(self, sampled_positions, offsets) -> np.ndarray:
        """Resolve sampled-SA values from the index file — the on-disk
        suffix-array mode (awFmGetSuffixArrayValueFromFile,
        AwFmFile.c:484-522), as one vectorized gather over a read-only
        memmap of the packed-SA region."""
        from . import suffix_array as sa_mod
        from .io import awfmi

        index = self.host_index
        width = sa_mod.value_min_bit_width(index.bwt_length)
        file_offset = index.suffix_array_file_offset or awfmi.suffix_array_file_offset(
            index
        )
        bwt_length = index.bwt_length
        ratio = self.dev.ratio
        sample_idx = np.asarray(sampled_positions, dtype=np.uint64) // np.uint64(ratio)
        offsets = np.asarray(offsets, dtype=np.uint64)
        region_len = sa_mod.compressed_sa_size_in_bytes(bwt_length, ratio)
        mm = np.memmap(
            index.file_path, mode="r", offset=file_offset,
            shape=(region_len,), dtype=np.uint8,
        )
        bit = sample_idx * np.uint64(width)
        byte_off = (bit >> np.uint64(3)).astype(np.int64)
        bit_off = (bit & np.uint64(7)).astype(np.uint64)
        # 9 bytes per hit: the widest value spans 57 + 7 bits
        spans = byte_off[:, None] + np.arange(9, dtype=np.int64)[None, :]
        raw = np.asarray(mm[np.minimum(spans, region_len - 1)])
        del mm
        lo = raw[:, :8].copy().view("<u8")[:, 0] >> bit_off
        keep_lo = np.minimum(np.uint64(64) - bit_off, np.uint64(63))
        hi = raw[:, 8].astype(np.uint64) << keep_lo
        hi = np.where(bit_off == 0, np.uint64(0), hi)  # 9th byte only when bit_off > 0
        vals = (lo | hi) & ((np.uint64(1) << np.uint64(width)) - np.uint64(1))
        return (vals + offsets) % np.uint64(bwt_length)


class NgramSearchEngine(SearchEngine):
    """SearchEngine whose uniform-length, ambiguity-free nucleotide
    batches extend n letters per pair-row read over the n-gram table
    (K4); every other batch falls back to the single-step engine (K2),
    with identical results either way."""

    def __init__(self, index: FmIndex, n: int = 2, *, device,
                 wide: Optional[bool] = None, pair_rows: Optional[bool] = None):
        super().__init__(index, device=device, wide=wide, pair_rows=pair_rows)
        if self.dev.alphabet == AlphabetType.AMINO:
            raise NotImplementedError("n-gram stepping is nucleotide-only")
        if not isinstance(index, FmIndex):
            raise TypeError("NgramSearchEngine requires a host FmIndex")
        if self.wide:
            raise NotImplementedError(
                "n-gram stepping is narrow-only, as in the JAX package: "
                "indexes of 2^32 positions and more use the single-step "
                "SearchEngine (ROADMAP item 'n-gram stepping over wide rows')"
            )
        self.ng = ngram_ops.build_ngram_device(index, n, device=self.device)

    def _ranges_device(self, mat: np.ndarray, lengths: np.ndarray):
        """K4 for a uniform batch of clean letters longer than the seed;
        the single-step path otherwise. ``count``, ``locate`` and
        ``find_ranges`` all come through here. The pad rows of an encoded
        batch share the first query's length and are all 'A', so the
        whole padded batch passes exactly when its real rows do."""
        kmer_len = int(lengths[0])
        if (
            kmer_len > self.dev.kmer_length_in_seed_table
            and (lengths == kmer_len).all()
            and (mat[:, :kmer_len] < self.dev.cardinality).all()
        ):
            return ngram_ranges(
                self.dev, self.ng, torch.from_numpy(mat).to(self.device), kmer_len
            )
        return super()._ranges_device(mat, lengths)


class DigramSearchEngine(NgramSearchEngine):
    """The n = 2 (double-step) engine."""

    def __init__(self, index: FmIndex, *, device, wide: Optional[bool] = None,
                 pair_rows: Optional[bool] = None):
        super().__init__(index, n=2, device=device, wide=wide, pair_rows=pair_rows)


# ---------------------------------------------------------------------------
# Single-query parity API (AwFmSearch.c)
# ---------------------------------------------------------------------------

def _from_u64(t: torch.Tensor) -> int:
    """The first value of an int64 tensor, read as a u64."""
    return int(t[0]) & 0xFFFFFFFFFFFFFFFF


def iterative_step_backward_search(index: FmIndex, start_ptr: int, end_ptr: int,
                                   letter_index: int, *, device,
                                   wide: Optional[bool] = None,
                                   pair_rows: Optional[bool] = None) -> Tuple[int, int]:
    """awFmNucleotide/AminoIterativeStepBackwardSearch (AwFmSearch.c:42-159).

    One unconditional backward step on an explicit [start, end] range,
    the letter-by-letter building block of custom search loops. Returns
    the new (start_ptr, end_ptr). ``wide`` and ``pair_rows``, here and
    below, are ``FmIndex.to_device``'s: None picks the width by
    bwtLength; ``pair_rows=False``, the view without pair rows, None the
    installed view's layout. On the card the step is one launch of K1's
    step mode with the range and the letter passed by value, and one 16 B
    readback (``rank.single_step``)."""
    dev = index.to_device(device, wide=wide, pair_rows=pair_rows)
    return rank_ops.single_step(dev, start_ptr, end_ptr, letter_index)


def search_range_is_valid(start_ptr: int, end_ptr: int) -> bool:
    """awFmSearchRangeIsValid (AwFmIndexStruct.c:99-102)."""
    return start_ptr <= end_ptr


def query_can_use_kmer_table(index: FmIndex, kmer: Union[str, bytes]) -> bool:
    """awFmQueryCanUseKmerTable (AwFmKmerTable.c:4-19): the kmer is at
    least seed-table length and its last k letters hold no ambiguity
    character."""
    data = kmer.encode() if isinstance(kmer, str) else kmer
    k = index.config.kmer_length_in_seed_table
    if len(data) < k:
        return False
    lett = alpha.ascii_to_index(np.frombuffer(data[-k:], np.uint8), index.alphabet)
    return bool((lett < alpha.cardinality(index.alphabet)).all())


def find_database_hit_positions(index: FmIndex, start_ptr: int, end_ptr: int, *,
                                device, wide: Optional[bool] = None,
                                pair_rows: Optional[bool] = None) -> np.ndarray:
    """awFmFindDatabaseHitPositions (AwFmSearch.c:161-246): every BWT
    position of [start_ptr, end_ptr] backtraced and resolved to a
    database position (uint64; empty for an invalid range)."""
    if start_ptr > end_ptr:
        return np.empty(0, dtype=np.uint64)
    positions = np.arange(start_ptr, end_ptr + 1, dtype=np.uint64)
    eng = SearchEngine(index, device=device, wide=wide, pair_rows=pair_rows)
    return eng.resolve_positions(positions)


def find_database_hit_position_single(index: FmIndex, bwt_position: int, *, device,
                                      wide: Optional[bool] = None,
                                      pair_rows: Optional[bool] = None) -> int:
    """awFmFindDatabaseHitPositionSingle (AwFmSearch.c:248-282)."""
    eng = SearchEngine(index, device=device, wide=wide, pair_rows=pair_rows)
    return int(eng.resolve_positions(np.array([bwt_position], dtype=np.uint64))[0])


def backtrace_return_previous_letter_index(index: FmIndex, bwt_position: int, *,
                                           device, wide: Optional[bool] = None,
                                           pair_rows: Optional[bool] = None) -> Tuple[int, int]:
    """awFm*BacktraceReturnPreviousLetterIndex (AwFmSearch.c:429-483).

    Returns (letter_index, new_bwt_position): the BWT letter at the
    position and its LF mapping. A sentinel returns letter 0 and leaves
    the position unchanged, as the reference's early-out does (it
    returns before writing *bwtPosition, AwFmSearch.c:443-445). On the
    card: one launch of K1's LF mode by value, one readback
    (``rank.single_lf``)."""
    dev = index.to_device(device, wide=wide, pair_rows=pair_rows)
    lett, lf = rank_ops.single_lf(dev, bwt_position)
    if lett == dev.sentinel:
        return 0, bwt_position
    return lett, lf


def find_search_range_for_string(index: FmIndex, kmer: Union[str, bytes], *,
                                 device, wide: Optional[bool] = None,
                                 pair_rows: Optional[bool] = None) -> Tuple[int, int]:
    """awFmFindSearchRangeForString (AwFmSearch.c:317-358). Like the
    reference, this path never uses the kmer seed table. Returns
    (start_ptr, end_ptr) as Python ints."""
    eng = SearchEngine(index, device=device, wide=wide, pair_rows=pair_rows)
    mat, lengths, _ = eng.encode_kmers([kmer])
    start, end = search_ranges(
        eng.dev,
        torch.from_numpy(mat).to(eng.device),
        torch.from_numpy(lengths.astype(np.int32)).to(eng.device),
        torch.zeros(mat.shape[0], dtype=torch.uint8, device=eng.device),
    )
    return _from_u64(start), _from_u64(end)


def single_kmer_exists(index: FmIndex, kmer: Union[str, bytes], *, device,
                       wide: Optional[bool] = None, pair_rows: Optional[bool] = None) -> bool:
    """awFmSingleKmerExists (AwFmSearch.c:360-367)."""
    s, e = find_search_range_for_string(index, kmer, device=device, wide=wide,
                                        pair_rows=pair_rows)
    return s <= e


def create_initial_query_range(index: FmIndex, query: Union[str, bytes]) -> Tuple[int, int]:
    """awFmCreateInitialQueryRange (AwFmSearch.c:6-25); host arithmetic
    on the prefix sums, no device involved."""
    data = query.encode() if isinstance(query, str) else query
    lett = int(alpha.ascii_to_index(np.frombuffer(data, np.uint8), index.alphabet)[-1])
    return int(index.prefix_sums[lett]), int(index.prefix_sums[lett + 1]) - 1

"""n-step (n-gram) backward search — n letters per rank step, n in {2, 3}.

Counterpart of ``avxwindowfmindex_tpu/ops/ngram.py``. A windowed BWT over
the n characters preceding each suffix lets one pair-row read extend the
pattern by n letters (the classical k-step FM-index):

    BWTn[i] = T[SA[i]-n .. SA[i]-1]
    range(wP) = [ Cn[w] + occn_incl(w, start-1),
                  Cn[w] + occn_incl(w, end) - 1 ]        |w| = n

Nucleotide only: the clean symbols are the 4^n words over ACGT, and every
word touching the sentinel or an ambiguity letter is DIRTY (code 4^n).

The host half (``_geometry`` .. ``pair_rows_from_ngram_blocks``, the Cn
pre-bias fold) is a NumPy copy of the JAX module with its byte layouts
unchanged, so both packages build the same table bytes. Pair-row layout
(``_geometry_pair``):

    n=2: 5 planes x 64 B | 16 u32 milestones at byte 320 -> 384 B rows
    n=3: 7 planes x 64 B | 64 u32 milestones at byte 448 -> 768 B rows

Plane i of pair row b holds bit i of the codes of blocks b and b+1
(512 positions); the top plane (index 2n) is the dirty marker. The
milestones are block b's, pre-biased by Cn when ``biased``.

K4 reads a second table, ``NgramIndex.k4``: the same rows with each
row's bytes in K4's order (``_geometry_k4``, ``k4_rows``), made on the
card from ``packed`` when an index is placed there. The host build, the
``.npz`` cache and ``packed`` keep the layout above.

The device half is plain torch over int64-held u32 values, with the JAX
edge cases: ``start - 1`` wraps to 0xFFFFFFFF at start 0, the block index
clamps to the last row, a row whose range is invalid keeps it. The
one-row pair step (``ngram_backward_step_pair``) is the compute of the
Pallas kernel ``experiments/ab_r5_pallas_gather.py:_k2_kernel``; on the
card K4 (``csrc/awfm_kernels.cu``) runs it, for a range inside the first
block of its row from that block's sectors alone
(``ngram_backward_step_first_block``), and ``search.ngram_ranges`` is
its dispatch wrapper.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch

from ..models.config import AlphabetType
from ..models.index import (
    MASK32,
    POSITIONS_PER_BLOCK,
    FmIndex,
    num_blocks_from_bwt_length,
    widen_u32,
)
from .rank import _gather_rows, _inclusive_mask, _popcount_sum, window_delta


def _geometry(n: int):
    if n not in (2, 3):
        raise ValueError("n-gram stepping supports n in {2, 3}")
    n_words = 4**n
    dirty = n_words
    n_planes = (2 * n + 1)
    ms_offset = n_planes * 32
    row_bytes = ms_offset + n_words * 4
    row_bytes = ((row_bytes + 127) // 128) * 128
    return n_words, dirty, n_planes, ms_offset, row_bytes


def _geometry_pair(n: int):
    """Pair-row layout: plane i covers 512 positions (blocks b, b+1) at
    bytes [i*64, (i+1)*64); block b's milestones follow."""
    n_words, dirty, n_planes, _, _ = _geometry(n)
    ms_offset = n_planes * 64
    row_bytes = ms_offset + n_words * 4
    row_bytes = ((row_bytes + 127) // 128) * 128
    return n_words, dirty, n_planes, ms_offset, row_bytes


def _geometry_k4(n: int):
    """K4's layout of a pair row: the width and row index of
    ``_geometry_pair``'s, the bytes in another order. The first 32 B of
    each plane (block b's words 0-7) lie back to back from byte 0, block
    b's milestones follow, then the second 32 B of each plane (block
    b+1), then the padding:

        n=2: 5 x 32 B | 16 u32 milestones at 160 | 5 x 32 B at 224 -> 384 B
        n=3: 7 x 32 B | 64 u32 milestones at 224 | 7 x 32 B at 480 -> 768 B

    A visit whose range lies in the row's first block reads bytes
    [0, 32 planes) and one milestone word: adjacent 64 B pieces (3 or 4
    of 6 at n = 2, 4 or 5 of 12 at n = 3), where the pair layout spreads
    the same sectors over one piece a plane. Returns (n_planes,
    ms_offset, hi_offset, row_bytes)."""
    n_words, _, n_planes, _, row_bytes = _geometry_pair(n)
    ms_offset = n_planes * 32
    hi_offset = ms_offset + n_words * 4
    return n_planes, ms_offset, hi_offset, row_bytes


def k4_row_order(n: int) -> np.ndarray:
    """(row_bytes,) int64: byte j of a K4 row is byte ``order[j]`` of the
    pair row (``_geometry_pair``) it is made from."""
    n_words, _, _, pair_ms_offset, _ = _geometry_pair(n)
    n_planes, ms_offset, hi_offset, row_bytes = _geometry_k4(n)
    order = np.arange(row_bytes, dtype=np.int64)  # the padding stays
    j = np.arange(32)
    for i in range(n_planes):
        order[32 * i + j] = 64 * i + j
        order[hi_offset + 32 * i + j] = 64 * i + 32 + j
    order[ms_offset:hi_offset] = pair_ms_offset + np.arange(n_words * 4)
    return order


def k4_rows(packed: torch.Tensor, n: int) -> torch.Tensor:
    """K4's table: the pair rows ``packed`` with each row's bytes in K4's
    order, by one gather on ``packed``'s device."""
    order = torch.from_numpy(k4_row_order(n)).to(packed.device)
    return packed.index_select(1, order)


@dataclasses.dataclass
class NgramIndex:
    """Device tables of the n-step path.

    ``packed`` holds PAIR rows (blocks b and b+1 fused): the backward
    step reads one row when the range fits the 512-position window, and
    single-position ranks read the first-block half of the same rows.
    When ``biased`` the stored milestones hold Cn[w] + occ_before_block
    (exact in u32, bwtLength < 2^32), so a step needs no Cn select.

    ``k4`` is K4's table, ``k4_rows(packed, n)``, made whenever the index
    is made with ``packed`` on a CUDA device (None elsewhere: the plain
    versions read ``packed``).
    """

    packed: torch.Tensor  # (num_blocks, pair_row_bytes) uint8
    cn: torch.Tensor  # (4**n,) u32 as int32: range start of each n-mer
    n: int  # letters per step
    biased: bool = False
    k4: Optional[torch.Tensor] = dataclasses.field(default=None, init=False, repr=False,
                                                   compare=False)

    def __post_init__(self):
        if self.packed.is_cuda:
            self.k4 = k4_rows(self.packed, self.n)


# ---------------------------------------------------------------------------
# Host-side construction (NumPy copies of the JAX module)
# ---------------------------------------------------------------------------

_HOST_CHUNK = 1 << 26  # 64M positions per pass bounds host temporaries


def _lf_array(index: FmIndex) -> np.ndarray:
    """Vectorized LF over all BWT positions (sentinel -> 0).

    uint32 output when it fits, per-letter flatnonzero groups instead of
    a full stable argsort, and no int64 copy of the BWT.
    """
    bwt = index.bwt_letters  # uint8, not copied
    ps = index.prefix_sums
    sentinel = index.sentinel_index
    dtype = np.uint32 if index.bwt_length < (1 << 32) else np.int64
    lf = np.zeros(index.bwt_length, dtype=dtype)
    # flatnonzero is ascending, so each letter's occurrences keep their
    # BWT order — the defining property of LF
    for lett in range(sentinel + 1):
        grp = np.flatnonzero(bwt == lett)
        if lett != sentinel:
            vals = np.arange(len(grp), dtype=dtype)
            vals += dtype(int(ps[lett]))
            lf[grp] = vals
            del vals
        del grp
    return lf


def _letter_counts_before(bwt: np.ndarray, bounds: np.ndarray,
                          n_letters: int = 4) -> np.ndarray:
    """occ matrix: out[x, i] = #{p < bounds[i] : bwt[p] == x},
    x in [0, n_letters), in one chunked pass over the BWT."""
    bounds = np.asarray(bounds, dtype=np.int64)
    order = np.argsort(bounds, kind="stable")
    out = np.zeros((n_letters, len(bounds)), dtype=np.int64)
    running = np.zeros(n_letters, dtype=np.int64)
    bi = 0
    n = len(bwt)
    for lo in range(0, n, _HOST_CHUNK):
        hi = min(lo + _HOST_CHUNK, n)
        while bi < len(order) and bounds[order[bi]] <= hi:
            b = int(bounds[order[bi]])
            out[:, order[bi]] = running + np.bincount(
                bwt[lo:b], minlength=8
            )[:n_letters]
            bi += 1
        if bi == len(order):
            break
        running += np.bincount(bwt[lo:hi], minlength=8)[:n_letters]
    return out


def build_ngram_host(index: FmIndex, n: int):
    """(codes, cn): the n-gram BWT codes and the n-mer range starts.

    All whole-index work is chunked and uint8/uint32, so a genome-scale
    build peaks ~6 bytes/position beyond the index itself.
    """
    if index.alphabet == AlphabetType.AMINO:
        raise NotImplementedError("n-gram stepping is nucleotide-only")
    n_words, dirty, _, _, _ = _geometry(n)
    bwt = index.bwt_letters  # uint8
    ps = index.prefix_sums.astype(np.int64)
    length = index.bwt_length

    lf = _lf_array(index)
    # letters[j] = T[SA[i] - 1 - j] via j LF steps; code = sum letters[j]
    # * 4^j, i.e. the word value of T[SA[i]-n..SA[i]-1] base 4 with the
    # LEFTMOST character most significant. Max 5+4*5+16*5 = 105 fits
    # uint8 for n <= 3.
    codes = np.empty(length, dtype=np.uint8)
    for lo in range(0, length, _HOST_CHUNK):
        c0 = bwt[lo : lo + _HOST_CHUNK]
        code = c0.copy()
        clean = c0 < 4
        idx = lf[lo : lo + _HOST_CHUNK]
        for j in range(1, n):
            lj = bwt[idx]
            clean &= lj < 4
            code += lj * np.uint8(4**j)
            if j + 1 < n:
                idx = lf[idx]
        codes[lo : lo + _HOST_CHUNK] = np.where(clean, code, np.uint8(dirty))
    del lf

    # Cn[w] = range start of the n-mer w: fold backward steps from the
    # (n-1)-mer starts. C1 = prefix sums; occ thresholds counted in one
    # chunked pass per depth.
    c_prev = ps[:4].astype(np.uint64)  # C1[y] = ps[y]
    for depth in range(1, n):
        occ = _letter_counts_before(bwt, c_prev)
        c_new = np.empty(4 * len(c_prev), dtype=np.uint64)
        for x in range(4):
            # new word = x * 4^depth + suffix-word (x most significant)
            c_new[x * len(c_prev) : (x + 1) * len(c_prev)] = ps[x] + occ[x]
        c_prev = c_new
    return codes, c_prev


def pack_ngram_blocks(codes: np.ndarray, n: int) -> np.ndarray:
    """n-gram codes -> (num_blocks, row_bytes) uint8 fused rows."""
    n_words, dirty, n_planes, ms_offset, row_bytes = _geometry(n)
    length = len(codes)
    nb = num_blocks_from_bwt_length(length)
    padded = np.full(nb * POSITIONS_PER_BLOCK, dirty, dtype=np.uint8)
    padded[:length] = codes

    out = np.zeros((nb, row_bytes), dtype=np.uint8)
    for b in range(n_planes):
        bits = ((padded >> b) & 1).reshape(nb, POSITIONS_PER_BLOCK)
        out[:, b * 32 : (b + 1) * 32] = np.packbits(
            bits, axis=1, bitorder="little"
        )
    # per-symbol per-block sums over the (nb, 256) uint8 view: no
    # O(length) int64 key temporaries
    codes_mat = padded.reshape(nb, POSITIONS_PER_BLOCK)
    counts = np.empty((nb, n_words), dtype=np.int64)
    for w in range(n_words):
        counts[:, w] = (codes_mat == w).sum(axis=1)
    cum = np.cumsum(counts, axis=0)
    milestones = np.zeros_like(cum)
    milestones[1:] = cum[:-1]
    out[:, ms_offset : ms_offset + n_words * 4] = (
        milestones.astype("<u4").view(np.uint8).reshape(nb, n_words * 4)
    )
    return out


def pair_rows_from_ngram_blocks(packed: np.ndarray, n: int) -> np.ndarray:
    """Per-block fused rows -> pair rows (blocks b,b+1 per row).

    The final row's missing partner keeps zero plane bytes: word code 0
    would match there, but those pair-local positions >= 256 of the last
    block lie beyond every valid query position, and the inclusive mask
    zeroes them for all in-range ranks.
    """
    n_words, dirty, n_planes, ms_offset, row_bytes = _geometry(n)
    _, _, _, pair_ms_offset, pair_row_bytes = _geometry_pair(n)
    nb = packed.shape[0]
    out = np.zeros((nb, pair_row_bytes), dtype=np.uint8)
    for i in range(n_planes):
        plane = packed[:, i * 32 : (i + 1) * 32]
        out[:, i * 64 : i * 64 + 32] = plane
        out[:-1, i * 64 + 32 : (i + 1) * 64] = plane[1:]
    ms_len = n_words * 4
    out[:, pair_ms_offset : pair_ms_offset + ms_len] = packed[
        :, ms_offset : ms_offset + ms_len
    ]
    return out


def build_ngram_pair_rows(index: FmIndex, n: int, bias_cn: bool = True):
    """(pair rows uint8, cn uint32): the finished host table, with Cn
    folded into the milestones in u32 when ``bias_cn``."""
    codes, cn = build_ngram_host(index, n)
    blocks = pack_ngram_blocks(codes, n)
    del codes
    pair = pair_rows_from_ngram_blocks(blocks, n)
    del blocks
    if bias_cn:
        n_words, _, _, ms_offset, _ = _geometry_pair(n)
        ms = pair[:, ms_offset : ms_offset + n_words * 4].copy()
        ms32 = ms.view("<u4").reshape(-1, n_words)
        ms32 += cn.astype(np.uint32)[None, :]
        pair[:, ms_offset : ms_offset + n_words * 4] = ms.reshape(
            pair.shape[0], n_words * 4
        )
    return pair, cn.astype(np.uint32)


def build_ngram_device(index: FmIndex, n: int, *, device, bias_cn: bool = True,
                       cache_path=None) -> NgramIndex:
    """The n-gram pair table of ``index`` on ``device``.

    ``cache_path``: optional ``.npz`` of the finished host rows, with the
    JAX package's keys (``pair``, ``cn``, ``biased``, ``n``,
    ``bwt_length``), so a file written by either package loads in the
    other. A file whose bias flag, n or bwt_length differs from this
    build is rebuilt and overwritten, never trusted.
    """
    from ..models.convert import ngram_index_from_numpy

    _geometry(n)
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            if (
                bool(z["biased"]) == bool(bias_cn)
                and "n" in z
                and int(z["n"]) == int(n)
                and int(z["bwt_length"]) == int(index.bwt_length)
            ):
                return ngram_index_from_numpy(z["pair"], z["cn"], n=n,
                                              biased=bias_cn, device=device)
    pair, cn = build_ngram_pair_rows(index, n, bias_cn)
    if cache_path:
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, pair=pair, cn=cn, biased=np.int64(int(bias_cn)),
                     n=np.int64(n), bwt_length=np.int64(index.bwt_length))
        os.replace(tmp, cache_path)
    return ngram_index_from_numpy(pair, cn, n=n, biased=bias_cn, device=device)


# ---------------------------------------------------------------------------
# Device functions (plain torch; K4 runs the pair step on the card)
# ---------------------------------------------------------------------------

def _word_value(letter_list):
    """Word value (int64) from per-position letters; letter_list[0] is
    the LEFTMOST (most significant) character of the n-gram."""
    n = len(letter_list)
    v = None
    for j, lett in enumerate(letter_list):
        term = lett.to(torch.int64) * (4 ** (n - 1 - j))
        v = term if v is None else v + term
    return v


def _pair_match(ng: NgramIndex, rows, v, plane_bytes: int = 64):
    """(B, plane_bytes) uint8 match bits for word value v over the first
    plane_bytes of each plane of a pair row: XOR of value planes 0..2n-1
    with bit i of v, OR the dirty plane 2n, NOT."""
    _, _, n_planes, _, _ = _geometry_pair(ng.n)
    diff = None
    for i in range(n_planes - 1):
        m = (((v >> i) & 1) * 0xFF).to(torch.uint8)
        x = rows[:, i * 64 : i * 64 + plane_bytes] ^ m[:, None]
        diff = x if diff is None else (diff | x)
    diff = diff | rows[:, (n_planes - 1) * 64 : (n_planes - 1) * 64 + plane_bytes]
    return torch.bitwise_not(diff)


def _pair_mask(local):
    """(B, 64) uint8 inclusive mask, local in [0, 512)."""
    return _inclusive_mask(local, 64)


def _pair_milestone(ng: NgramIndex, rows, v):
    """Little-endian u32 milestone of word v (one-hot: 0 outside [0, 4^n))."""
    n_words, _, _, ms_offset, _ = _geometry_pair(ng.n)
    ok = (v >= 0) & (v < n_words)
    vc = v.clamp(0, n_words - 1)
    idx = ms_offset + 4 * vc[:, None] + torch.arange(4, device=rows.device)[None, :]
    b = rows.gather(1, idx).to(torch.int64)
    shifts = torch.tensor([0, 8, 16, 24], device=rows.device)
    return torch.where(ok, (b << shifts).sum(dim=1), 0)


def _cn_select(ng: NgramIndex, v):
    """Cn[v] as int64 (one-hot: 0 outside [0, 4^n))."""
    n_words = 4**ng.n
    ok = (v >= 0) & (v < n_words)
    return torch.where(ok, widen_u32(ng.cn)[v.clamp(0, n_words - 1)], 0)


def ngram_occurrence(ng: NgramIndex, positions, letter_list):
    """Batched occn(w, pos), inclusive -> (B,) int64 u32 values, from the
    first-block half of each position's pair row. When ``ng.biased`` it
    is Cn[w] + occn(w, pos), the backward-step bound itself."""
    rows, local = _gather_rows(ng.packed, positions)
    v = _word_value(letter_list)
    cnt = _popcount_sum(_pair_match(ng, rows, v) & _pair_mask(local))
    return (_pair_milestone(ng, rows, v) + cnt) & MASK32


def ngram_backward_step(ng: NgramIndex, start, end, letter_list):
    """One exact n-step (two row reads, any range width): prepend the
    n-gram (letter_list, leftmost first). Rows with an invalid range
    keep it."""
    start = start.to(torch.int64) & MASK32
    end = end.to(torch.int64) & MASK32
    b = start.shape[0]
    occ = ngram_occurrence(
        ng, torch.cat([(start - 1) & MASK32, end]),
        [torch.cat([l, l]) for l in letter_list],
    )
    cn = 0 if ng.biased else _cn_select(ng, _word_value(letter_list))
    new_start = (cn + occ[:b]) & MASK32
    new_end = (cn + occ[b:] - 1) & MASK32
    keep = start <= end
    return torch.where(keep, new_start, start), torch.where(keep, new_end, end)


def ngram_backward_step_pair(ng: NgramIndex, start, end, letter_list, bad):
    """One-row n-step; flags ranges wider than the 512-position window.

    Returns (new_start, new_end, bad) exactly as the JAX function does: a
    valid row whose end lies past the window gets a clamped (wrong) end
    and its flag set. The window offset is compared in u32 before any
    narrowing.
    """
    start = start.to(torch.int64) & MASK32
    end = end.to(torch.int64) & MASK32
    v = _word_value(letter_list)
    cn = 0 if ng.biased else _cn_select(ng, v)
    pos_s = (start - 1) & MASK32
    rows, local_s = _gather_rows(ng.packed, pos_s)
    delta_e = (end - (pos_s & ~0xFF)) & MASK32
    overflow = delta_e >= 512
    local_e = torch.clamp(delta_e, max=511)
    match = _pair_match(ng, rows, v)
    occ_s = _popcount_sum(match & _pair_mask(local_s))
    occ_e = _popcount_sum(match & _pair_mask(local_e))
    ms = _pair_milestone(ng, rows, v)
    new_start = (cn + ms + occ_s) & MASK32
    new_end = (cn + ms + occ_e - 1) & MASK32
    keep = start <= end
    bad = bad | (overflow & keep)
    return torch.where(keep, new_start, start), torch.where(keep, new_end, end), bad


def ngram_backward_step_first_block(ng: NgramIndex, start, end, letter_list):
    """The first-block class of the one-row n-step: for a range with both
    ends in the first block of its row (delta < 256) it reads only bytes
    [64 p, 64 p + 32) of each plane p and the word's milestone, and gives
    what :func:`ngram_backward_step_pair` gives (whose mask then has no
    bit set in words 8-15). K4 takes this class for nearly every step.

    Returns (new_start, new_end, first): ``first`` marks the valid rows
    of that class; every other row keeps its range.
    """
    start = start.to(torch.int64) & MASK32
    end = end.to(torch.int64) & MASK32
    v = _word_value(letter_list)
    cn = 0 if ng.biased else _cn_select(ng, v)
    rows, local_s = _gather_rows(ng.packed, (start - 1) & MASK32)
    delta = window_delta(start, end, MASK32)
    first = (delta < 256) & (start <= end)
    match = _pair_match(ng, rows, v, 32)
    occ_s = _popcount_sum(match & _inclusive_mask(local_s, 32))
    occ_e = _popcount_sum(match & _inclusive_mask(delta.clamp(max=255), 32))
    ms = _pair_milestone(ng, rows, v)
    new_start = (cn + ms + occ_s) & MASK32
    new_end = (cn + ms + occ_e - 1) & MASK32
    return torch.where(first, new_start, start), torch.where(first, new_end, end), first

"""Suffix-array construction and the bit-packed sampled suffix array.

Construction replaces the reference's libdivsufsort dependency
(AwFmCreate.c:99-100). Two backends:

  - a native C++ SA-IS implementation (see native/), loaded via ctypes —
    the production path for genome-scale builds;
  - a pure-NumPy prefix-doubling fallback (O(n log^2 n)), always available.

Both sort suffixes of the *sanitized* sequence by raw ascii byte order,
exactly like divsufsort64 — which, for sanitized sequences, coincides
with letter-index order (with t/u adjacent as a stable tie-break).

The compressed sampled SA reproduces the reference's bit-packing
(AwFmSuffixArray.c): samples are BWT positions ≡ 0 (mod ratio); each
sample is stored in ``width = 64 - clzll(saLength - 1)`` bits, packed
little-endian into a contiguous bitstream (groups of 8 values align to
byte boundaries, AwFmSuffixArray.c:22-39, which is equivalent to a plain
w*i bit offset), plus 8 guard padding bytes (AwFmSuffixArray.c:9).

Copied from avxwindowfmindex_tpu/suffix_array.py; the native backend is
the port's own build of the same SA-IS source (native/hostlib.py).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

SUFFIX_ARRAY_END_PADDING_BYTES = 8  # AwFmSuffixArray.c:9


# ---------------------------------------------------------------------------
# Suffix array construction
# ---------------------------------------------------------------------------

def build_suffix_array_numpy(sequence: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array over raw bytes (divsufsort64 parity).

    Args:
      sequence: uint8 array INCLUDING the trailing sentinel byte.
    Returns:
      int64 array `sa` with sa[i] = start position of the i-th smallest
      suffix (byte-lexicographic).
    """
    seq = np.asarray(sequence, dtype=np.uint8)
    n = len(seq)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    if n == 1:
        return np.zeros(1, dtype=np.int64)

    rank = seq.astype(np.int64)
    k = 1
    while True:
        key2 = np.full(n, -1, dtype=np.int64)
        key2[: n - k] = rank[k:]
        order = np.lexsort((key2, rank))
        r1 = rank[order]
        r2 = key2[order]
        changed = np.empty(n, dtype=bool)
        changed[0] = False
        changed[1:] = (r1[1:] != r1[:-1]) | (r2[1:] != r2[:-1])
        new_rank_sorted = np.cumsum(changed)
        if new_rank_sorted[-1] == n - 1:
            return order.astype(np.int64)
        rank = np.empty(n, dtype=np.int64)
        rank[order] = new_rank_sorted
        k *= 2


def build_suffix_array(sequence: np.ndarray, backend: Optional[str] = None) -> np.ndarray:
    """Build the suffix array, preferring the native SA-IS backend.

    backend: None (auto), "native", or "numpy".
    """
    if backend != "numpy":
        try:
            from .native import hostlib

            if hostlib.available():
                return hostlib.suffix_array(np.asarray(sequence, dtype=np.uint8))
        except ImportError:
            pass
        if backend == "native":
            raise RuntimeError("native suffix-array backend unavailable")
    return build_suffix_array_numpy(sequence)


# ---------------------------------------------------------------------------
# Bit-packed sampled suffix array (AwFmSuffixArray.c parity)
# ---------------------------------------------------------------------------

def value_min_bit_width(sa_length: int) -> int:
    """64 - clzll(saLength - 1) (AwFmSuffixArray.c:12-18)."""
    if sa_length <= 1:
        raise ValueError("saLength must be >= 2")
    return int(sa_length - 1).bit_length()


def packed_offset(width: int, index: int) -> tuple:
    """(byte_offset, bit_offset) of sample `index` (AwFmSuffixArray.c:22-39).

    Equivalent to the flat bit offset width*index.
    """
    bit = width * index
    return bit // 8, bit % 8


def compressed_sa_size_in_bytes(sa_length: int, ratio: int) -> int:
    """awFmComputeCompressedSaSizeInBytes (AwFmSuffixArray.c:41-53)."""
    num_samples = (sa_length + ratio - 1) // ratio
    width = value_min_bit_width(sa_length)
    total_bits = num_samples * width
    nbytes = total_bits // 8
    if total_bits % 8 != 0:
        nbytes += 1
    return nbytes + SUFFIX_ARRAY_END_PADDING_BYTES


def pack_sampled_sa(full_sa: np.ndarray, sa_length: int, ratio: int) -> tuple:
    """Sample every ratio-th SA value and bit-pack (AwFmSuffixArray.c:58-112).

    Returns (packed_bytes, width). packed_bytes includes the 8 guard bytes.
    """
    width = value_min_bit_width(sa_length)
    samples = np.asarray(full_sa[::ratio], dtype=np.uint64)
    packed = pack_values(samples, width)
    total = compressed_sa_size_in_bytes(sa_length, ratio)
    out = np.zeros(total, dtype=np.uint8)
    out[: len(packed)] = packed
    return out, width


def guard_bytes_from_full_sa(full_sa: np.ndarray, sa_length: int, ratio: int) -> bytes:
    """The 8 trailing pad bytes of the reference's compressed SA region.

    awFmInitCompressedSuffixArray packs IN PLACE over the full u64 SA
    buffer and then reallocs down to compressedByteLength, which
    includes AW_FM_SUFFIX_ARRAY_END_PADDING_BYTES = 8 overread-guard
    bytes (AwFmSuffixArray.c:9, 58-112). Those guard bytes are never
    written by the packing loop, so the bytes that land in the .awfmi
    file are LEFTOVERS of the original little-endian u64 suffix-array
    image at the same byte offsets. Deterministic, so byte-identical
    output requires reproducing them; this computes exactly those 8
    bytes from the full SA before it is freed.
    """
    width = value_min_bit_width(sa_length)
    num_samples = (sa_length + ratio - 1) // ratio
    packed_len = (num_samples * width + 7) // 8
    lo_word = packed_len // 8
    start = packed_len - lo_word * 8
    buf = np.ascontiguousarray(
        full_sa[lo_word : lo_word + 2], dtype="<u8"
    ).tobytes()
    g = buf[start : start + 8]
    return g + b"\x00" * (8 - len(g))


# chunk budget (in bits) for the per-value bit matrices below; each
# chunk's value count is rounded to a multiple of 8 so chunk bit-streams
# land on byte boundaries and concatenate exactly
_PACK_CHUNK = 1 << 23


def pack_values(values: np.ndarray, width: int) -> np.ndarray:
    """Little-endian bit-pack `values` at `width` bits each.

    Chunked along the value axis (on 8-bit-aligned boundaries so chunk
    outputs concatenate exactly): the per-value bit matrix is width x
    8 bytes, which at hg38 scale (~4e8 samples, width 32) would be a
    ~100 GB transient if materialized whole.
    """
    values = np.asarray(values, dtype=np.uint64)
    if width < 1 or width > 64:
        raise ValueError("width must be in [1, 64]")
    shifts = np.arange(width, dtype=np.uint64)
    step = max(1, _PACK_CHUNK // width) * 8  # multiple of 8: byte-aligned
    parts = []
    for lo in range(0, len(values), step):
        v = values[lo : lo + step]
        bits = ((v[:, None] >> shifts[None, :]) & np.uint64(1)).astype(
            np.uint8
        )
        parts.append(np.packbits(bits.reshape(-1), bitorder="little"))
    if not parts:
        return np.zeros(0, dtype=np.uint8)
    return np.concatenate(parts)


def unpack_values(packed: np.ndarray, width: int, count: int) -> np.ndarray:
    """Inverse of :func:`pack_values`; returns uint64 (count,).

    Chunked like pack_values to bound the unpacked bit matrix.
    """
    packed = np.asarray(packed, dtype=np.uint8)
    if count * width > len(packed) * 8:
        raise ValueError("packed buffer too short")
    shifts = np.arange(width, dtype=np.uint64)
    step = max(1, _PACK_CHUNK // width) * 8  # multiple of 8: byte-aligned
    out = np.empty(count, dtype=np.uint64)
    for lo in range(0, count, step):
        n = min(step, count - lo)
        byte_lo = lo * width // 8  # exact: lo is a multiple of 8
        byte_hi = (lo + n) * width // 8 + 1
        bits = np.unpackbits(packed[byte_lo:byte_hi], bitorder="little")
        bits = bits[: n * width].reshape(n, width).astype(np.uint64)
        out[lo : lo + n] = (bits << shifts[None, :]).sum(
            axis=1, dtype=np.uint64
        )
    return out


def read_packed_value(buffer, width: int, index: int) -> int:
    """Read one value from a packed buffer (AwFmSuffixArray.c:114-142).

    `buffer` is a bytes-like or uint8 array with the guard padding intact.
    """
    byte_off, bit_off = packed_offset(width, index)
    window = bytes(bytes(buffer[byte_off : byte_off + 9]).ljust(9, b"\0"))
    value = int.from_bytes(window, "little")
    return (value >> bit_off) & ((1 << width) - 1)


def read_packed_value_from_file(fileobj, file_offset: int, width: int, index: int) -> int:
    """awFmGetSuffixArrayValueFromFile parity (AwFmFile.c:484-522).

    Reads <=9 bytes at the packed offset from an open binary file.
    """
    byte_off, bit_off = packed_offset(width, index)
    nbytes = (bit_off + width + 7) // 8
    fileobj.seek(file_offset + byte_off)
    data = fileobj.read(nbytes)
    if len(data) != nbytes:
        raise IOError("short read from suffix array region")
    value = int.from_bytes(data.ljust(9, b"\0"), "little")
    return (value >> bit_off) & ((1 << width) - 1)

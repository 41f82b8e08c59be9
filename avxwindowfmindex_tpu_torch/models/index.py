"""The FM-index data model: the NumPy host index and its torch device view.

The host half (``FastaMetadata``, ``FmIndex``, the geometry helpers and
the row packers) is carried over from ``avxwindowfmindex_tpu/models/
index.py`` with its byte layouts unchanged, so both packages build the
same arrays. The device half is a dataclass of torch tensors.

Device row layout (identical to the JAX package):

  nucleotide: [plane0 x32B | plane1 x32B | plane2 x32B |
               milestones 5 x u32LE | pad] = 128 B
  amino:      [plane0..plane4 x32B | milestones 21 x u32LE | pad] = 256 B

Plane byte j holds local positions j*8..j*8+7, bit p%8. A pair row b
fuses the planes of blocks b and b+1 (64 B per plane) plus block b's
milestones at byte ``n_planes*64``.

torch has no arithmetic on uint32, so every u32 device table is stored
as an int32 tensor holding the same bytes (``u32_tensor``); the kernels
read it through ``const uint32_t*`` and the plain torch code widens it
with ``.to(torch.int64) & 0xFFFFFFFF``.

Wide layout, for bwtLength >= 2^32 (``to_device(device, wide=True)``;
the JAX package's ``DeviceIndex64``, ops/rank64.py): ONE table of
pair-fused rows with u64 milestones,

  plane i: bytes [64i, 64i+32) = block b, [64i+32, 64i+64) = block b+1
  nucleotide: [3 planes x 64 B | 5 x u64LE milestones | pad]  = 256 B
  amino:      [5 planes x 64 B | 21 x u64LE milestones | pad] = 512 B

which serves the pair step (all 64 B of each plane) and the
single-position ranks (the first 32 B). CUDA and torch have 64-bit
integers, so the wide view needs no hi/lo pairs: prefix sums, seed table
and sampled SA are int64 tensors whose bytes equal the JAX arrays'
(u64 little-endian = [lo, hi] u32 pairs), and positions are u64 values
carried in int64 tensors, two's complement standing in for the wrap
mod 2^64. The same functions serve both widths; a ``DeviceIndex`` says
which it is (``wide``) and gives the row geometry.

Views without pair rows (``to_device(device, pair_rows=False)``; the
JAX package's ``AWFM_PAIR_ROWS=0``): a narrow view keeps its block rows
and no pair table (``packed_pair`` None); a wide amino view keeps the
compact rows of ``pack_device_blocks64(pair=False)`` (384 B: planes 32 B
apart, milestones at ``n_planes * 32``; ``pair_fused`` False) in place
of the 512 B pair-fused ones. A wide nucleotide view keeps its 256 B
pair-fused rows, which cost nothing beyond the compact ones, as the JAX
package does. A step over such a view reads its first-block class from
the block row and every wider range from two block rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from . import alphabet as alpha
from .config import (
    CURRENT_VERSION_NUMBER,
    FEATURE_FLAG_BIT_FASTA_VECTOR,
    AlphabetType,
    IndexConfiguration,
)

POSITIONS_PER_BLOCK = alpha.POSITIONS_PER_BLOCK
MASK32 = 0xFFFFFFFF
MASK64 = -1  # int64 tensors already wrap mod 2^64


# ---------------------------------------------------------------------------
# Geometry helpers (AwFmIndexStruct.c:77-130)
# ---------------------------------------------------------------------------

def num_blocks_from_bwt_length(bwt_length: int) -> int:
    """1 + (len-1)//256 (AwFmIndexStruct.c:104-106)."""
    return 1 + (bwt_length - 1) // POSITIONS_PER_BLOCK


def search_range_length(start, end):
    """end - start + 1 if valid else 0 (AwFmIndexStruct.c:126-130)."""
    start = np.asarray(start)
    end = np.asarray(end)
    return np.where(start <= end, end - start + 1, 0)


def device_row_bytes(alphabet: AlphabetType) -> int:
    """Bytes per fused block row: planes*32 + milestones*4, padded to 128."""
    n_planes = alpha.num_bit_planes(alphabet)
    need = n_planes * 32 + (alpha.cardinality(alphabet) + 1) * 4
    return ((need + 127) // 128) * 128


def device_pair_row_bytes(alphabet: AlphabetType) -> int:
    """Bytes per pair row: planes*64 + milestones*4, padded to 128."""
    n_planes = alpha.num_bit_planes(alphabet)
    need = n_planes * 64 + (alpha.cardinality(alphabet) + 1) * 4
    return ((need + 127) // 128) * 128


def device_row_bytes64(alphabet: AlphabetType, pair: bool = True) -> int:
    """Bytes per wide row: planes*64 + milestones*8, padded to 128
    (256 B nucleotide, 512 B amino); ``pair=False``, the compact rows:
    planes*32 + milestones*8 (256 B nucleotide, 384 B amino)."""
    n_planes = alpha.num_bit_planes(alphabet)
    need = n_planes * (64 if pair else 32) + (alpha.cardinality(alphabet) + 1) * 8
    return ((need + 127) // 128) * 128


# ---------------------------------------------------------------------------
# u32 tables in int32 tensors
# ---------------------------------------------------------------------------

def as_device(device) -> torch.device:
    """``device`` as a torch.device, with a CUDA index filled in and a
    CPU index dropped (tensors on ``cpu:0`` report ``cpu``), so two
    spellings of one device compare equal."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", torch.cuda.current_device())
    elif d.type == "cpu":
        d = torch.device("cpu")
    return d


def resolve_device(device=None) -> torch.device:
    """The device an entry point with ``device=None`` runs on: the card.
    Without CUDA that raises, naming ``device=``; nothing runs on the CPU
    unless the caller asks for it."""
    d = torch.device("cuda" if device is None else device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False; pass device='cpu' explicitly "
            "to run the plain versions"
        )
    return as_device(d)


def u32_tensor(values, device) -> torch.Tensor:
    """An int32 tensor holding the bytes of ``values`` as uint32."""
    arr = np.ascontiguousarray(np.asarray(values).astype(np.uint32))
    return torch.from_numpy(arr.view(np.int32)).to(device)


def u32_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`u32_tensor`: a uint32 NumPy array of the bytes."""
    return t.detach().cpu().numpy().view(np.uint32)


def widen_u32(t: torch.Tensor) -> torch.Tensor:
    """int32-held u32 values (or any integers) -> int64 in [0, 2^32)."""
    return t.to(torch.int64) & MASK32


def narrow_u32(t: torch.Tensor) -> torch.Tensor:
    """int64 values taken mod 2^32 -> int32 holding the same u32 bytes."""
    t = t & MASK32
    return torch.where(t >= 2**31, t - 2**32, t).to(torch.int32)


def u64_tensor(values, device) -> torch.Tensor:
    """An int64 tensor holding the bytes of ``values`` as uint64."""
    arr = np.ascontiguousarray(np.asarray(values).astype(np.uint64))
    return torch.from_numpy(arr.view(np.int64)).to(device)


def u64_numpy(t: torch.Tensor) -> np.ndarray:
    """Inverse of :func:`u64_tensor`: a uint64 NumPy array of the bytes."""
    return t.detach().cpu().numpy().view(np.uint64)


# ---------------------------------------------------------------------------
# FASTA metadata (FastaVector equivalent)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FastaMetadata:
    """Multi-sequence metadata (the reference's FastaVector header and
    metadata vectors). ``header_ends`` and ``sequence_ends`` are
    cumulative exclusive end offsets per sequence."""

    headers: bytes
    header_ends: np.ndarray  # (num_seqs,) uint64
    sequence_ends: np.ndarray  # (num_seqs,) uint64

    @property
    def num_sequences(self) -> int:
        return len(self.sequence_ends)

    def get_header(self, sequence_number: int) -> bytes:
        if not 0 <= sequence_number < self.num_sequences:
            raise IndexError(
                f"sequence number {sequence_number} out of range "
                f"[0, {self.num_sequences})"
            )
        start = 0 if sequence_number == 0 else int(self.header_ends[sequence_number - 1])
        return self.headers[start:int(self.header_ends[sequence_number])]

    def local_position_from_global(self, global_position):
        """Global concatenated position -> (sequence_number, local_position)."""
        pos = np.asarray(global_position, dtype=np.uint64)
        seq_num = np.searchsorted(self.sequence_ends, pos, side="right")
        starts = np.concatenate([[0], self.sequence_ends[:-1]]).astype(np.uint64)
        local = pos - starts[seq_num]
        return seq_num, local


# ---------------------------------------------------------------------------
# Device view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceIndex:
    """Torch view of the index, ready for batched search.

    The tensor fields carry the JAX ``DeviceIndex``'s bytes exactly:
    ``packed``, ``packed_pair`` and ``code_masks`` are uint8;
    ``prefix_sums``, ``seed_table`` and ``sampled_sa`` are u32 values
    in int32 tensors; ``vec_to_index`` is int32.

    With ``wide`` set the fields carry the JAX ``DeviceIndex64``'s
    bytes: ``packed`` and ``packed_pair`` are the one table of wide rows
    (the same tensor), and ``prefix_sums``, ``seed_table`` and
    ``sampled_sa`` are u64 values in int64 tensors.

    A view without pair rows (module docstring) has ``packed_pair``
    None; a wide one, compact rows (``pair_fused=False``).

    A shard of the range-sharded engine (parallel/range_sharded.py) is a
    view too, marked ``shard``: ``packed`` and ``sampled_sa`` hold its
    block range and its sample range only, ``packed_pair`` is None, and a
    wide shard's rows are the compact ones (``pair_fused=False``). Only
    K1R and K1Rw take a shard; every other kernel takes whole views.
    """

    packed: torch.Tensor  # (num_blocks, row_bytes) uint8 fused blocks
    packed_pair: Optional[torch.Tensor]  # (num_blocks, pair_row_bytes) uint8; None: no pair rows
    prefix_sums: torch.Tensor  # (A+2,) u32 as int32 / u64 as int64
    seed_table: torch.Tensor  # (A**k, 2) u32 as int32 / u64 as int64
    sampled_sa: Optional[torch.Tensor]  # (num_samples,) u32 as int32 / u64 as int64; None = on disk
    code_masks: torch.Tensor  # (A+2, n_planes) uint8 0xFF/0x00
    vec_to_index: torch.Tensor  # (2**n_planes,) int32 code -> letter
    bwt_length: int
    ratio: int
    kmer_length_in_seed_table: int
    alphabet: AlphabetType
    wide: bool = False  # u64 positions over the wide row layout
    # wide rows pair-fused (plane stride 64); False: the compact rows
    # (stride 32) of a view without pair rows or of a shard
    pair_fused: bool = True
    shard: bool = False  # one shard of the range-sharded engine

    @property
    def pair_rows(self) -> bool:
        """Whether a step can read pair rows: a narrow view's pair table,
        or a wide view's pair-fused rows."""
        return self.pair_fused if self.wide else self.packed_pair is not None

    @property
    def device(self) -> torch.device:
        return self.packed.device

    @property
    def num_blocks(self) -> int:
        return int(self.packed.shape[0])

    @property
    def cardinality(self) -> int:
        return alpha.cardinality(self.alphabet)

    @property
    def sentinel(self) -> int:
        return alpha.sentinel_index(self.alphabet)

    @property
    def n_planes(self) -> int:
        return alpha.num_bit_planes(self.alphabet)

    @property
    def plane_stride(self) -> int:
        """Bytes from one plane to the next within a row of ``packed``."""
        return 64 if self.wide and self.pair_fused else 32

    @property
    def milestone_offset(self) -> int:
        """Byte offset of the milestone array within a row of ``packed``."""
        return self.n_planes * self.plane_stride

    @property
    def pair_milestone_offset(self) -> int:
        """Byte offset of the milestone array within a pair row."""
        return self.n_planes * 64

    @property
    def milestone_bytes(self) -> int:
        """Bytes per little-endian milestone: u32 narrow, u64 wide."""
        return 8 if self.wide else 4

    @property
    def pos_mask(self) -> int:
        """``x & pos_mask`` wraps an int64 tensor to the position width."""
        return MASK64 if self.wide else MASK32

    def widen(self, t: torch.Tensor) -> torch.Tensor:
        """Stored position values (int32-held u32, or int64) -> int64."""
        return t if self.wide else widen_u32(t)

    def store(self, t: torch.Tensor) -> torch.Tensor:
        """int64 position values -> the dtype the tables store them in."""
        return t if self.wide else narrow_u32(t)

    def numpy_u64(self, t: torch.Tensor) -> np.ndarray:
        """A stored position table as a uint64 host array."""
        return u64_numpy(t) if self.wide else u32_numpy(t).astype(np.uint64)


def pack_device_blocks(
    bwt_letters: np.ndarray, milestones: np.ndarray, alphabet: AlphabetType
) -> np.ndarray:
    """Fuse bit-planes + milestones into (num_blocks, row_bytes) uint8."""
    n_planes = alpha.num_bit_planes(alphabet)
    card = alpha.cardinality(alphabet)
    row_bytes = device_row_bytes(alphabet)
    bwt_length = len(bwt_letters)
    nb = num_blocks_from_bwt_length(bwt_length)

    codes = np.zeros(nb * POSITIONS_PER_BLOCK, dtype=np.uint8)
    codes[:bwt_length] = alpha.index_to_vector_lut(alphabet)[bwt_letters]

    out = np.zeros((nb, row_bytes), dtype=np.uint8)
    for b in range(n_planes):
        bits = ((codes >> b) & 1).reshape(nb, POSITIONS_PER_BLOCK)
        out[:, b * 32 : (b + 1) * 32] = np.packbits(
            bits, axis=1, bitorder="little"
        )
    ms = milestones[:, : card + 1].astype("<u4")
    out[:, n_planes * 32 : n_planes * 32 + (card + 1) * 4] = ms.view(
        np.uint8
    ).reshape(nb, (card + 1) * 4)
    return out


def pack_pair_rows_from_blocks(
    packed: np.ndarray, alphabet: AlphabetType
) -> np.ndarray:
    """Derive the pair-row table from the per-block fused rows.

    Pair row b = plane bytes of blocks b,b+1 per plane + block b's
    milestones; the final row's missing partner is zero planes.
    """
    n_planes = alpha.num_bit_planes(alphabet)
    card = alpha.cardinality(alphabet)
    nb = packed.shape[0]
    row_bytes = device_pair_row_bytes(alphabet)
    out = np.zeros((nb, row_bytes), dtype=np.uint8)
    for i in range(n_planes):
        plane = packed[:, i * 32 : (i + 1) * 32]
        out[:, i * 64 : i * 64 + 32] = plane
        out[:-1, i * 64 + 32 : (i + 1) * 64] = plane[1:]
    ms_off = n_planes * 32
    ms_len = (card + 1) * 4
    out[:, n_planes * 64 : n_planes * 64 + ms_len] = packed[
        :, ms_off : ms_off + ms_len
    ]
    return out


def pack_device_blocks64(
    bwt_letters: np.ndarray, milestones: np.ndarray, alphabet: AlphabetType,
    pair: bool = True,
) -> np.ndarray:
    """Bit-planes + u64 milestones -> (num_blocks, row_bytes64) uint8.

    With ``pair`` (the default), row b holds the plane bytes of blocks b
    and b+1 (64 B per plane) plus block b's milestones. The last row's
    missing partner keeps zero plane bytes: those pair-local positions
    lie beyond every valid rank position and the inclusive mask zeroes
    them. ``pair=False`` packs the compact single-block rows (plane
    stride 32, milestones at ``n_planes * 32``) that the range-sharded
    engine shards.
    """
    n_planes = alpha.num_bit_planes(alphabet)
    card = alpha.cardinality(alphabet)
    stride = 64 if pair else 32
    bwt_length = len(bwt_letters)
    nb = num_blocks_from_bwt_length(bwt_length)

    codes = np.zeros(nb * POSITIONS_PER_BLOCK, dtype=np.uint8)
    codes[:bwt_length] = alpha.index_to_vector_lut(alphabet)[bwt_letters]

    out = np.zeros((nb, device_row_bytes64(alphabet, pair)), dtype=np.uint8)
    for b in range(n_planes):
        bits = ((codes >> b) & 1).reshape(nb, POSITIONS_PER_BLOCK)
        plane = np.packbits(bits, axis=1, bitorder="little")
        out[:, b * stride : b * stride + 32] = plane
        if pair:
            out[:-1, b * 64 + 32 : (b + 1) * 64] = plane[1:]
    ms = milestones[:, : card + 1].astype("<u8")
    off = n_planes * stride
    out[:, off : off + (card + 1) * 8] = ms.view(np.uint8).reshape(nb, (card + 1) * 8)
    return out


def view_has_pair_rows(alphabet: AlphabetType, wide: bool, pair_rows: bool) -> bool:
    """Whether ``to_device(wide=wide, pair_rows=pair_rows)`` builds a view
    with pair rows: asked for, or a wide nucleotide view, whose pair-fused
    rows are as large as its compact ones (256 B)."""
    return bool(pair_rows) or (wide and alphabet != AlphabetType.AMINO)


def device_code_masks(alphabet: AlphabetType) -> np.ndarray:
    """(A+2, n_planes) uint8: 0xFF/0x00 mask per code bit per letter."""
    lut = alpha.index_to_vector_lut(alphabet)
    n_planes = alpha.num_bit_planes(alphabet)
    bits = (lut[:, None] >> np.arange(n_planes)[None, :]) & 1
    return (bits * np.uint8(0xFF)).astype(np.uint8)


KERNEL_TABLE_ENTRIES = 32  # 2^n_planes codes and card + 2 letters both fit


def kernel_letter_tables(alphabet: AlphabetType):
    """The two letter tables the CUDA kernels take by value, each (32,)
    uint8.

    ``letter_code[l]``: the plane code that letter ``l`` matches, i.e.
    row ``l`` of :func:`device_code_masks` folded to one bit per plane,
    for ``l`` up to the ambiguity letter; 0 above it (the sentinel and
    anything a query may carry beyond it match nothing, as the one-hot
    selects of the JAX package give). ``code_letter[c]``: the letter
    whose planes spell code ``c`` (``vector_to_index_lut``); 0 past
    ``2 ** n_planes``.
    """
    card = alpha.cardinality(alphabet)
    n_planes = alpha.num_bit_planes(alphabet)
    masks = device_code_masks(alphabet)
    folded = ((masks != 0).astype(np.uint32) << np.arange(n_planes)[None, :]).sum(axis=1)
    letter_code = np.zeros(KERNEL_TABLE_ENTRIES, dtype=np.uint8)
    letter_code[: card + 1] = folded[: card + 1]
    code_letter = np.zeros(KERNEL_TABLE_ENTRIES, dtype=np.uint8)
    code_letter[: 1 << n_planes] = alpha.vector_to_index_lut(alphabet)[: 1 << n_planes]
    return letter_code, code_letter


def kernel_block_constants(alphabet: AlphabetType, prefix_sums):
    """What the CUDA kernels make of those tables and C[], as NumPy
    arrays (the plain statement of ``letter_entry`` and ``stage_consts``
    in ``csrc/awfm_kernels.cu``): for a backward step by letter ``l``, at
    ``min(l, 31)``: ``c`` (C[l]; 0 above the sentinel), ``code`` and
    ``has_milestone``; for an LF step from a position whose planes spell
    code ``c`` (one entry of a block's shared memory): ``letter``,
    ``column = min(letter, ambiguity letter)``, ``c_of_code = C[column]``,
    ``match_code = letter_code[column]`` and ``is_sentinel``.
    ``prefix_sums``: the (card + 2,) C[] array."""
    card = alpha.cardinality(alphabet)
    letter_code, code_letter = kernel_letter_tables(alphabet)
    ps = np.asarray(prefix_sums).astype(np.uint64)
    c = np.zeros(KERNEL_TABLE_ENTRIES, dtype=np.uint64)
    c[: card + 2] = ps[: card + 2]
    column = np.minimum(code_letter, card)
    return {
        "c": c,
        "code": letter_code,
        "has_milestone": np.arange(KERNEL_TABLE_ENTRIES) <= card,
        "letter": code_letter,
        "column": column,
        "c_of_code": ps[column],
        "match_code": letter_code[column],
        "is_sentinel": code_letter == card + 1,
    }


# ---------------------------------------------------------------------------
# Host-side canonical index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FmIndex:
    """Host-canonical FM index (struct AwFmIndex, AwFmIndex.h:94-109).

    Holds NumPy arrays; :meth:`to_device` builds the torch view.
    """

    config: IndexConfiguration
    bwt_length: int
    bwt_letters: np.ndarray  # (bwt_length,) uint8 letter indices
    prefix_sums: np.ndarray  # (A+2,) uint64
    # (A**k, 2) uint64 [start, end]; None while the table lives only in
    # the device view (built there) — use seed_table_host()
    kmer_seed_table: Optional[np.ndarray]
    sampled_sa: Optional[np.ndarray]  # (num_samples,) uint64; None if on disk
    version_number: int = CURRENT_VERSION_NUMBER
    feature_flags: int = 0
    sequence: Optional[bytes] = None  # original (unsanitized) sequence
    fasta_metadata: Optional[FastaMetadata] = None
    file_path: Optional[str] = None  # backing .awfmi file, if any
    # the 8 pad bytes after the packed SA (full-SA leftovers in the
    # reference's in-place packer), kept for byte-identical .awfmi files
    sa_guard_bytes: bytes = b"\x00" * 8
    suffix_array_file_offset: Optional[int] = None
    sequence_file_offset: Optional[int] = None
    # Denser DEVICE-side suffix-array samples, cut at device_sa_ratio <
    # saCompressionRatio when requested at build
    # (create_index(device_sa_ratio=...)). Not serialized: the .awfmi
    # file keeps the config ratio and stays byte-identical.
    device_sa: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    device_sa_ratio: Optional[int] = None
    _device_cache: Optional[DeviceIndex] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    @property
    def alphabet(self) -> AlphabetType:
        return self.config.alphabet_type

    @property
    def cardinality(self) -> int:
        return alpha.cardinality(self.alphabet)

    @property
    def sentinel_index(self) -> int:
        return alpha.sentinel_index(self.alphabet)

    @property
    def num_blocks(self) -> int:
        return num_blocks_from_bwt_length(self.bwt_length)

    @property
    def contains_fasta_vector(self) -> bool:
        """featureFlags bit 0 (AwFmIndexStruct.c:136-139)."""
        return bool(self.feature_flags & (1 << FEATURE_FLAG_BIT_FASTA_VECTOR))

    def num_sequences(self) -> int:
        if self.fasta_metadata is not None:
            return self.fasta_metadata.num_sequences
        return 1

    def seed_table_host(self) -> np.ndarray:
        """The (A**k, 2) uint64 seed table, copied from the device view
        when it was built there."""
        if self.kmer_seed_table is None:
            k = int(self.config.kmer_length_in_seed_table)
            dev = self._device_cache
            if dev is None or dev.seed_table.shape[0] != self.cardinality**k:
                raise ValueError("index has no seed table (not yet built)")
            self.kmer_seed_table = dev.numpy_u64(dev.seed_table)
        return self.kmer_seed_table

    def seed_table_tensor(self, device, wide: bool) -> Optional[torch.Tensor]:
        """The seed table on ``device`` in a view's storage (u32 in int32,
        or u64 in int64 when ``wide``): from the host table, else from the
        cached device view without a round trip through the host; None
        while the index has none."""
        k = int(self.config.kmer_length_in_seed_table)
        if self.kmer_seed_table is not None:
            return (u64_tensor if wide else u32_tensor)(self.kmer_seed_table, device)
        cache = self._device_cache
        if cache is None or cache.seed_table.shape[0] != self.cardinality**k:
            return None
        # a table built on the device: values < 2^32 whenever the widths
        # differ, so widening adds zero high words and narrowing drops them
        seed = cache.seed_table.to(device)
        if cache.wide != wide:
            seed = widen_u32(seed) if wide else narrow_u32(seed)
        return seed

    def letters_as_blocks(self) -> np.ndarray:
        """(num_blocks, 256) uint8, tail padded with the sentinel index."""
        n_blocks = self.num_blocks
        padded = np.full(n_blocks * POSITIONS_PER_BLOCK, self.sentinel_index, np.uint8)
        padded[: self.bwt_length] = self.bwt_letters
        return padded.reshape(n_blocks, POSITIONS_PER_BLOCK)

    def milestones(self) -> np.ndarray:
        """(num_blocks, A+2) uint64 occurrence counts at block starts.

        Column j = count of letter j in bwt_letters[: 256*block]
        (baseOccurrences, AwFmCreate.c:309, 366).
        """
        n_letters = self.cardinality + 2
        blocks_mat = self.letters_as_blocks()
        if self.bwt_length % POSITIONS_PER_BLOCK:
            # mask the sentinel-padded tail out of the counts
            blocks_mat = blocks_mat.copy()
            blocks_mat.reshape(-1)[self.bwt_length :] = 255
        counts = np.empty((self.num_blocks, n_letters), dtype=np.uint64)
        for lett in range(n_letters):
            counts[:, lett] = (blocks_mat == lett).sum(axis=1)
        cum = np.cumsum(counts, axis=0)
        milestones = np.zeros_like(cum)
        milestones[1:] = cum[:-1]
        return milestones

    def to_device(self, device, wide: Optional[bool] = None,
                  pair_rows: Optional[bool] = None) -> DeviceIndex:
        """Build (or return the cached) torch view on ``device``.

        ``wide`` selects the 64-bit layout (u64 milestones, int64
        tables; see the module docstring). By default it is chosen for
        bwtLength >= 2^32; ``wide=True`` forces it on a smaller index,
        with the same answers. ``pair_rows=False`` builds the view
        without pair rows (module docstring): no narrow pair table, the
        compact amino wide rows; the answers stay the same. ``None`` (the
        default) keeps the layout of the view installed on ``device``,
        and means pair rows where there is none, so that a caller that
        does not name the layout never swaps one view for the other. A
        cached view is returned only when it lies on ``device`` and has
        the width and the layout asked for; otherwise the view is rebuilt,
        and a seed table that lives only in the cached view is carried
        over (the same tensor at the same width; widened or narrowed
        otherwise).

        Until the builder attaches the seed table, the view carries a
        (1, 2) zeros placeholder. A dense device SA cut at build
        (``device_sa``) is preferred over the sampled SA: backtrace
        chains shorten, answers stay the same.
        """
        device = as_device(device)
        cache = self._device_cache
        if pair_rows is None:
            pair_rows = cache.pair_rows if cache is not None and cache.device == device else True
        if wide is None:
            wide = self.bwt_length >= 2**32
        pair = view_has_pair_rows(self.alphabet, wide, pair_rows)
        if (cache is not None and cache.device == device and cache.wide == wide
                and cache.pair_rows == pair):
            return cache
        if wide:
            # the limits of the JAX package's wide view, so that both
            # packages accept the same indexes
            if self.num_blocks >= 2**31:
                raise ValueError(
                    "device block index must fit int32: bwtLength must "
                    "be < 2^39 positions (~550 G bases)"
                )
            if self.bwt_length // int(self.config.suffix_array_compression_ratio) >= 2**31:
                raise ValueError(
                    "sampled-SA gather index must fit int32: need "
                    "bwtLength / saCompressionRatio < 2^31"
                )
        elif self.bwt_length >= 2**32:
            raise ValueError(
                "bwtLength >= 2**32 requires the 64-bit device layout "
                "(to_device(device, wide=True), chosen automatically)"
            )
        as_table = u64_tensor if wide else u32_tensor
        if wide:
            rows = pack_device_blocks64(self.bwt_letters, self.milestones(), self.alphabet,
                                        pair=pair)
            packed = torch.from_numpy(rows).to(device)
            pair_table = packed if pair else None
        else:
            rows = pack_device_blocks(self.bwt_letters, self.milestones(), self.alphabet)
            packed = torch.from_numpy(rows).to(device)
            pair_table = None
            if pair:
                pair_table = torch.from_numpy(
                    pack_pair_rows_from_blocks(rows, self.alphabet)).to(device)
        k = int(self.config.kmer_length_in_seed_table)
        seed = self.seed_table_tensor(device, wide)
        if seed is None:
            seed = torch.zeros(
                (1, 2), dtype=torch.int64 if wide else torch.int32, device=device
            )
        dev_sa = self.sampled_sa
        dev_ratio = int(self.config.suffix_array_compression_ratio)
        if self.device_sa is not None:
            dev_sa = self.device_sa
            dev_ratio = int(self.device_sa_ratio)
        dev = DeviceIndex(
            packed=packed,
            packed_pair=pair_table,
            prefix_sums=as_table(self.prefix_sums, device),
            seed_table=seed,
            sampled_sa=None if dev_sa is None else as_table(dev_sa, device),
            code_masks=torch.from_numpy(device_code_masks(self.alphabet)).to(device),
            vec_to_index=torch.from_numpy(
                alpha.vector_to_index_lut(self.alphabet).astype(np.int32)
            ).to(device),
            bwt_length=int(self.bwt_length),
            ratio=dev_ratio,
            kmer_length_in_seed_table=k,
            alphabet=self.alphabet,
            wide=wide,
            pair_fused=not wide or pair,
        )
        self._device_cache = dev
        return dev

    def densify_device_sa(
        self, ratio: int, chunk: int = 1 << 22, *, device, wide: Optional[bool] = None,
    ) -> DeviceIndex:
        """Rebuild a DENSER device-side suffix array from the loaded one.

        ``create_index(device_sa_ratio=r)`` can cut a denser SA only at
        build time, when the full SA exists. The device can recover the
        density by itself: every BWT position's SA value is reachable from
        the stored samples by the LF backtrace, so this resolves the
        targets ``i * ratio`` (clamped to bwtLength - 1), chunk by chunk,
        through ``search.backtrace_resolve`` (K3 or K3w on the card) and
        installs the result as the device SA. Values equal a build-time
        dense SA.

        The new samples live on the device only; the ``.awfmi`` file and
        the host model keep the config ratio. Returns the new DeviceIndex,
        also installed as this index's device view, so later
        ``to_device``/engine constructions see it. Needs the sampled SA
        in memory. ``wide`` defaults to the width ``to_device`` picks, or
        wide when a wide view is already installed on ``device``; the
        layout is the installed view's (``to_device``'s default), so the
        dense view keeps it.
        """
        from ..search import backtrace_resolve

        if ratio < 1:
            raise ValueError("ratio must be >= 1")
        cache = self._device_cache
        here = cache is not None and cache.device == as_device(device)
        if wide is None:
            wide = self.bwt_length >= 2**32 or (here and cache.wide)
        dev = self.to_device(device, wide=wide)
        if dev.sampled_sa is None:
            raise ValueError(
                "densify_device_sa needs the sampled suffix array on the "
                "device (load with keep_suffix_array_in_memory=True)"
            )
        if ratio == dev.ratio:
            return dev
        new_len = (self.bwt_length + ratio - 1) // ratio
        if wide and new_len >= 2**31:
            raise ValueError(
                "dense device SA gather index must fit int32: need "
                "bwtLength / ratio < 2^31"
            )
        out = torch.empty(new_len, dtype=dev.sampled_sa.dtype, device=dev.device)
        for lo in range(0, new_len, chunk):
            hi = min(lo + chunk, new_len)
            targets = (torch.arange(lo, hi, dtype=torch.int64, device=dev.device) * ratio).clamp(
                max=self.bwt_length - 1
            )
            out[lo:hi] = dev.store(backtrace_resolve(dev, targets))
        dense = dataclasses.replace(dev, sampled_sa=out, ratio=int(ratio))
        self.device_sa_ratio = int(ratio)
        self._device_cache = dense
        return dense

    def get_local_sequence_position(self, global_position):
        """awFmGetLocalSequencePositionFromIndexPosition (AwFmSearch.c:284-301)."""
        if self.fasta_metadata is None:
            raise ValueError("index was not built from a FASTA (no metadata)")
        return self.fasta_metadata.local_position_from_global(global_position)

    def get_header(self, sequence_number: int) -> bytes:
        """awFmGetHeaderStringFromSequenceNumber (AwFmSearch.c:303-315)."""
        if self.fasta_metadata is None:
            raise ValueError("index was not built from a FASTA (no metadata)")
        return self.fasta_metadata.get_header(sequence_number)

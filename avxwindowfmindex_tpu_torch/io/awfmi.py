"""Byte-compatible `.awfmi` v8 serialization (AwFmFile.c parity).

File layout, strictly ordered (AwFmFile.c:20-193):
  - 10-byte magic "AwFmIndex\\n"
  - u32 versionNumber, u32 featureFlags
  - u8 saCompressionRatio, u8 kmerLengthInSeedTable, u8 alphabetType,
    u8 storeOriginalSequence
  - u64 bwtLength
  - BWT blocks: per block, the strided bit-plane vectors (3x32 B
    nucleotide / 5x32 B amino) followed by the milestone counts
    (8 / 24 x u64, trailing entries zero) — AwFmIndex.h:55-65
  - prefixSums: (|A|+2) x u64
  - kmer seed table: |A|^k x {u64 startPtr, u64 endPtr}
  - optional original sequence ((bwtLength-1) bytes)
  - bit-packed sampled suffix array (incl. 8 guard bytes)
  - optional FastaVector section: u64 headerLength, u64 metadataLength,
    header chars, metadata x {u64 headerEndPosition, u64
    sequenceEndPosition} (AwFmFile.c:157-187)

All integers little-endian (the reference fwrites x86 host structs).

Byte-compatibility status: PROVEN against the reference binary.
tests/test_golden_reference.py compiles the actual reference sources
(via the shims in native/golden/) and byte-compares whole files —
identical for nucleotide + amino, raw + FASTA, multiple ratios/k,
including the packed-SA trailing pad bytes (which the reference's
in-place packer fills with full-SA leftovers; see
FmIndex.sa_guard_bytes). One remaining caveat: the FastaVector
submodule is absent from the reference snapshot, so that section's
internal conventions (headers stored without '>' or terminators,
cumulative u64 end offsets) are reconstructed from the reference's
usage (AwFmFile.c:360-440, AwFmSearch.c:303-315) and shared by writer
and shim rather than cross-checked against the upstream library.

Copied from avxwindowfmindex_tpu/io/awfmi.py; the files it writes are
byte-identical to the JAX package's (tests/test_torch_slice.py).
"""

from __future__ import annotations

import os
import numpy as np

from .. import suffix_array as sa_mod
from ..models import alphabet as alpha
from ..models.config import AlphabetType, IndexConfiguration
from ..models.index import (
    FastaMetadata,
    FmIndex,
    num_blocks_from_bwt_length,
)

MAGIC = b"AwFmIndex\n"  # AwFmFile.c:17-18 (10 bytes written)
HEADER_LEN = len(MAGIC)
CONFIG_LEN = 12  # AwFmFile.c:526


def _block_geometry(alphabet: AlphabetType):
    n_planes = alpha.num_bit_planes(alphabet)
    n_milestones = 24 if alphabet == AlphabetType.AMINO else 8
    block_bytes = n_planes * 32 + n_milestones * 8
    return n_planes, n_milestones, block_bytes


def pack_blocks(index: FmIndex) -> np.ndarray:
    """Letters + milestones -> the reference's block byte layout."""
    n_planes, n_milestones, block_bytes = _block_geometry(index.alphabet)
    nb = index.num_blocks
    codes_lut = alpha.index_to_vector_lut(index.alphabet)
    codes = np.zeros(nb * 256, dtype=np.uint8)
    codes[: index.bwt_length] = codes_lut[index.bwt_letters]

    planes = np.empty((nb, n_planes, 32), dtype=np.uint8)
    for b in range(n_planes):
        bits = ((codes >> b) & 1).reshape(nb, 256)
        planes[:, b, :] = np.packbits(bits, axis=1, bitorder="little")

    milestones = np.zeros((nb, n_milestones), dtype="<u8")
    ms = index.milestones()  # (nb, A+2)
    milestones[:, : ms.shape[1]] = ms

    out = np.empty((nb, block_bytes), dtype=np.uint8)
    out[:, : n_planes * 32] = planes.reshape(nb, n_planes * 32)
    out[:, n_planes * 32 :] = milestones.view(np.uint8).reshape(nb, n_milestones * 8)
    return out.reshape(-1)


def unpack_blocks(data: np.ndarray, bwt_length: int, alphabet: AlphabetType):
    """Block bytes -> (bwt_letters, milestones) host arrays."""
    n_planes, n_milestones, block_bytes = _block_geometry(alphabet)
    nb = num_blocks_from_bwt_length(bwt_length)
    blocks = np.asarray(data, dtype=np.uint8).reshape(nb, block_bytes)
    plane_bytes = blocks[:, : n_planes * 32].reshape(nb, n_planes, 32)
    bits = np.unpackbits(plane_bytes, axis=2, bitorder="little")  # (nb, P, 256)
    codes = np.zeros((nb, 256), dtype=np.uint8)
    for b in range(n_planes):
        codes |= bits[:, b, :] << b
    letters = alpha.vector_to_index_lut(alphabet)[codes].reshape(-1)[:bwt_length]
    milestones = (
        blocks[:, n_planes * 32 :]
        .copy()
        .view("<u8")
        .reshape(nb, n_milestones)
    )
    return letters.astype(np.uint8), milestones


def sequence_file_offset(index: FmIndex) -> int:
    """awFmGetSequenceFileOffset (AwFmFile.c:524-541)."""
    _, _, block_bytes = _block_geometry(index.alphabet)
    a = index.cardinality
    k = index.config.kmer_length_in_seed_table
    return (
        HEADER_LEN
        + CONFIG_LEN
        + 8
        + index.num_blocks * block_bytes
        + (a + 2) * 8
        + (a**k) * 16
    )


def suffix_array_file_offset(index: FmIndex) -> int:
    """awFmGetSuffixArrayFileOffset (AwFmFile.c:543-551)."""
    off = sequence_file_offset(index)
    if index.config.store_original_sequence:
        off += index.bwt_length - 1
    return off


def write_index(index: FmIndex, path: str) -> None:
    """awFmWriteIndexToFile parity (AwFmFile.c:20-193)."""
    cfg = index.config
    if cfg.store_original_sequence and index.sequence is None:
        raise ValueError("store_original_sequence=True but index.sequence is None")
    if index.sampled_sa is None:
        raise ValueError("cannot serialize: sampled suffix array not in memory")

    packed_sa, _width = _pack_sampled(index)

    with open(path, "wb") as fh:
        fh.write(MAGIC)
        fh.write(np.uint32(index.version_number).tobytes())
        fh.write(np.uint32(index.feature_flags).tobytes())
        fh.write(
            bytes(
                [
                    cfg.suffix_array_compression_ratio,
                    cfg.kmer_length_in_seed_table,
                    int(cfg.alphabet_type),
                    1 if cfg.store_original_sequence else 0,
                ]
            )
        )
        fh.write(np.uint64(index.bwt_length).tobytes())
        fh.write(pack_blocks(index).tobytes())
        fh.write(index.prefix_sums.astype("<u8").tobytes())
        fh.write(index.seed_table_host().astype("<u8").tobytes())
        if cfg.store_original_sequence:
            seq = index.sequence
            if len(seq) != index.bwt_length - 1:
                raise ValueError("sequence length inconsistent with bwtLength")
            fh.write(seq)
        fh.write(packed_sa.tobytes())
        if index.contains_fasta_vector:
            md = index.fasta_metadata
            fh.write(np.uint64(len(md.headers)).tobytes())
            fh.write(np.uint64(md.num_sequences).tobytes())
            fh.write(md.headers)
            meta = np.empty((md.num_sequences, 2), dtype="<u8")
            meta[:, 0] = md.header_ends
            meta[:, 1] = md.sequence_ends
            fh.write(meta.tobytes())

    index.file_path = path
    index.sequence_file_offset = sequence_file_offset(index)
    index.suffix_array_file_offset = suffix_array_file_offset(index)


def _pack_sampled(index: FmIndex):
    """Bit-pack the in-memory sampled SA (AwFmSuffixArray.c:58-112).

    The 8 pad bytes after the packed bits carry the reference's
    in-place-packing leftovers (full-SA image bytes); ``sa_guard_bytes``
    reproduces them for byte-identical files (zeros when unknown, e.g.
    an index assembled without the full SA)."""
    width = sa_mod.value_min_bit_width(index.bwt_length)
    packed = sa_mod.pack_values(index.sampled_sa, width)
    total = sa_mod.compressed_sa_size_in_bytes(
        index.bwt_length, index.config.suffix_array_compression_ratio
    )
    out = np.zeros(total, dtype=np.uint8)
    out[: len(packed)] = packed
    guard = np.frombuffer(index.sa_guard_bytes, dtype=np.uint8)
    out[len(packed) : len(packed) + len(guard)] = guard[: total - len(packed)]
    return out, width


def read_index(path: str, keep_suffix_array_in_memory: bool = True) -> FmIndex:
    """awFmReadIndexFromFile parity (AwFmFile.c:195-449)."""
    with open(path, "rb") as fh:
        magic = fh.read(HEADER_LEN)
        if magic != MAGIC:
            raise ValueError(f"{path}: not an AwFmIndex file (bad magic)")
        version = int(np.frombuffer(fh.read(4), "<u4")[0])
        # the reference validates the on-disk u32 version through a
        # uint16_t parameter (awFmIndexIsVersionValid,
        # AwFmIndexStruct.c:132-134), so files with version 8 + k*65536
        # load there — accept exactly what it accepts
        if version & 0xFFFF != 8:
            raise ValueError(f"{path}: unsupported index version {version}")
        feature_flags = int(np.frombuffer(fh.read(4), "<u4")[0])
        ratio, k, alphabet_val, store_seq = fh.read(4)
        alphabet = AlphabetType(alphabet_val)
        bwt_length = int(np.frombuffer(fh.read(8), "<u8")[0])

        cfg = IndexConfiguration(
            suffix_array_compression_ratio=ratio,
            kmer_length_in_seed_table=k,
            alphabet_type=alphabet,
            keep_suffix_array_in_memory=keep_suffix_array_in_memory,
            store_original_sequence=bool(store_seq),
        )

        _, _, block_bytes = _block_geometry(alphabet)
        nb = num_blocks_from_bwt_length(bwt_length)
        block_data = np.frombuffer(fh.read(nb * block_bytes), dtype=np.uint8)
        letters, _milestones = unpack_blocks(block_data, bwt_length, alphabet)

        a = alpha.cardinality(alphabet)
        prefix_sums = np.frombuffer(fh.read((a + 2) * 8), "<u8").copy()
        seed_table = (
            np.frombuffer(fh.read((a**k) * 16), "<u8").reshape(-1, 2).copy()
        )

        sequence = None
        if cfg.store_original_sequence:
            sequence = fh.read(bwt_length - 1)

        sa_bytes_len = sa_mod.compressed_sa_size_in_bytes(bwt_length, ratio)
        sampled = None
        guard = b"\x00" * 8
        if keep_suffix_array_in_memory:
            packed = np.frombuffer(fh.read(sa_bytes_len), dtype=np.uint8)
            guard = packed[sa_bytes_len - 8 :].tobytes()
            width = sa_mod.value_min_bit_width(bwt_length)
            n_samples = (bwt_length + ratio - 1) // ratio
            sampled = sa_mod.unpack_values(packed, width, n_samples)
        else:
            fh.seek(sa_bytes_len - 8, os.SEEK_CUR)
            guard = fh.read(8)

        metadata = None
        if feature_flags & 1:
            header_len = int(np.frombuffer(fh.read(8), "<u8")[0])
            meta_len = int(np.frombuffer(fh.read(8), "<u8")[0])
            headers = fh.read(header_len)
            meta = np.frombuffer(fh.read(meta_len * 16), "<u8").reshape(-1, 2)
            metadata = FastaMetadata(
                headers=headers,
                header_ends=meta[:, 0].copy(),
                sequence_ends=meta[:, 1].copy(),
            )

    index = FmIndex(
        config=cfg,
        bwt_length=bwt_length,
        bwt_letters=letters,
        prefix_sums=prefix_sums,
        kmer_seed_table=seed_table,
        sampled_sa=sampled,
        version_number=version,
        feature_flags=feature_flags,
        sequence=sequence,
        fasta_metadata=metadata,
        file_path=path,
        sa_guard_bytes=guard,
    )
    index.sequence_file_offset = sequence_file_offset(index)
    index.suffix_array_file_offset = suffix_array_file_offset(index)
    return index


# ---------------------------------------------------------------------------
# Partial-residency file reads (pread parity)
# ---------------------------------------------------------------------------

def read_sequence_from_file(index: FmIndex, start: int, length: int) -> bytes:
    """awFmReadSequenceFromFile (AwFmFile.c:451-482)."""
    if not index.config.store_original_sequence:
        raise ValueError("index was built without the original sequence stored")
    if index.file_path is None:
        raise ValueError("index has no backing file")
    if start < 0 or length < 0 or start + length > index.bwt_length:
        # negative start would seek into the preceding file sections and
        # return seed-table bytes as sequence; the reference's size_t
        # start makes the same inputs fail its bounds check
        # (AwFmFile.c:457-462)
        raise IndexError("illegal sequence position")
    offset = index.sequence_file_offset or sequence_file_offset(index)
    with open(index.file_path, "rb") as fh:
        fh.seek(offset + start)
        data = fh.read(length)
    if len(data) != length:
        raise IOError("short read from sequence region")
    return data


def get_suffix_array_value_from_file(index: FmIndex, position_in_array: int) -> int:
    """awFmGetSuffixArrayValueFromFile (AwFmFile.c:484-522)."""
    if index.file_path is None:
        raise ValueError("index has no backing file")
    width = sa_mod.value_min_bit_width(index.bwt_length)
    offset = index.suffix_array_file_offset or suffix_array_file_offset(index)
    with open(index.file_path, "rb") as fh:
        return sa_mod.read_packed_value_from_file(fh, offset, width, position_in_array)

"""Index configuration, alphabet enum, and return codes.

Mirrors the reference's AwFmIndexConfiguration / AwFmAlphabetType /
AwFmReturnCode (src/AwFmIndex.h:29-33, 74-80, 132-138) with the same
on-disk numeric values so `.awfmi` serde is byte-compatible.

Copied unchanged from avxwindowfmindex_tpu/models/config.py: the port
cannot import the JAX package (its __init__ imports jax).
"""

from __future__ import annotations

import dataclasses
import enum


class AlphabetType(enum.IntEnum):
    """Alphabet selector; values match the reference (AwFmIndex.h:29-33)."""

    AMINO = 1
    DNA = 2
    RNA = 3


class ReturnCode(enum.IntEnum):
    """Status codes matching the reference's enum (AwFmIndex.h:132-138).

    The TPU framework raises exceptions for hard failures, but these codes
    are kept for API parity and for callers porting from the C library.
    """

    SUCCESS = 1
    FILE_READ_OKAY = 2
    FILE_WRITE_OKAY = 3
    GENERAL_FAILURE = -1
    UNSUPPORTED_VERSION_ERROR = -2
    ALLOCATION_FAILURE = -3
    NULL_PTR_ERROR = -4
    SUFFIX_ARRAY_CREATION_FAILURE = -5
    ILLEGAL_POSITION_ERROR = -6
    NO_FILE_SRC_GIVEN = -7
    NO_DATABASE_SEQUENCE_GIVEN = -8
    FILE_FORMAT_ERROR = -9
    FILE_OPEN_FAIL = -10
    FILE_READ_FAIL = -11
    FILE_WRITE_FAIL = -12
    ERROR_DB_SEQUENCE_NULL = -13
    ERROR_SUFFIX_ARRAY_NULL = -14
    FILE_ALREADY_EXISTS = -15

    @property
    def is_failure(self) -> bool:
        return self.value < 0

    @property
    def is_success(self) -> bool:
        return self.value >= 0


CURRENT_VERSION_NUMBER = 8  # AwFmIndexStruct.h:9
FEATURE_FLAG_BIT_FASTA_VECTOR = 0  # AwFmIndexStruct.h:10


@dataclasses.dataclass
class IndexConfiguration:
    """User-facing build configuration (AwFmIndex.h:74-80).

    Attributes:
      suffix_array_compression_ratio: sample every Nth BWT position into the
        compressed suffix array (recommended 8, README.md:188-194).
      kmer_length_in_seed_table: memoize the BWT range of every possible
        k-length suffix (recommended 12 nt / 5 aa, README.md:196-202).
      alphabet_type: nucleotide (DNA/RNA) or amino.
      keep_suffix_array_in_memory: if False, `locate` resolves suffix-array
        samples by reading the index file per query.
      store_original_sequence: whether the original sequence is serialized
        into the index file (enables read_sequence_from_file).
    """

    suffix_array_compression_ratio: int = 8
    kmer_length_in_seed_table: int = 12
    alphabet_type: AlphabetType = AlphabetType.DNA
    keep_suffix_array_in_memory: bool = True
    store_original_sequence: bool = True

    def __post_init__(self):
        self.alphabet_type = AlphabetType(self.alphabet_type)
        if not (1 <= self.suffix_array_compression_ratio <= 255):
            raise ValueError("suffix_array_compression_ratio must be in [1, 255]")
        if not (1 <= self.kmer_length_in_seed_table <= 255):
            raise ValueError("kmer_length_in_seed_table must be in [1, 255]")

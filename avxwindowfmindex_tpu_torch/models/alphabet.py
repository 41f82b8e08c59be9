"""Letter codecs for nucleotide and amino-acid alphabets.

Reproduces the exact three-representation scheme of the reference
(src/AwFmLetter.c): ASCII byte <-> letter index (sort order) <->
compressed bit-vector code (the strided bit-plane storage format).

All maps are exposed as 256-entry (or small) NumPy lookup tables so both
host-side builders (vectorized numpy) and device-side code (jnp constant
arrays) can use them.

Reference semantics reproduced here:
  - nucleotide ascii->index: a/c/g/t(u)->0..3, '$'->5, everything else->4,
    case-insensitive via `| 0x20` (AwFmLetter.c:4-22)
  - nucleotide sanitize: keeps lowercase acgtu and '$', everything else->'x'
    (AwFmLetter.c:24-42); note the output is always lowercase.
  - nucleotide index->vector {6,5,3,1,2,4} and inverse (AwFmLetter.c:44-53)
  - amino ascii->index: 32-entry table keyed on ascii&0x1F, '$'->21
    (AwFmLetter.c:55-67)
  - amino sanitize: b/x (any case) and NUL -> 'z', all else passes through
    unchanged (AwFmLetter.c:69-79)
  - amino index->vector 22-entry table and 32-entry inverse
    (AwFmLetter.c:81-96)
  - ambiguity predicate (AwFmLetter.c:98-125)

Copied unchanged from avxwindowfmindex_tpu/models/alphabet.py: the port
cannot import the JAX package (its __init__ imports jax).
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Cardinalities / special letter indices
# ---------------------------------------------------------------------------

NUCLEOTIDE_CARDINALITY = 4
AMINO_CARDINALITY = 20

NUCLEOTIDE_AMBIGUITY_INDEX = 4  # 'x'
NUCLEOTIDE_SENTINEL_INDEX = 5  # '$'
AMINO_AMBIGUITY_INDEX = 20  # 'z'
AMINO_SENTINEL_INDEX = 21  # '$'

NUCLEOTIDE_VECTORS_PER_BLOCK = 3
AMINO_VECTORS_PER_BLOCK = 5

POSITIONS_PER_BLOCK = 256  # AwFmIndex.h:20


def _build_nucleotide_ascii_to_index() -> np.ndarray:
    # built from the reference's exact rule — switch on (byte | 0x20)
    # (AwFmLetter.c:5-21). Note this maps byte 0x04 to the sentinel too,
    # since 0x04 | 0x20 == 0x24 == '$'.
    mapping = {"a": 0, "c": 1, "g": 2, "t": 3, "u": 3,
               "$": NUCLEOTIDE_SENTINEL_INDEX}
    lut = np.empty(256, dtype=np.uint8)
    for b in range(256):
        lut[b] = mapping.get(chr(b | 0x20), NUCLEOTIDE_AMBIGUITY_INDEX)
    return lut


def _build_nucleotide_sanitize() -> np.ndarray:
    # switch on (byte | 0x20), emitting the lowercase form
    # (AwFmLetter.c:24-42); everything else -> 'x'
    lut = np.empty(256, dtype=np.uint8)
    for b in range(256):
        low = chr(b | 0x20)
        lut[b] = ord(low) if low in "acgtu$" else ord("x")
    return lut


# Amino: 32-entry table keyed on ascii & 0x1F (AwFmLetter.c:59-61)
_AMINO_ENCODINGS_32 = np.array(
    [20, 0, 20, 1, 2, 3, 4, 5, 6, 7, 20, 8, 9, 10, 11, 20,
     12, 13, 14, 15, 16, 20, 17, 18, 20, 19, 20, 20, 20, 20, 20, 20],
    dtype=np.uint8,
)


def _build_amino_ascii_to_index() -> np.ndarray:
    lut = _AMINO_ENCODINGS_32[np.arange(256) & 0x1F].copy()
    lut[ord("$")] = AMINO_SENTINEL_INDEX
    return lut


def _build_amino_sanitize() -> np.ndarray:
    lut = np.arange(256, dtype=np.uint8)
    for ch in "bBxX":
        lut[ord(ch)] = ord("z")
    lut[0] = ord("z")
    return lut


NT_ASCII_TO_INDEX = _build_nucleotide_ascii_to_index()
NT_SANITIZE = _build_nucleotide_sanitize()
AA_ASCII_TO_INDEX = _build_amino_ascii_to_index()
AA_SANITIZE = _build_amino_sanitize()

# letter index -> compressed bit-vector code (AwFmLetter.c:44-47, 81-87)
NT_INDEX_TO_VECTOR = np.array([6, 5, 3, 1, 2, 4], dtype=np.uint8)
NT_VECTOR_TO_INDEX = np.array([5, 3, 4, 2, 5, 1, 0, 5], dtype=np.uint8)
# (index 7 is unused by the reference's 7-entry table; padded with sentinel)

AA_INDEX_TO_VECTOR = np.array(
    [0x0C, 0x17, 0x03, 0x06, 0x1E, 0x1A, 0x1B, 0x19, 0x15, 0x1C, 0x1D,
     0x08, 0x09, 0x04, 0x13, 0x0A, 0x05, 0x16, 0x01, 0x02, 0x1F, 0x00],
    dtype=np.uint8,
)
AA_VECTOR_TO_INDEX = np.array(
    [21, 18, 19, 2, 13, 16, 3, 20, 11, 12, 15, 20, 0, 20, 20, 20,
     20, 20, 20, 14, 20, 8, 17, 1, 20, 7, 5, 6, 9, 10, 4, 20],
    dtype=np.uint8,
)


# ---------------------------------------------------------------------------
# Scalar / vectorized codec functions
# ---------------------------------------------------------------------------

def nucleotide_ascii_to_index(ascii_codes):
    """ASCII byte(s) -> nucleotide letter index (AwFmLetter.c:4-22)."""
    return NT_ASCII_TO_INDEX[np.asarray(ascii_codes, dtype=np.uint8)]


def amino_ascii_to_index(ascii_codes):
    """ASCII byte(s) -> amino letter index (AwFmLetter.c:55-67)."""
    return AA_ASCII_TO_INDEX[np.asarray(ascii_codes, dtype=np.uint8)]


def ascii_to_index(ascii_codes, alphabet) -> np.ndarray:
    from .config import AlphabetType

    if alphabet == AlphabetType.AMINO:
        return amino_ascii_to_index(ascii_codes)
    return nucleotide_ascii_to_index(ascii_codes)


def sanitize(ascii_codes, alphabet) -> np.ndarray:
    """Map ambiguity codes to the canonical ambiguity char ('x'/'z').

    Mirrors fullSequenceSanitize (AwFmCreate.c:452-466).
    """
    from .config import AlphabetType

    arr = np.asarray(ascii_codes, dtype=np.uint8)
    if alphabet == AlphabetType.AMINO:
        return AA_SANITIZE[arr]
    return NT_SANITIZE[arr]


def is_ambiguous(ascii_codes, alphabet) -> np.ndarray:
    """Ambiguity predicate, vectorized (AwFmLetter.c:98-125)."""
    from .config import AlphabetType

    arr = np.asarray(ascii_codes, dtype=np.uint8)
    lower = arr | 0x20
    if alphabet == AlphabetType.AMINO:
        return (lower == ord("z")) | (lower == ord("x")) | (lower == ord("b"))
    ok = np.zeros(256, dtype=bool)
    for ch in "acgtu":
        ok[ord(ch)] = True
    return ~ok[lower]


def cardinality(alphabet) -> int:
    from .config import AlphabetType

    return AMINO_CARDINALITY if alphabet == AlphabetType.AMINO else NUCLEOTIDE_CARDINALITY


def sentinel_index(alphabet) -> int:
    from .config import AlphabetType

    return AMINO_SENTINEL_INDEX if alphabet == AlphabetType.AMINO else NUCLEOTIDE_SENTINEL_INDEX


def ambiguity_index(alphabet) -> int:
    from .config import AlphabetType

    return AMINO_AMBIGUITY_INDEX if alphabet == AlphabetType.AMINO else NUCLEOTIDE_AMBIGUITY_INDEX


def index_to_vector_lut(alphabet) -> np.ndarray:
    from .config import AlphabetType

    return AA_INDEX_TO_VECTOR if alphabet == AlphabetType.AMINO else NT_INDEX_TO_VECTOR


def vector_to_index_lut(alphabet) -> np.ndarray:
    from .config import AlphabetType

    return AA_VECTOR_TO_INDEX if alphabet == AlphabetType.AMINO else NT_VECTOR_TO_INDEX


def num_bit_planes(alphabet) -> int:
    from .config import AlphabetType

    return (
        AMINO_VECTORS_PER_BLOCK
        if alphabet == AlphabetType.AMINO
        else NUCLEOTIDE_VECTORS_PER_BLOCK
    )

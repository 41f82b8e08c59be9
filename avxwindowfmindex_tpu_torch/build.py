"""Index construction (awFmCreateIndex / awFmCreateIndexFromFasta parity).

Counterpart of ``avxwindowfmindex_tpu/build.py``. Pipeline
(AwFmCreate.c:31-137 / 140-279):
  1. sanitize a copy of the sequence (ambiguity -> 'x'/'z');
  2. append the '$' sentinel;
  3. build the suffix array (native SA-IS or NumPy doubling);
  4. derive BWT letters + prefix sums (setBwtAndPrefixSums);
  5. sample the suffix array (every ratio-th BWT position);
  6. build the k-mer seed table on ``device`` (ops/seed_table.py);
  7. optionally serialize to a byte-compatible `.awfmi` file.

``device_sa_ratio`` cuts a denser device-only SA from the full SA at
step 5 (``FmIndex.device_sa``); the `.awfmi` file keeps the config ratio.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from . import suffix_array as sa_mod
from .models import alphabet as alpha
from .models.config import (
    CURRENT_VERSION_NUMBER,
    FEATURE_FLAG_BIT_FASTA_VECTOR,
    AlphabetType,
    IndexConfiguration,
)
from .models.index import FastaMetadata, FmIndex, as_device


def _compute_bwt_letters(
    sanitized_with_sentinel: np.ndarray, sa: np.ndarray, alphabet: AlphabetType
) -> np.ndarray:
    """BWT letter indices in SA order (AwFmCreate.c:315-335).

    letter[i] = sentinel if SA[i] == 0 else letterIndex(seq[SA[i] - 1]);
    chunked so the int64 temporaries stay bounded.
    """
    n = len(sa)
    lett = np.empty(n, dtype=np.uint8)
    sentinel = alpha.sentinel_index(alphabet)
    chunk = 1 << 26
    for lo in range(0, n, chunk):
        s = sa[lo : lo + chunk]
        prev = s - 1
        np.maximum(prev, 0, out=prev)
        part = alpha.ascii_to_index(
            sanitized_with_sentinel[prev], alphabet
        ).astype(np.uint8, copy=False)
        part[s == 0] = sentinel
        lett[lo : lo + chunk] = part
    return lett


def _compute_prefix_sums(bwt_letters: np.ndarray, alphabet: AlphabetType) -> np.ndarray:
    """Cumulative letter counts with the sentinel counted into
    prefixSums[0] = 1 (AwFmCreate.c:338-344, 397-403)."""
    card = alpha.cardinality(alphabet)
    counts = np.bincount(bwt_letters, minlength=card + 2).astype(np.uint64)
    ps = np.empty(card + 2, dtype=np.uint64)
    ps[0] = 1
    ps[1:] = 1 + np.cumsum(counts[: card + 1])
    return ps


def attach_seed_table(index: FmIndex, device, pair_rows: Optional[bool] = None) -> None:
    """Build the seed table on ``device`` and install it in the index's
    device view (the host copy materializes lazily for serde); the view
    is ``to_device``'s with ``pair_rows`` (None: the installed layout),
    so a view without pair rows never packs them."""
    from .ops import seed_table as seed_mod

    dev = index.to_device(device, pair_rows=pair_rows)
    table = seed_mod.build_seed_table(
        dev,
        alpha.cardinality(index.config.alphabet_type),
        index.config.kmer_length_in_seed_table,
        index.prefix_sums,
    )
    index._device_cache = dataclasses.replace(dev, seed_table=table)


def _build_from_sanitized(
    sanitized: np.ndarray,
    original_sequence: Optional[bytes],
    config: IndexConfiguration,
    fasta_metadata: Optional[FastaMetadata],
    file_src: Optional[str],
    sa_backend: Optional[str],
    device,
    device_sa_ratio: Optional[int] = None,
    pair_rows: bool = True,
) -> FmIndex:
    seq_with_sentinel = np.concatenate(
        [sanitized, np.array([ord("$")], dtype=np.uint8)]
    )
    bwt_length = len(seq_with_sentinel)

    sa = sa_mod.build_suffix_array(seq_with_sentinel, backend=sa_backend)

    bwt_letters = _compute_bwt_letters(seq_with_sentinel, sa, config.alphabet_type)
    prefix_sums = _compute_prefix_sums(bwt_letters, config.alphabet_type)
    sampled = sa[:: config.suffix_array_compression_ratio].astype(np.uint64)
    guard = sa_mod.guard_bytes_from_full_sa(
        sa, bwt_length, config.suffix_array_compression_ratio
    )
    # denser DEVICE-side SA samples: cut from the full SA, which exists
    # only here
    device_sa = None
    if device_sa_ratio is not None:
        if device_sa_ratio < 1:
            raise ValueError("device_sa_ratio must be >= 1")
        if device_sa_ratio >= config.suffix_array_compression_ratio:
            # no denser than the serialized samples: nothing to gain
            device_sa_ratio = None
        elif bwt_length // device_sa_ratio >= 2**31:
            raise ValueError(
                "dense device SA gather index must fit int32: need "
                "bwtLength / device_sa_ratio < 2^31"
            )
        else:
            device_sa = sa[::device_sa_ratio].astype(np.uint64)
    del sa

    feature_flags = 0
    if fasta_metadata is not None:
        feature_flags |= 1 << FEATURE_FLAG_BIT_FASTA_VECTOR

    index = FmIndex(
        config=config,
        bwt_length=bwt_length,
        bwt_letters=bwt_letters,
        prefix_sums=prefix_sums,
        kmer_seed_table=None,  # built on the device below
        sampled_sa=sampled,
        sa_guard_bytes=guard,
        version_number=CURRENT_VERSION_NUMBER,
        feature_flags=feature_flags,
        sequence=original_sequence if config.store_original_sequence else None,
        fasta_metadata=fasta_metadata,
        device_sa=device_sa,
        device_sa_ratio=device_sa_ratio if device_sa is not None else None,
    )
    attach_seed_table(index, device, pair_rows)
    if as_device(device).type == "cpu":
        # no transfer cost: keep the host view eagerly available
        index.seed_table_host()

    if file_src is not None:
        from .io import awfmi

        awfmi.write_index(index, file_src)
        index.file_path = file_src
        if not config.keep_suffix_array_in_memory:
            # keep the seed table on the host so a later to_device()
            # does not need the dropped device view
            index.seed_table_host()
            index.sampled_sa = None
            index._device_cache = None
    elif not config.keep_suffix_array_in_memory:
        raise ValueError(
            "keep_suffix_array_in_memory=False requires a file_src to page "
            "suffix-array values from"
        )
    return index


def _warn_mixed_case_amino(seq_arr: np.ndarray, alphabet: AlphabetType) -> None:
    """Mixed-case amino databases are invalid input in BOTH libraries.

    Amino sanitization preserves case, so the suffix order is the
    mixed-case byte order while letter indices collapse case — the
    resulting "BWT" is not a BWT and locate can loop forever (the
    reference hangs identically). Warn instead of letting locate spin.
    """
    if alphabet != AlphabetType.AMINO:
        return
    has_upper = bool(((seq_arr >= 0x41) & (seq_arr <= 0x5A)).any())
    has_lower = bool(((seq_arr >= 0x61) & (seq_arr <= 0x7A)).any())
    if has_upper and has_lower:
        import warnings

        warnings.warn(
            "mixed-case amino database: suffix order is case-sensitive "
            "byte order but matching collapses case, so locate on this "
            "index can loop forever (in the reference library too). "
            "Normalize the database to a single case.",
            UserWarning,
            stacklevel=3,
        )


def create_index(
    sequence: Union[bytes, str, np.ndarray],
    config: Optional[IndexConfiguration] = None,
    file_src: Optional[str] = None,
    sa_backend: Optional[str] = None,
    device_sa_ratio: Optional[int] = None,
    *,
    device,
    pair_rows: bool = True,
) -> FmIndex:
    """Build an index from a raw sequence (awFmCreateIndex,
    AwFmCreate.c:31-137); the seed table is built on ``device``.

    ``device_sa_ratio``: optional device-side SA sampling denser than
    the config ratio (the reference's in-memory-SA locate-speed trade);
    the .awfmi file keeps the config ratio. ``pair_rows=False``: the
    seed table is built on the view without pair rows
    (``FmIndex.to_device``), which stays installed."""
    config = config or IndexConfiguration()
    if isinstance(sequence, str):
        sequence = sequence.encode()
    if isinstance(sequence, (bytes, bytearray)):
        seq_arr = np.frombuffer(bytes(sequence), dtype=np.uint8)
    else:
        seq_arr = np.asarray(sequence, dtype=np.uint8)
    if len(seq_arr) == 0:
        raise ValueError("sequence must be non-empty")
    _warn_mixed_case_amino(seq_arr, config.alphabet_type)
    sanitized = alpha.sanitize(seq_arr, config.alphabet_type)
    original = None
    if config.store_original_sequence:
        original = (
            sequence if isinstance(sequence, bytes) else bytes(seq_arr)
        )
    return _build_from_sanitized(
        sanitized, original, config, None, file_src, sa_backend, device,
        device_sa_ratio, pair_rows,
    )


def create_index_from_fasta(
    fasta_src: str,
    config: Optional[IndexConfiguration] = None,
    index_file_src: Optional[str] = None,
    sa_backend: Optional[str] = None,
    device_sa_ratio: Optional[int] = None,
    *,
    device,
    pair_rows: bool = True,
) -> FmIndex:
    """Build an index from every sequence in a FASTA file
    (awFmCreateIndexFromFasta, AwFmCreate.c:140-279); ``pair_rows`` as
    in :func:`create_index`."""
    from .io import fasta as fasta_mod

    config = config or IndexConfiguration()
    sequence, metadata = fasta_mod.read_fasta(fasta_src)
    if len(sequence) == 0:
        raise ValueError(f"no sequence data in {fasta_src}")
    seq_arr = np.frombuffer(sequence, dtype=np.uint8)
    _warn_mixed_case_amino(seq_arr, config.alphabet_type)
    sanitized = alpha.sanitize(seq_arr, config.alphabet_type)
    return _build_from_sanitized(
        sanitized, sequence, config, metadata, index_file_src, sa_backend,
        device, device_sa_ratio, pair_rows,
    )

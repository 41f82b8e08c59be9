"""FASTA reading — FastaVector equivalent.

Replaces the reference's FastaVector submodule (used at
AwFmCreate.c:162-196): parses a FASTA file into one concatenated
sequence buffer plus per-sequence header text and cumulative end-offset
metadata. Falls back to a pure-Python parser; the native C++ parser in
native/ is used automatically for large files when built.

Copied from avxwindowfmindex_tpu/io/fasta.py; it parses through the
port's own build of the native host library.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..models.index import FastaMetadata


def read_fasta(path: str) -> Tuple[bytes, FastaMetadata]:
    """Parse a FASTA file.

    Returns (concatenated_sequence_bytes, FastaMetadata). Sequence lines
    are stripped of ASCII whitespace and concatenated across records;
    headers are the text after '>' (trailing newline removed).
    """
    try:
        from ..native import hostlib

        if hostlib.available():
            return hostlib.read_fasta(path)
    except ImportError:
        pass
    return read_fasta_python(path)


def read_fasta_python(path: str) -> Tuple[bytes, FastaMetadata]:
    headers: list = []
    seq_chunks: list = []
    seq_lengths: list = []
    current_len = 0
    started = False

    with open(path, "rb") as fh:
        for raw in fh:
            line = raw.rstrip(b"\r\n")
            if line.startswith(b">"):
                if started:
                    seq_lengths.append(current_len)
                started = True
                current_len = 0
                headers.append(line[1:])
            elif line:
                if not started:
                    # sequence data before any header: treat as one unnamed
                    # record (FastaVector tolerates this)
                    started = True
                    headers.append(b"")
                # \r in the delete-set: a stray mid-line CR would
                # otherwise land in the sequence and sanitize into an
                # ambiguity letter, silently corrupting the index
                # (matches the native parser in native/src/awfm_host.cpp)
                chunk = bytes(line.translate(None, b" \t\v\f\r"))
                seq_chunks.append(chunk)
                current_len += len(chunk)
    if started:
        seq_lengths.append(current_len)

    sequence = b"".join(seq_chunks)
    header_ends = np.cumsum([len(h) for h in headers]).astype(np.uint64)
    sequence_ends = np.cumsum(seq_lengths).astype(np.uint64)
    metadata = FastaMetadata(
        headers=b"".join(headers),
        header_ends=header_ends,
        sequence_ends=sequence_ends,
    )
    return sequence, metadata

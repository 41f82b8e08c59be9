"""Serialization: byte-compatible .awfmi serde and FASTA reading."""

from . import awfmi, fasta

__all__ = ["awfmi", "fasta"]

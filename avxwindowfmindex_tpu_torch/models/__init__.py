"""Data models: alphabet codecs, configuration, and the FM-index structs."""

from . import alphabet
from .config import AlphabetType, IndexConfiguration, ReturnCode
from .index import DeviceIndex, FastaMetadata, FmIndex

__all__ = [
    "alphabet",
    "AlphabetType",
    "IndexConfiguration",
    "ReturnCode",
    "DeviceIndex",
    "FastaMetadata",
    "FmIndex",
]

"""Native index artifact format (.awfmx): an NPZ container.

Counterpart of ``avxwindowfmindex_tpu/io/artifact.py``, with its keys,
dtypes and version gate unchanged, so a file written by either package
loads in the other to an equal ``FmIndex``. The `.awfmi` format
(io/awfmi.py) is the reference's byte layout; this one is the fast
warm start: arrays load straight into the host model with no bit-plane
unpacking, and the dense device SA survives the round trip.

Contents: config scalars, BWT letter indices, prefix sums, the seed
table when the host holds it, the sampled suffix array, the dense device
SA when one was cut, the original sequence and FASTA metadata.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.config import AlphabetType, IndexConfiguration
from ..models.index import FastaMetadata, FmIndex, resolve_device

# v1: every field mandatory, incl. kmer_seed_table.
# v2: kmer_seed_table optional (a build on the device leaves the table
#     there; loaders rebuild it with the device BFS). Bumped so v1-era
#     readers reject the file with a clear version error.
# v3: sampled_sa / device_sa stored uint32 when bwtLength < 2^32 (the
#     host model stays uint64; loaders upcast). v2 files (u64 arrays)
#     stay readable: the loader upcasts whatever width it finds.
_FORMAT_VERSION = 3
_READABLE_VERSIONS = (1, 2, 3)


def save_artifact(index: FmIndex, path: str, *,
                  pull_device_seed_table: bool = False,
                  compress: bool = True) -> None:
    """Serialize to the native .awfmx (NPZ) artifact.

    A seed table that lives only in the device view (an index built on
    the card) is OMITTED unless ``pull_device_seed_table``: at k = 14 the
    pull is a 2.15 GB copy, while ``load_artifact`` rebuilds the table
    with the device BFS (K1) in a fraction of a second.

    ``compress=False`` writes a plain NPZ: suffix arrays are nearly
    incompressible, so zlib buys ~40% of the size for minutes of one
    host core at genome scale; a local warm-start cache wants disk-speed
    writes instead.
    """
    if index.sampled_sa is None:
        raise ValueError("cannot serialize: sampled suffix array not in memory")
    cfg = index.config
    payload = {
        "format_version": np.int64(_FORMAT_VERSION),
        "awfmi_version": np.int64(index.version_number),
        "feature_flags": np.int64(index.feature_flags),
        "ratio": np.int64(cfg.suffix_array_compression_ratio),
        "seed_k": np.int64(cfg.kmer_length_in_seed_table),
        "alphabet": np.int64(int(cfg.alphabet_type)),
        "store_original_sequence": np.int64(int(cfg.store_original_sequence)),
        "bwt_length": np.int64(index.bwt_length),
        "bwt_letters": index.bwt_letters,
        "prefix_sums": index.prefix_sums,
        "sampled_sa": _narrowed(index.sampled_sa, index.bwt_length),
        "sa_guard_bytes": np.frombuffer(index.sa_guard_bytes, dtype=np.uint8),
    }
    if index.kmer_seed_table is not None or pull_device_seed_table:
        payload["kmer_seed_table"] = index.seed_table_host()
    if index.device_sa is not None:
        # the dense device-only SA (create_index(device_sa_ratio=...)) is
        # a build-time product; keeping it makes the file a complete
        # warm start
        payload["device_sa"] = _narrowed(index.device_sa, index.bwt_length)
        payload["device_sa_ratio"] = np.int64(index.device_sa_ratio)
    if index.sequence is not None:
        payload["sequence"] = np.frombuffer(index.sequence, dtype=np.uint8)
    if index.fasta_metadata is not None:
        md = index.fasta_metadata
        payload["fasta_headers"] = np.frombuffer(md.headers, dtype=np.uint8)
        payload["fasta_header_ends"] = md.header_ends
        payload["fasta_sequence_ends"] = md.sequence_ends
    # write through a file object: np.savez appends ".npz" to a bare
    # string path, which would break save('x.awfmx') -> load('x.awfmx')
    writer = np.savez_compressed if compress else np.savez
    with open(path, "wb") as fh:
        writer(fh, **payload)


def _narrowed(values: np.ndarray, bwt_length: int) -> np.ndarray:
    """uint32 view of SA values when every one fits (bwt < 2^32)."""
    if bwt_length < 2**32 and values.dtype != np.uint32:
        return values.astype(np.uint32)
    return values


def load_artifact(path: str, *, device=None, pair_rows: bool = True) -> FmIndex:
    """Load a native .awfmx (NPZ) artifact.

    A file saved without a seed table gets its table rebuilt on
    ``device`` by the BFS (``build.attach_seed_table``: K1X on the card,
    its plain version on the CPU) over the view ``to_device`` builds
    with ``pair_rows`` (False: without pair rows, which stays
    installed), so a loaded index is always ready to search; on the CPU
    the host copy is pulled at once, as create_index does.
    ``device=None`` means the card and raises without one; a file that
    carries its table touches no device and launches no K1X.
    """
    with np.load(path) as z:
        version = int(z["format_version"])
        if version not in _READABLE_VERSIONS:
            raise ValueError(f"{path}: unsupported artifact version {version}")
        cfg = IndexConfiguration(
            suffix_array_compression_ratio=int(z["ratio"]),
            kmer_length_in_seed_table=int(z["seed_k"]),
            alphabet_type=AlphabetType(int(z["alphabet"])),
            keep_suffix_array_in_memory=True,
            store_original_sequence=bool(int(z["store_original_sequence"])),
        )
        sequence: Optional[bytes] = None
        if "sequence" in z:
            sequence = z["sequence"].tobytes()
        metadata: Optional[FastaMetadata] = None
        if "fasta_sequence_ends" in z:
            metadata = FastaMetadata(
                headers=z["fasta_headers"].tobytes(),
                header_ends=z["fasta_header_ends"].copy(),
                sequence_ends=z["fasta_sequence_ends"].copy(),
            )
        idx = FmIndex(
            config=cfg,
            bwt_length=int(z["bwt_length"]),
            bwt_letters=z["bwt_letters"].copy(),
            prefix_sums=z["prefix_sums"].copy(),
            kmer_seed_table=(
                z["kmer_seed_table"].copy() if "kmer_seed_table" in z else None
            ),
            sampled_sa=z["sampled_sa"].astype(np.uint64),
            version_number=int(z["awfmi_version"]),
            feature_flags=int(z["feature_flags"]),
            sequence=sequence,
            fasta_metadata=metadata,
            file_path=None,
            sa_guard_bytes=(
                z["sa_guard_bytes"].tobytes() if "sa_guard_bytes" in z else b"\x00" * 8
            ),
            device_sa=(
                z["device_sa"].astype(np.uint64) if "device_sa" in z else None
            ),
            device_sa_ratio=(
                int(z["device_sa_ratio"]) if "device_sa_ratio" in z else None
            ),
        )
    if idx.kmer_seed_table is None:
        from ..build import attach_seed_table

        device = resolve_device(device)
        attach_seed_table(idx, device, pair_rows)
        if device.type == "cpu":
            idx.seed_table_host()
    return idx

"""avxwindowfmindex_tpu_torch — the FM-index engine in PyTorch and CUDA.

A port of ``avxwindowfmindex_tpu`` (JAX on a TPU) to PyTorch on an
NVIDIA H100. It imports torch and numpy, never jax, and never the JAX
package: the small host modules (alphabet, config, suffix array, FASTA
and ``.awfmi`` serde) are carried over as copies with their byte
layouts unchanged, so the two packages build identical indexes and the
tests compare them array for array.

The main path is four hand-written CUDA kernels (``csrc/``, built by
``ops/kernels.py``): K1 rank/LF (seed-table build), K2 ranges (count),
K3 backtrace + resolve (locate), K4 n-gram ranges (the count and locate
of ``DigramSearchEngine`` / ``NgramSearchEngine``). An index of 2^32
positions and more (or ``wide=True``) runs the same functions over u64
positions through K1w, K2w and K3w. K5 and K6 are the
gather-rate probes that the bench's roofline calibrates with
(``tools/bench.py``, ``tools/gather_probe.py``). Every entry point that
touches a tensor takes an explicit ``device``; those of the JAX
package's wider API (``.awfmx`` artifacts, the ``parallel_search_*``
batch API, ``parallel/``: the retrying engine, the chunked corpus, the
query-parallel engine) take ``device=None`` as the card and raise
without one.

Quick start::

    import avxwindowfmindex_tpu_torch as awfm

    cfg = awfm.IndexConfiguration(
        alphabet_type=awfm.AlphabetType.DNA,
        kmer_length_in_seed_table=8,
        suffix_array_compression_ratio=8,
    )
    index = awfm.create_index("ACGTACGTTAGC...", cfg, device="cuda:0")
    engine = awfm.SearchEngine(index, device="cuda:0")
    counts = engine.count(["ACGTAC", "TTAGC"])
    hits = engine.locate(["ACGTAC"])
"""

from .build import create_index, create_index_from_fasta
from .models.alphabet import (
    AMINO_CARDINALITY,
    NUCLEOTIDE_CARDINALITY,
    POSITIONS_PER_BLOCK,
)
from .models.config import (
    CURRENT_VERSION_NUMBER,
    AlphabetType,
    IndexConfiguration,
    ReturnCode,
)
from .models.index import DeviceIndex, FastaMetadata, FmIndex, search_range_length
from .ops.ngram import build_ngram_device
from .search import (
    DigramSearchEngine,
    NgramSearchEngine,
    SearchEngine,
    backtrace_return_previous_letter_index,
    create_initial_query_range,
    find_database_hit_position_single,
    find_database_hit_positions,
    find_search_range_for_string,
    iterative_step_backward_search,
    query_can_use_kmer_table,
    search_range_is_valid,
    single_kmer_exists,
)


def chunked_corpus_index(sequence, config=None, chunk_bases=(1 << 31), overlap=255, *,
                         device=None):
    """Build a ChunkedCorpusIndex (overlapping sub-indexes behaving like
    one big index) on ``device``; ``None`` means the card."""
    from .parallel.chunked import ChunkedCorpusIndex

    return ChunkedCorpusIndex.build(
        sequence, config, chunk_bases=chunk_bases, overlap=overlap, device=device
    )


def save_artifact(index, path: str) -> None:
    """Serialize to the native .awfmx NPZ artifact (fast load path)."""
    from .io import artifact

    artifact.save_artifact(index, path)


def load_artifact(path: str, *, device=None, pair_rows: bool = True):
    """Load a native .awfmx NPZ artifact; a seed table the file lacks is
    rebuilt on ``device`` (``None``: the card), over the view without
    pair rows when ``pair_rows`` is False."""
    from .io import artifact

    return artifact.load_artifact(path, device=device, pair_rows=pair_rows)


def read_index_from_file(path: str, keep_suffix_array_in_memory: bool = True):
    """awFmReadIndexFromFile parity — load a `.awfmi` index."""
    from .io import awfmi

    return awfmi.read_index(path, keep_suffix_array_in_memory)


def write_index_to_file(index, path: str) -> None:
    """awFmWriteIndexToFile parity — serialize to `.awfmi`."""
    from .io import awfmi

    awfmi.write_index(index, path)


def parallel_search_count(index, kmers, num_threads: int = 0, *, device=None):
    """awFmParallelSearchCount parity (``num_threads`` is accepted and
    ignored: one batched call on ``device``, ``None`` meaning the card)."""
    from .parallel.api import parallel_search_count as _f

    return _f(index, kmers, num_threads, device=device)


def parallel_search_locate(index, kmers, num_threads: int = 0, *, device=None):
    """awFmParallelSearchLocate parity (``num_threads`` is accepted and
    ignored: one batched call on ``device``, ``None`` meaning the card)."""
    from .parallel.api import parallel_search_locate as _f

    return _f(index, kmers, num_threads, device=device)


__version__ = "0.1.0"

__all__ = [
    "AlphabetType",
    "IndexConfiguration",
    "ReturnCode",
    "FmIndex",
    "DeviceIndex",
    "FastaMetadata",
    "create_index",
    "create_index_from_fasta",
    "read_index_from_file",
    "write_index_to_file",
    "parallel_search_count",
    "parallel_search_locate",
    "save_artifact",
    "load_artifact",
    "chunked_corpus_index",
    "SearchEngine",
    "NgramSearchEngine",
    "DigramSearchEngine",
    "build_ngram_device",
    "find_search_range_for_string",
    "find_database_hit_positions",
    "find_database_hit_position_single",
    "backtrace_return_previous_letter_index",
    "single_kmer_exists",
    "query_can_use_kmer_table",
    "iterative_step_backward_search",
    "search_range_is_valid",
    "create_initial_query_range",
    "search_range_length",
    "CURRENT_VERSION_NUMBER",
    "NUCLEOTIDE_CARDINALITY",
    "AMINO_CARDINALITY",
    "POSITIONS_PER_BLOCK",
]

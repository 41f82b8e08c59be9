"""Search-throughput CLI — the tuning/search/timeSearch.c equivalent.

Counterpart of ``avxwindowfmindex_tpu/tools/time_search.py``. Loads an
`.awfmi` index, samples valid kmers from the stored sequence
(timeSearch.c:63-85), and times batched count or locate on ``--device``
(default cuda:0; cpu runs the plain versions) averaged over 4 runs.

Usage:
  python -m avxwindowfmindex_tpu_torch.tools.time_search genome.awfmi \
      --num-kmers 100000 --kmer-length 25 [--count-only] [--device cuda:0]
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Time batched kmer search over an .awfmi index"
    )
    parser.add_argument("index", help=".awfmi index file")
    parser.add_argument("-n", "--num-kmers", type=int, default=100_000)
    parser.add_argument("-k", "--kmer-length", type=int, default=25)
    parser.add_argument(
        "-c", "--count-only", action="store_true",
        help="time count instead of locate (timeSearch.c -c)",
    )
    parser.add_argument(
        "-m", "--in-memory-sa", action="store_true", default=True,
        help="keep the suffix array in memory (timeSearch.c -m)",
    )
    parser.add_argument("--on-disk-sa", dest="in_memory_sa", action="store_false")
    parser.add_argument(
        "--ngram", type=int, default=0, metavar="N",
        help="use the n-step engine with N letters per gather "
             "(2 or 3; nucleotide only)",
    )
    parser.add_argument("-r", "--runs", type=int, default=4)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)

    from .bench import resolve_device

    device = resolve_device(args.device)

    from .. import SearchEngine, read_index_from_file
    from ..io import awfmi
    from ..search import NgramSearchEngine

    index = read_index_from_file(args.index, args.in_memory_sa)
    if not index.config.store_original_sequence:
        print("index does not store the sequence; cannot sample kmers",
              file=sys.stderr)
        return 1

    rng = np.random.default_rng(args.seed)
    seq = awfmi.read_sequence_from_file(index, 0, index.bwt_length - 1)
    starts = rng.integers(0, len(seq) - args.kmer_length, size=args.num_kmers)
    kmers = [seq[s : s + args.kmer_length] for s in starts]

    engine = (
        NgramSearchEngine(index, n=args.ngram, device=device)
        if args.ngram
        else SearchEngine(index, device=device)
    )
    op = engine.count if args.count_only else engine.locate
    op(kmers)  # warm-up at the real batch shape (builds the kernels)

    times = []
    for _ in range(args.runs):
        t0 = time.time()
        result = op(kmers)
        times.append(time.time() - t0)
    if args.count_only:
        total_hits = int(np.sum(result))
    else:
        total_hits = int(sum(len(r) for r in result))
    mean_s = float(np.mean(times))
    mode = "count" if args.count_only else "locate"
    print(
        f"{mode}: {args.num_kmers} kmers x{args.kmer_length} in {mean_s:.4f}s "
        f"(mean of {args.runs}) = {args.num_kmers / mean_s:,.0f} queries/s; "
        f"{total_hits} hits"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

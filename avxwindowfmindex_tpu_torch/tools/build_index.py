"""Index-build CLI — the tuning/build/buildIndex.c equivalent.

Counterpart of ``avxwindowfmindex_tpu/tools/build_index.py``. Builds an
`.awfmi` index from a FASTA (or raw sequence) file, the seed table on
``--device`` (default cuda:0), and reports the build time. Reference
flags (-a amino, -s ratio, -k seed length, -f output) are mirrored with
long names.

Usage:
  python -m avxwindowfmindex_tpu_torch.tools.build_index genome.fa \
      --output genome.awfmi --seed-length 12 --ratio 8 [--device cuda:0]
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        description="Build an AwFm-compatible .awfmi index (seed table on the device)"
    )
    parser.add_argument("input", help="FASTA file (or raw sequence with --raw)")
    parser.add_argument("-f", "--output", required=True, help="output .awfmi path")
    parser.add_argument(
        "-a", "--amino", action="store_true", help="amino-acid alphabet"
    )
    parser.add_argument(
        "--rna", action="store_true", help="RNA alphabet (u instead of t)"
    )
    parser.add_argument(
        "-s", "--ratio", type=int, default=8,
        help="suffix-array compression ratio (default 8)",
    )
    parser.add_argument(
        "-k", "--seed-length", type=int, default=None,
        help="kmer seed-table length (default 12 nt / 5 aa)",
    )
    parser.add_argument(
        "--no-sequence", action="store_true",
        help="do not store the original sequence in the index",
    )
    parser.add_argument(
        "--raw", action="store_true",
        help="treat input as a raw sequence file, not FASTA",
    )
    parser.add_argument(
        "--sa-backend", choices=["native", "numpy"], default=None,
        help="suffix-array construction backend (default: auto)",
    )
    parser.add_argument(
        "--auto-size", action="store_true",
        help="size seed length to the device's memory with the "
        "capacity planner (utils/capacity.py; the input file size is "
        "the corpus estimate). Overridden by an explicit -k.",
    )
    parser.add_argument("--device", default="cuda:0")
    args = parser.parse_args(argv)

    from .bench import resolve_device

    device = resolve_device(args.device)

    from .. import (
        AlphabetType,
        IndexConfiguration,
        create_index,
        create_index_from_fasta,
    )

    if args.amino:
        alphabet = AlphabetType.AMINO
        default_k = 5
    else:
        alphabet = AlphabetType.RNA if args.rna else AlphabetType.DNA
        default_k = 12
    if args.auto_size and args.seed_length is None:
        from ..utils.capacity import plan_capacity

        plan = plan_capacity(
            max(1, os.path.getsize(args.input)), alphabet,
            sa_ratio=args.ratio, device=device,
        )
        default_k = plan.seed_k
        print(f"capacity plan: {plan.summary()}", file=sys.stderr)
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=args.ratio,
        kmer_length_in_seed_table=(
            args.seed_length if args.seed_length is not None else default_k
        ),
        alphabet_type=alphabet,
        store_original_sequence=not args.no_sequence,
    )

    t0 = time.time()
    if args.raw:
        with open(args.input, "rb") as fh:
            sequence = fh.read().replace(b"\n", b"").replace(b"\r", b"")
        index = create_index(
            sequence, cfg, file_src=args.output, sa_backend=args.sa_backend,
            device=device,
        )
    else:
        index = create_index_from_fasta(
            args.input, cfg, index_file_src=args.output,
            sa_backend=args.sa_backend, device=device,
        )
    elapsed = time.time() - t0
    print(
        f"built {args.output}: bwtLength={index.bwt_length} "
        f"sequences={index.num_sequences()} alphabet={alphabet.name} "
        f"ratio={cfg.suffix_array_compression_ratio} "
        f"k={cfg.kmer_length_in_seed_table} in {elapsed:.2f}s"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())

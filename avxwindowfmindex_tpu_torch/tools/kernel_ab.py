"""The index kernels of two or more checkouts, timed in turns on one card.

    python -m avxwindowfmindex_tpu_torch.tools.kernel_ab --other parent=DIR
        [--other NAME=DIR ...] [--bases N] [--queries N] [--reps N]
        [--cases all|bfs]

``DIR`` is the root of another checkout of this repository (for one
commit, ``git archive <commit> | tar -x -C DIR``). Its
``avxwindowfmindex_tpu_torch/ops/kernels.py`` is loaded under an alias
and builds its own kernel library from its own ``csrc/``; the index, the
queries and every other tensor are made once, by this checkout, and
handed to each checkout's wrappers, so all of them run on the same
inputs. For each case the results must be equal (tolerance 0) and the
launches are timed with CUDA events in turns, first to last and then
last to first, ``--reps`` launches each after a warm-up.

Cases, at the bench protocol's shapes (64M random bases, seed k = 14, SA
ratio 8): K1 (8,388,608 rank pairs; 1,048,576 LF pairs), K2 (``--queries``
sampled 25-mers; their last k, k + 1, k + 3, k + 7 and k + 11 letters,
for a fit of time = fixed + steps x per step; 524,288 unseeded 11-mers,
the multi-hit stage's ranges), K3 (the 25-mers' hits; the same rounded
down to sampled positions, walks of 0 steps; the 11-mers' hits in range
order; the 25-mers' hits over a ratio-4 device SA; the same as
(position, offset) pairs, the on-disk form), K4 by length likewise, K2, K4 and K3 as the
bench protocol launches them (four chunks of fresh queries in turn, all
four in one launch, their hits, and the whole ``locate_all`` pass at
both SA ratios), K4 (the 25-mers, n = 2), K1w / K2w / K3w (the
same index as a wide view), and K2 and K3 on a 2M-residue amino index.
The seed-table BFS comes first (``--cases bfs``: it alone): the whole
k = 14 table through each checkout's ``build_seed_table``, then each
depth through the checkout's ``extend_level`` (a checkout that has none
steps a depth as its ``build_seed_table`` did, through this checkout's
``extend_level_plain`` over the checkout's K1 occ mode), and the same
over the wide view at k = 13; at each depth, the K1 launches of the
per-letter route are also timed alone, apart from the torch work around
them (``"k1_launches_ms"``).

Prints the card's ``nvidia-smi`` name and power limit, then one JSON line
per case: ``{"case", "shape", "ms": {name: [first, second]}}`` with
``this`` for this checkout.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys

import numpy as np


def _log(msg: str) -> None:
    print(f"[ab] {msg}", file=sys.stderr, flush=True)


def load_kernels(name: str, root: str):
    """``ops.kernels`` of the checkout at ``root``, imported under the
    package alias ``awfm_ab_<name>``."""
    pkg_dir = os.path.join(os.path.abspath(root), "avxwindowfmindex_tpu_torch")
    alias = f"awfm_ab_{name}"
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg_dir, "__init__.py"), submodule_search_locations=[pkg_dir])
    module = importlib.util.module_from_spec(spec)
    sys.modules[alias] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f"{alias}.ops.kernels")


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / reps


def _same(a, b) -> bool:
    import torch

    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def run_case(case: str, shape: str, call, libs: dict, reps: int) -> None:
    """``call(kernels_module)`` through every checkout: equal results, then
    times in turns."""
    names = list(libs)
    want = call(libs[names[0]])
    for name in names[1:]:
        if not _same(call(libs[name]), want):
            raise AssertionError(f"{case}: {name} differs from {names[0]}")
    ms = {name: [] for name in names}
    for name in names + names[::-1]:
        ms[name].append(cuda_ms(lambda: call(libs[name]), reps))
    print(json.dumps({"case": case, "shape": shape, "ms": ms}), flush=True)


def _sibling(kernels_module, name: str):
    """The module ``ops.<name>`` of the checkout whose ``ops.kernels`` is
    ``kernels_module``."""
    return importlib.import_module(kernels_module.__name__.rsplit(".", 1)[0] + "." + name)


def _depth_step(kernels_module):
    """The checkout's one BFS depth: its ``extend_level``, or the chunked
    per-letter loop over its K1 occ mode."""
    seed = _sibling(kernels_module, "seed_table")
    if hasattr(seed, "extend_level"):
        return seed.extend_level
    from ..ops.seed_table import extend_level_plain

    occ = _sibling(kernels_module, "rank").occurrence
    return lambda dev, table: extend_level_plain(dev, table, occurrence_fn=occ)


def k1_launch_ms(dev, table) -> tuple:
    """(ms, launches) of the K1 occ launches alone inside one per-letter
    step of ``table`` (``extend_level_plain`` over K1): CUDA events
    around each launch, summed."""
    import torch
    from ..ops import rank
    from ..ops.seed_table import extend_level_plain

    events = []

    def occ(view, pos, lett):
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        out = rank.occurrence(view, pos, lett)
        pair[1].record()
        events.append(pair)
        return out

    extend_level_plain(dev, table, occurrence_fn=occ)  # warm-up
    events.clear()
    extend_level_plain(dev, table, occurrence_fn=occ)
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events), len(events)


def bfs_cases(index, views, libs: dict, reps: int) -> None:
    """The seed-table BFS of ``index`` through every checkout: ``views``
    maps a case tag to (device view, k)."""
    import torch
    from ..ops import seed_table

    ps = index.prefix_sums
    for tag, (dev, k) in views.items():
        card = dev.cardinality
        run_case(f"bfs{tag} k={k}", f"{card}^{k} ranges",
                 lambda km: _sibling(km, "seed_table").build_seed_table(dev, card, k, ps),
                 libs, max(1, reps // 5))
        table = seed_table.build_seed_table(dev, card, 1, ps)
        for depth in range(1, k):
            parents = table
            run_case(f"bfs{tag} depth {depth}", f"{parents.shape[0]} parents",
                     lambda km: _depth_step(km)(dev, parents), libs, reps)
            ms, launches = k1_launch_ms(dev, parents)
            print(json.dumps({"case": f"bfs{tag} depth {depth}", "k1_launches_ms": ms,
                              "k1_launches": launches}), flush=True)
            table = seed_table.extend_level(dev, parents)
        del table, parents
        torch.cuda.empty_cache()


def lengthwise_batch(mat_d, full_len: int, length: int):
    """The last ``length`` letters of every ``full_len``-mer of the
    letter matrix ``mat_d`` as a K2 / K4 batch (matrix padded to a
    multiple of 4 columns, lengths, all seeded): a suffix of a query
    sampled from the text occurs in the text."""
    import torch

    n = mat_d.shape[0]
    out = torch.zeros((n, -(-length // 4) * 4), dtype=torch.uint8, device=mat_d.device)
    out[:, :length] = mat_d[:, full_len - length : full_len]
    return (out, torch.full((n,), length, dtype=torch.int32, device=mat_d.device),
            torch.ones(n, dtype=torch.uint8, device=mat_d.device))


def _sampled(rng, seq_arr, length: int, count: int):
    starts = rng.integers(0, len(seq_arr) - length, size=count)
    return np.lib.stride_tricks.sliding_window_view(seq_arr, length)[starts]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--bases", type=int, default=64_000_000)
    ap.add_argument("--queries", type=int, default=1 << 20)
    ap.add_argument("--seed-k", type=int, default=14)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", choices=("all", "bfs"), default="all")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("kernel_ab needs a GPU")
    from .. import AlphabetType, IndexConfiguration, SearchEngine, create_index, search
    from ..ops import kernels as this_kernels
    from ..ops import ngram
    from .bench import device_line

    device = torch.device("cuda", 0)
    print(device_line(device), flush=True)
    libs = {"this": this_kernels}
    for item in args.other:
        name, root = item.split("=", 1)
        libs[name] = load_kernels(name, root)
    for name, lib in libs.items():
        _log(f"{name}: built in {lib.build():.1f}s -> {lib.library_path()}")

    rng = np.random.default_rng(1234)
    seq_arr = rng.choice(np.frombuffer(b"acgt", np.uint8), size=args.bases)
    index = create_index(seq_arr.tobytes(), IndexConfiguration(8, args.seed_k, AlphabetType.DNA),
                         sa_backend="native", device=device)
    dev = index.to_device(device)
    eng = SearchEngine(index, device=device)
    ng = ngram.build_ngram_device(index, 2, device=device)
    _log(f"index of {args.bases} bases, seed k={args.seed_k}, and its n = 2 table built")
    reps = args.reps

    def encoded(rows, engine):
        mat, lengths, _ = engine.encode_kmers([r.tobytes() for r in rows])
        seeded = engine._seed_eligibility(mat, lengths)
        return (torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
                torch.from_numpy(seeded.astype(np.uint8)).to(device))

    def index_cases(dev, tag: str, k4: bool) -> None:
        b = 1 << 23
        pos = torch.from_numpy(rng.integers(0, dev.bwt_length, size=b)).to(device)
        lett = torch.from_numpy(rng.integers(0, dev.cardinality, size=b).astype(np.int32)).to(device)
        run_case(f"k1{tag} occ", f"{b} pairs", lambda k: k.k1_occurrence(dev, pos, lett), libs, reps)
        lpos = pos[: 1 << 20].contiguous()
        run_case(f"k1{tag} letter_lf", f"{lpos.numel()} positions",
                 lambda k: k.k1_letter_and_lf(dev, lpos), libs, reps)
        q25 = encoded(_sampled(rng, seq_arr, 25, args.queries), eng)
        run_case(f"k2{tag}", f"{args.queries} 25-mers", lambda k: k.k2_ranges(dev, *q25), libs, reps)
        if k4:
            # by length: fixed + steps x per step (a query of k letters is
            # the seed-table visit alone; K4 needs more than k)
            for extra in (0, 1, 3, 7, 11):
                q = lengthwise_batch(q25[0], 25, args.seed_k + extra)
                run_case(f"k2 by length: k + {extra}", f"{args.queries} queries",
                         lambda k: k.k2_ranges(dev, *q), libs, reps)
            for extra in (2, 4, 8, 10):
                q = lengthwise_batch(q25[0], 25, args.seed_k + extra)
                run_case(f"k4 by length: k + {extra}", f"{args.queries} queries",
                         lambda k: k.k4_ngram_ranges(dev, ng, q[0], args.seed_k + extra), libs, reps)
        q11 = encoded(_sampled(rng, seq_arr, 11, 1 << 19), eng)
        run_case(f"k2{tag} unseeded", f"{1 << 19} 11-mers", lambda k: k.k2_ranges(dev, *q11), libs, reps)
        hits = {}
        for label, q in (("25-mers", q25), ("11-mers", q11)):
            s, e = this_kernels.k2_ranges(dev, *q)
            counts = search.range_counts(s, e, dev.wide)
            hits[label] = search.enumerate_range_positions(s, counts)
        for label, positions in hits.items():
            run_case(f"k3{tag} hits of the {label}", f"{positions.numel()} hits, ratio {dev.ratio}",
                     lambda k: k.k3_backtrace_resolve(dev, positions), libs, reps)
        disk = dataclasses.replace(dev, sampled_sa=None)
        positions = hits["25-mers"]
        sampled = (positions // dev.ratio) * dev.ratio
        run_case(f"k3{tag} walks of 0 steps", f"{positions.numel()} hits, ratio {dev.ratio}",
                 lambda k: k.k3_backtrace_resolve(dev, sampled), libs, reps)
        run_case(f"k3{tag} on-disk form", f"{positions.numel()} hits, ratio {dev.ratio}",
                 lambda k: k.k3_backtrace_resolve(disk, positions), libs, reps)
        if k4:
            run_case("k4 n=2", f"{args.queries} 25-mers",
                     lambda k: k.k4_ngram_ranges(dev, ng, q25[0], 25), libs, reps)
            # as the bench protocol launches them: four chunks of fresh
            # queries one after the other (count), all four in one launch
            # (locate), and their hits in one K3 launch
            four = [encoded(_sampled(rng, seq_arr, 25, args.queries), eng) for _ in range(4)]
            whole = tuple(torch.cat([q[i] for q in four]) for i in range(3))
            run_case("k2, 4 chunks", f"4 x {args.queries} 25-mers",
                     lambda k: tuple(k.k2_ranges(dev, *q)[0] for q in four), libs, reps)
            run_case("k4 n=2, 4 chunks", f"4 x {args.queries} 25-mers",
                     lambda k: tuple(k.k4_ngram_ranges(dev, ng, q[0], 25)[0] for q in four), libs, reps)
            run_case("k4 n=2, one launch", f"{4 * args.queries} 25-mers",
                     lambda k: k.k4_ngram_ranges(dev, ng, whole[0], 25), libs, reps)
            s4, e4 = this_kernels.k4_ngram_ranges(dev, ng, whole[0], 25)
            hits4 = search.enumerate_range_positions(s4, search.range_counts(s4, e4))
            run_case("k3, one launch", f"{hits4.numel()} hits, ratio {dev.ratio}",
                     lambda k: k.k3_backtrace_resolve(dev, hits4), libs, reps)
            cap = -(-hits4.numel() // 65536) * 65536

            def locate_all(k, view):
                s, e = k.k4_ngram_ranges(view, ng, whole[0], 25)
                slots, _, _ = search.enumerate_flat(s, e, capacity=cap)
                return k.k3_backtrace_resolve(view, slots)

            run_case("locate_all pass (K4, enumerate, K3)", f"{4 * args.queries} 25-mers, ratio {dev.ratio}",
                     lambda k: locate_all(k, dev), libs, reps)
            dense = index.densify_device_sa(4, device=device)
            run_case("k3 dense SA", f"{positions.numel()} hits, ratio 4",
                     lambda k: k.k3_backtrace_resolve(dense, positions), libs, reps)
            run_case("k3 dense SA, one launch", f"{hits4.numel()} hits, ratio 4",
                     lambda k: k.k3_backtrace_resolve(dense, hits4), libs, reps)
            run_case("locate_all pass (K4, enumerate, K3)", f"{4 * args.queries} 25-mers, ratio 4",
                     lambda k: locate_all(k, dense), libs, reps)
            del four, whole, s4, e4, hits4

    bfs_cases(index, {"": (dev, args.seed_k)}, libs, reps)
    if args.cases == "all":
        index_cases(dev, "", k4=True)
    wide = index.to_device(device, wide=True)
    bfs_cases(index, {"w": (wide, args.seed_k - 1)}, libs, reps)
    if args.cases == "bfs":
        return 0
    index_cases(wide, "w", k4=False)
    del dev, wide, ng
    torch.cuda.empty_cache()

    aa_arr = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8), size=2_000_000)
    aa_index = create_index(aa_arr.tobytes(), IndexConfiguration(8, 5, AlphabetType.AMINO),
                            sa_backend="native", device=device)
    aa_eng = SearchEngine(aa_index, device=device)
    aa_dev = aa_eng.dev
    q12 = encoded(_sampled(rng, aa_arr, 12, 1 << 18), aa_eng)
    run_case("k2 amino", f"{1 << 18} 12-mers, k=5", lambda k: k.k2_ranges(aa_dev, *q12), libs, reps)
    apos = torch.from_numpy(rng.integers(0, aa_dev.bwt_length, size=1 << 20)).to(device)
    run_case("k3 amino", f"{apos.numel()} positions, ratio 8",
             lambda k: k.k3_backtrace_resolve(aa_dev, apos), libs, reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

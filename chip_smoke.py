#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

    python3 chip_smoke.py [--bases N]

Phases (any failure raises and the script exits nonzero):
  1. the card and the software; requires torch.cuda.is_available();
  2. build the CUDA kernels from avxwindowfmindex_tpu_torch/csrc/;
  3. each kernel against its plain torch version on the same CUDA
     tensors (1M-base DNA and amino indexes; K4 through n = 2 and 3
     tables, biased and unbiased; a repeat-rich corpus whose ranges
     outgrow the 512-position pair window; a window-class corpus, runs of
     one letter of 700, 300 and 420 inside random text, on which K2 and
     K4, n = 2 and 3, must take each of the three window classes of a
     step at least once, by the plain versions' class counts; for K2,
     whose two lanes share a query and hold its letters in registers,
     seeded and unseeded queries mixed in one odd-sized batch, every
     length from 1 to the matrix's width and matrices of 44 and 72
     columns; for K3, whose grid hands a lane its next hit, every position
     of the index (more hits than the grid holds at once, the sentinel's
     row among them), walks of 0 steps, 19 hits and 1 hit, and an index
     of SA ratio 3, each with the SA resident and on disk; for K1X, the
     seed-table BFS's level extend, every depth of the DNA k = 10 and
     amino k = 5 BFS and crafted parent tables: start == 0, absent
     ranges, both ends in one block, in two, on the last row, past the
     table, a ragged count), and K1X's BFS mode (the depth-1 ranges and
     the depths whose parents number at most a threshold in one
     cooperative launch) against the plain BFS at every k up to the
     index's, the whole table in the one launch and split at 16 or 400
     parents, its launches read from the wrappers' counters, with kernel
     and plain times side by side;
     K2 over block rows (the view without pair rows) on every K2 batch
     of the 1M-base indexes and on the window-class corpus with short and
     ambiguous queries in one odd-sized batch (each class taken at least
     once, by the plain counts), and K4 with its tail over block rows, n =
     2 and 3, each equal to its plain version and to the pair-row form;
     K1's single-query modes (a step of one range and the LF of one
     position, passed by value) on crafted ranges, letters and positions
     (single_edges: start 0, end = bwtLength - 1, end < start, the
     ambiguity and sentinel letters and letters beyond them, the
     sentinel's position), tolerance 0;
  3w. the same for K1w, K2w, K3w and K1WX on the forced-wide views of
     such indexes (u64 positions over 256 B / 512 B rows), with positions
     no search produces (2^64 - 1, 2^40 + 5) for the block-index rule;
     and their forms over the compact 384 B rows of the amino index's
     wide view without pair rows (to_device(wide=True, pair_rows=False)):
     K1WX at every depth of the k = 5 BFS and on crafted parents, its BFS
     mode against the plain BFS at every k from 1 to 5 and a profiler
     trace of one k = 5 table (the script's first: no host-to-device copy,
     no kernel but the BFS mode, one launch by the wrapper's counter), K1w's
     occ and LF modes on the same positions, K2w on every batch, K3w with
     the SA resident and on disk, each equal to its plain version and to
     the pair-fused form;
  3e. K7, the flat enumerate of locate_flat_device, against its plain
     version on the same CUDA tensors, exactly, narrow and wide: crafted
     batches (no range, every range empty, queries without a hit first,
     in the middle and last, capacities that cut a range, far past the
     total and 0, u64 ranges above 2^32 and 2^63), and the benchmark's
     locate11 and locate25 shapes (tools/kernel_ab.py ENUMERATE_SHAPES)
     at their rounded capacity and cut in half, timed in turns (the
     kernels line takes locate11's);
  4. the main path at full size: create_index on 64M random bases
     (seed k = 14, SA ratio 8, native SA-IS) -> DigramSearchEngine
     (n = 2, Cn-biased table, as bench.py runs it) -> count and locate
     of 1,048,576 sampled 25-mers, the same through the single-step
     SearchEngine, the digram ranges held equal to the single-step ones
     over every query, and locate of 4,096 multi-hit 11-mers (shorter
     than k, so they fall back to the single-step kernel), all checked
     against host scans; the kernels' launch counts are reset just
     before and read just after (the build's seed table: K1X, 5
     launches, one of them its BFS mode's for depths 1-9; K1: none); then
     a stage breakdown of one digram locate, and each kernel against its
     plain version at the shapes the main path gave it, timed in turns:
     the k = 14 seed-table BFS by four routes (K1X one launch a depth,
     each depth timed; the build's route, BFS mode and then K1X, the
     whole table timed; the per-letter loop over K1's occ mode, the
     route before K1X, with its K1 launches timed apart from the torch
     work around them; the plain version); the share of K4's and
     K2's steps in each window class, and their bounds charged by class;
  3b. the gather-rate probes against their plain versions: K5 at each
     experiment's own shapes (P2/P4: 2^19 indices over 1 GiB tables of
     128 B and 512 B rows, ring depths 8 and 16; P3: (2^20, 8, 128) 1 KB
     rows, the first 128 B summed; an all-0xFF table for the int32 wrap)
     (the reduce timed as device time with the queue kept full), and
     every lane layout and ring depth of the reduce on a small table,
     with ragged chunks and indices past it on both sides,
     and K6 at P5's (S = 2048 and 8192, single and chained, a ragged
     count with indices out of range), timed in
     turns; K6's single gather and torch.index_select both per call and
     as the device time of 20 launches captured in one CUDA graph and
     replayed; and K5's walk over the 1 GiB table of 512 B rows reading
     8 of a row's 16 sectors, every other one or the first 8, and all 16
     (in what pieces device memory is read);
  4s. what K2, K4 and K3 pay per query or hit and what per step, on the
     phase-4 index (it runs after phase 6, whose calibrated rates it sets
     the steps against): K2 and K4 on the last L letters of the main
     batch's 25-mers for several L, fitted to fixed + steps x per step
     (a query of k letters is the seed-table visit alone); K2 again over
     a k = 12 seed table (134 MB against 2.15 GB); K3 on hits that need
     no LF step (the SA visit alone) and on the main batch's, at the
     index's SA ratio and on the ratio-4 device SA; and the
     lane-occupancy ratio of one thread a hit;
  5. a .awfmi round trip of the 1M-base index;
  6. the bench protocol (avxwindowfmindex_tpu_torch/tools/bench.py) on
     the phase-4 index at 1,048,576 queries and 3 runs: a ratio-4 device
     SA from densify_device_sa(4), held equal to a sa[::4] cut of the
     host suffix array; every stage, the cross-engine parity and the host
     spot checks, the calibration through K5 and K6 (their launches are
     counted here), and the meta line; locate_flat_device held equal to
     SearchEngine.locate on 4,096 queries; then K5's walk, over whole
     rows and over the sectors a first-block step reads, and K6's chain
     against their plain versions at the calibration shapes, each table's
     masked rate beside its whole-row rate; every fraction of a gather
     ceiling and of the HBM rate that the bench printed must be <= 1.

  4w. the 64-bit path at full width: the phase-4 index as a wide view
     (to_device(device, wide=True)): the k = 14 seed table widened from
     the narrow one and, at k = 13, built by the BFS through K1WX, equal
     to the narrow BFS widened; count and locate of the same 1,048,576
     25-mers and of
     the 11-mer multi-hit set through the wide SearchEngine, equal to the
     narrow engine's answers exactly and checked against host scans; the
     wide densify_device_sa(4) equal to the narrow one; the launch counts
     of K1WX (its BFS mode once), K2w and K3w reset just before and read
     just after; then each
     against its plain version at this path's shapes (the k = 13 BFS by
     the four routes of phase 4, 8,388,608 rank pairs, 1,048,576
     25-mers, their hits), timed in turns, with the narrow kernels' times
     beside them;
  4x. a table that really is above 2^32 positions: a 4,096-block pattern
     tiled to 2^32 + 2^28 positions (4.6 GB of 256 B rows, packed on the
     card), K1w's occ within 5,000 of 2^32 and at random positions
     against a closed-form oracle and the plain version, K2w's steps
     on ranges that straddle 2^32 and one K1WX extend of parents around
     2^32 against the plain version; K3w's (position, offset) output,
     its first LF steps at positions >= 2^32, on starts within 2^20 of
     2^32 on both sides whose walks end within 16 steps (the plain LF
     on the card picks them: a tiled table's LF can cycle), exactly, and
     timed over such starts across the whole table; K1w's single-query
     modes on ranges whose start - 1 and end lie on both sides of 2^32. (No text of
     4.3G bases is indexed: its suffix array on the host alone would
     outlast the script's time limit.)
  7. the public API at full size, on the phase-4 index, each part's
     launch counts reset before it and read after it: 7a, the index
     saved as an .awfmx artifact without its seed table and loaded on the
     card (K1X rebuilds the table in 5 launches, torch.equal to phase
     4's; a DigramSearchEngine over it gives phase 4's counts and hits),
     and the 1M-base index saved with its table, whose load launches no
     K1 and no K1X;
     7b, parallel_search_count / _locate of 65,536 25-mers and a
     KmerSearchList round equal to SearchEngine's; 7c, the retrying
     engine on phase 5's .awfmi with a RuntimeError injected on the
     first call (one retry, one reload, equal answers) and on the 64M
     index in shards of 2^18; 7d, the 64M text as 4 chunks of 2^24 bases
     (overlap 255) served by digram engines, equal to phase 4's answers
     and to the monolithic engine on 25-mers across each boundary, with
     build and q/s beside the monolithic engine's; 7e, the query-parallel
     engine over two parts on the card (or every card), count, locate
     and count_replicated equal to phase 4's with K2 once a part and no
     range copied to the host before K3, and its count over the
     forced-wide view (K2w once a part); 7f, the single-query API over
     the wide view, the narrow one and the narrow one without pair rows:
     16 25-mers walked letter by letter by iterative_step_backward_search
     (K1's, K1w's step mode: one launch and one 16 B readback a step)
     equal to the engine's ranges, and
     backtrace_return_previous_letter_index (their LF mode by value)
     equal to the plain LF, the launches counted by mode; each view's
     calls timed on the host clock against the route before the step
     mode (the batched step over K1's occ mode on a one-element batch),
     in turns, beside the floor of a call (an empty launch and a 16 B
     readback) and the plain versions, and a torch.profiler trace of 16
     step and 16 LF calls that must show one K1 launch and one
     device-to-host copy a call and nothing else.
  8. the range-sharded engine on the phase-4 index: 8a, the route and
     K1R / K1Rw (occ mode, LF mode with the done rule, letter mode)
     against their plain versions (tolerance 0: the route's totals and
     its slices compared lane by lane, whatever order its atomics wrote
     them in), and each routed step against the JAX-literal masked sum
     (every shard on every lane, summed, the LF formed after the sum), on
     the index split into 2 and 4 shards of narrow block rows and 2 of
     compact wide rows, at crafted positions (every shard's first and last
     block, the zero padding, start - 1 at start == 0, past the table, bit
     39 set) and 2,097,152 random ones, the routed occ equal to K1 over
     the whole view; every part of a step timed (the route, each shard's
     launch, the whole step on one stream and through the engine's
     streams; occ over the 2,097,152 positions, LF over 1,048,576 lanes;
     the host time of a wrapper call); then a compact-row table tiled to
     2^32 + 2^28 positions (4.56 GB) whose milestones straddle 2^32:
     split at a block above 2^32, each shard's K1Rw against its plain
     version and the sum against a closed form, and split into two
     2.28 GB shards, beyond the L2, through the route, held and timed as
     above; 8b, RangeShardedSearchEngine over 2 and 4 shards on the one
     card (["cuda:0"] * n): count and locate of the 1,048,576 25-mers
     equal to phase 4's, the launch counts reset just before and read
     just after each (a count: 11 routes and 11 x n K1R launches; a
     locate adds the LF loop's, one route and n launches a step, and its
     routed lanes, each launched once), q/s beside SearchEngine's in the
     same process; 8c, the same over 2 shards of compact wide rows
     (K1Rw); 8d, plan_capacity over 4 devices for a corpus this card
     cannot hold, which must pick the range-sharded engine.
  4p. views without pair rows at full size (after phase 8, on phase 4's
     index, batch and answers): (a) to_device(device, pair_rows=False),
     whose seed table is the one the index already holds (device memory
     grows by far less than its 2.15 GB), 32 MB of block rows and no pair
     table; SearchEngine and DigramSearchEngine over it, count and locate
     of the 1,048,576 25-mers and the 4,096 multi-hit 11-mers equal to
     phase 4's, the launch counts reset just before and read just after
     (K2's and K4's block-row forms and K3; no pair-row K2 or K4); phase
     4's host-scan sample through the block-row engines at n = 2 and 3;
     K2 and K4 in both forms in turns at the main shapes, the block-row
     forms against their plain versions (K4 at n = 2 and 3), their window
     classes, bounds and calibrated rates, K4 over block rows (n = 2, 3;
     41-mers and their last 29 letters) and K2w compact on the
     window-class corpora of pairless_corpora, every class taken, and the
     API q/s beside phase 4's; the block rows' ceiling (K5's walk with 4
     lanes a chain, against its plain version, calibrated);
     the edges (pairless_edges): K3w compact on two 60,000-residue amino
     indexes at SA ratios 6 and 8 (0, 1, 33 hits, every position,
     1,000,003 random ones, the sentinel's row; SA resident and on disk)
     and K2 over block rows on 0, 1 and 33 queries, an unseeded batch and
     the DNA corpus (every class taken), each against its plain version. (b) A 2^26-residue random amino index
     (seed k = 5, ratio 8) as to_device(wide=True, pair_rows=False):
     K1WX's BFS over the 384 B rows, one launch of its BFS mode by the
     wrapper's counter, equal to the narrow table widened,
     SearchEngine's count and locate of 1,048,576 sampled 12-mers equal to
     the narrow amino engine's, 32 of them against a host scan, the
     single-query API
     (iterative_step_backward_search, backtrace_return_previous_letter_index)
     over 256 of them equal to the narrow answers, the launches read around
     all of it (by mode); K1w compact's single-query modes on crafted
     edges, and its calls timed and traced as in 7f; each compact form
     against its plain version (the BFS mode's k = 5 and k = 6 tables and
     the per-depth route's against the plain BFS, both k timed in turns,
     BFS mode against one launch a depth), and K2w and K3w against their
     pair-fused forms, in turns; the C launchers refuse a table of the
     other wide layout;
  9a. the multi-process front at full size: the 64M index saved as an
     .awfmx of its own; worlds of rank processes started by
     parallel/dist.py:spawn_ranks over a tcp:// rendezvous (this script
     with --rank-of), on a host of two or more cards one NCCL world of a
     card a rank, on one card two gloo ranks sharing cuda:0 (NCCL refuses
     two ranks on one card; gloo's collectives pass through host memory)
     and a one-rank NCCL world. Each rank loads the file on its card (K1X
     5 launches, read from the rank's launch counts), then over the
     narrow and the forced-wide view runs count_allgather on its half of
     phase 4's 1,048,576 25-mers (K2, K2w) and resolve_allgather on its
     half of their ranges' first positions (K3, K3w), a warm-up and a
     timed call each (each kernel launched exactly twice); every rank's
     merged counts and hits must equal phase 4's counts and the parent's
     SearchEngine.resolve_positions, exactly. Logged: each world's q/s
     beside phase 7e's, the all-gather of a half batch of int64 alone.
     A rank that exits nonzero or runs past 300 s fails the script after
     every rank is killed;
  9b. tools/scaling_report on the card (--platform cuda --hosts 2, 16M
     bases, 1,048,576 25-mers, seed k 14, rungs of 1 and 2 devices): every
     rung, the two-process one included, must have its row.

The last three lines are the card's name and power limit as nvidia-smi
prints them, one JSON object describing each kernel (its launches on the
path that runs it, phase 9a's ranks' launches included and also given
alone as rank_launches, its largest difference from the plain version,
its time, the plain version's, its bound and, where one PyTorch call
computes the same function, that call's), and the result line {"ok": true,
"device": {...}}. The bound is the larger of the bytes the call must
move, each read or written once (the table rows it touches, counted as
the expected number of distinct rows under uniformly random visits, at
the bytes a visit of its window class needs; the batch's inputs and
outputs), over the published 3.35 TB/s, and its integer operations over
67 TOP/s (the published float32 rate outside the tensor cores stands in:
the data sheet gives no integer rate). K5's and K6's row describes the
entry one PyTorch call computes too (the ring reduce, the single slab
gather; K5's ms is device time with the queue kept full, K6's ms and
library_ms are the graph-replay pair); their walk
and chain at the calibration shapes are compared and timed in phase 6
and logged there. K1's single-query modes have entries of their own
(k1_rank.step, k1_rank.lf_at, and K1w's and K1w compact's): their ms is
the host time of an API call on its path (7f, 4p), their plain_ms the
plain version's, their bound the bytes of one or two row visits, beside
floor_ms (an empty launch and a 16 B readback) and device_ms (the
kernel in a profiler trace). So has K1WX's BFS mode over compact rows
(k1w_extend_compact.bfs: phase 4p(b)'s k = 5 table in one launch; its
bound streams that table alone, the levels between lying in its scratch),
beside k1w_extend_compact, whose ms is now the per-depth route's k = 5
BFS (one launch a depth). Two looser models of each index kernel are logged and
kept out of that line: every visit's row sectors over the same 3.35 TB/s
(the stages' roofline), and every visit the kernel makes at a rate
measured in this process: its row visits at the calibrated random-row
rate of the table, and the seed-table visit of K2, K2w and K4 and the SA
visit of K3 and K3w at the time of a launch that makes those visits and
no step.
--bases (default 64,000,000) is for local trials only.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_SEED_K = 14
KMER_LEN = 25
QUERIES = 1 << 20
CHUNK_BASES = 1 << 24  # phase 7d: 4 chunks of the 64M text
MULTIHIT_LEN = 11
MULTIHIT_QUERIES = 4096
BENCH_MULTIHIT_QUERIES = 1 << 19  # bench.py's multi-hit stage below 1G bases
EXACT = 0  # every quantity compared is an integer: tolerance 0
# the kernels each path launches: phase 4 (the main path, its build's
# seed-table BFS through K1X), phase 6 (the bench's calibration, and
# enumerate through locate_flat_device), phase 4w
# (the wide path, its BFS through K1WX) and phase 7f (the single-query
# API, K1's and K1w's step and LF-at modes), whose counts the kernels line
# reports
MAIN_PATH_KERNELS = ("k1_extend", "k1_extend.bfs", "k2_ranges", "k3_backtrace_resolve",
                     "k4_ngram_ranges")
BENCH_KERNELS = ("k5_gather_reduce", "k6_slab_gather", "k7_enumerate")
WIDE_PATH_KERNELS = ("k1w_extend", "k1w_extend.bfs", "k2w_ranges", "k3w_backtrace_resolve")
SINGLE_MODES = ("step", "lf_at")  # K1's single-query modes, entries of their own in the kernels line
RS_POSITIONS = 1 << 21  # phase 8a: random positions, a backward step's 2B at 1M queries
RS_LF_LANES = 1 << 20  # phase 8a: LF lanes, the backtrace's first step at 1M hits
RANK_TIMEOUT_S = 300  # phase 9a: a rank still running after this fails the script
# phase 4p: the kernels of the views without pair rows; (a) the narrow
# main path's, (b) the wide amino path's over compact rows
PAIRLESS_KERNELS = ("k2_ranges_block", "k4_ngram_ranges_block", "k3_backtrace_resolve")
COMPACT_KERNELS = ("k1w_extend_compact", "k1w_extend_compact.bfs", "k2w_ranges_compact",
                   "k3w_backtrace_resolve_compact", "k1w_rank_compact")
AMINO_RESIDUES = 1 << 26  # phase 4p(b): tools.kernel_ab's amino case, beyond the L2
AMINO_SEED_K = 5  # the amino default of tools/build_index.py
AMINO_BIG_SEED_K = 6  # phase 4p(b): the seed k an index of 2^32 positions and more would take
AMINO_KMER_LEN = 12
SINGLE_QUERY_WALKS = 256
PAIRLESS_CORPUS_SEED = 0x4C0  # phase 4p's window-class corpora (pairless_corpora)
PAIRLESS_AMINO_SEED_K = 3  # their amino index's seed k (20^3 entries)
PAIRLESS_SHORT_LEN = 29  # their K4 queries' last 29 letters: rows of 32 columns, letters in registers
EDGE_RESIDUES = 60_000  # phase 4p's edge indexes (pairless_edges)
EDGE_HITS = 1_000_003  # their random hits: more than the card holds at once, no multiple of a block
HOST_SAMPLE = 32  # phase 4p: amino queries checked against a host scan (phase 4 samples 32 too)
# the rank, range and backtrace kernels of each width
INDEX_KERNELS = ("k1_rank", "k2_ranges", "k3_backtrace_resolve")
WIDE_INDEX_KERNELS = ("k1w_rank", "k2w_ranges", "k3w_backtrace_resolve")
HBM_BYTES_PER_S = 3.35e12  # published, H100 SXM
OPS_PER_S = 67e12  # published float32 rate outside the tensor cores (no integer rate is published)
T_START = time.time()
BENCH_SUMMARY_KEYS = (
    "count_qps", "count_ngram_qps", "locate_first_hit_qps", "locate_all_qps",
    "locate_all_dense_sa_qps", "multihit_qps", "gather_rates_rows_per_sec",
)


def log(msg: str) -> None:
    print(msg, flush=True)


def mark(phase: str) -> None:
    log(f"[t] {phase} done at {time.time() - T_START:.1f}s")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def count_overlapping(hay: bytes, needle: bytes) -> int:
    """Exact overlapping occurrence count (host oracle)."""
    n = 0
    i = hay.find(needle)
    while i != -1:
        n += 1
        i = hay.find(needle, i + 1)
    return n


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of fn on the card (CUDA events, one warm-up)."""
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


def device_ms(fn, reps: int, cycles_per_call: int = 1_000_000) -> float:
    """Mean device milliseconds per call of fn (one warm-up): the card is
    kept busy by ``torch.cuda._sleep`` while the host enqueues the calls,
    so no host time lies between two of them (a wrapper's host work can
    exceed its kernel's time, and ``cuda_ms`` then measures the host).
    Warns when the host outlasted the sleep."""
    import torch

    fn()
    torch.cuda.synchronize()
    s0, t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    s0.record()
    torch.cuda._sleep(reps * cycles_per_call)
    t0.record()
    host = time.perf_counter()
    for _ in range(reps):
        fn()
    host = (time.perf_counter() - host) * 1e3
    t1.record()
    torch.cuda.synchronize()
    if host > s0.elapsed_time(t0):
        log(f"  device_ms: the host took {host:.3f} ms to enqueue, the sleep "
            f"{s0.elapsed_time(t0):.3f}: host time may be in this number")
    return t0.elapsed_time(t1) / reps


def graph_ms(fn, launches: int = 20, replays: int = 20) -> float:
    """Device milliseconds per call of fn: ``launches`` calls captured in
    one CUDA graph on a side stream and replayed, so that no host work
    lies between two launches. fn must allocate nothing."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, replays) / launches


def time_in_turns(label: str, kernel_fn, plain_fn, kernel_reps: int, plain_reps: int,
                  kernel_timer=cuda_ms):
    """(kernel ms, plain ms), each the best of two runs taken in turns:
    plain, kernel, kernel, plain; the kernel's by ``kernel_timer``."""
    p1 = cuda_ms(plain_fn, plain_reps)
    k1 = kernel_timer(kernel_fn, kernel_reps)
    k2 = kernel_timer(kernel_fn, kernel_reps)
    p2 = cuda_ms(plain_fn, plain_reps)
    log(f"  {label} time: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    return min(k1, k2), min(p1, p2)


def timed_engine_call(fn, kmers, runs: int = 3):
    """(last result, median seconds, the runs' seconds) of ``fn(kmers)``
    after a warm-up on the first 4,096, as phase 4 times its engines."""
    import numpy as np
    import torch

    fn(kmers[:4096])
    times, out = [], None
    for _ in range(runs):
        t = time.time()
        out = fn(kmers)
        torch.cuda.synchronize()
        times.append(time.time() - t)
    return out, float(np.median(times)), times


def flat_hits(hits):
    """(hits per query, every hit in one uint64 array) of a locate."""
    import numpy as np

    lens = np.array([len(h) for h in hits])
    return lens, (np.concatenate(hits) if len(hits) else np.empty(0)).astype(np.uint64)


def forms_in_turns(label: str, fns: dict, reps: int = 10) -> dict:
    """Milliseconds of each of two forms of a kernel on the same inputs,
    in turns (first, second, second, first): {form: [ms, ms]}."""
    names = list(fns)
    ms = {n: [] for n in names}
    for n in names + names[::-1]:
        ms[n].append(cuda_ms(fns[n], reps))
    log(f"  {label}: " + "; ".join(f"{n} {v[0]:.4f} / {v[1]:.4f} ms" for n, v in ms.items()))
    return ms


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (0 when equal)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


def expect_launches(tag: str, names, exact=None) -> dict:
    """The launch counts since the last reset; fails when a kernel of
    ``names`` was not launched, or launched other than ``exact[name]``
    times."""
    from avxwindowfmindex_tpu_torch.ops import kernels

    launches = kernels.launch_counts()  # K1's forms also by mode: "k1_rank.step"
    log(f"[{tag}] launches: { {n: c for n, c in launches.items() if c} }")
    missing = [n for n in names if launches.get(n, 0) <= 0]
    if missing:
        raise AssertionError(f"[{tag}] never launched {missing}")
    for name, want in (exact or {}).items():
        if launches.get(name, 0) != want:
            raise AssertionError(f"[{tag}] launched {name} {launches.get(name, 0)} times, "
                                 f"not {want}")
    return launches


def single_edges(rec: "Record", dev, rng, tag: str, sentinel_pos=None, around=()) -> None:
    """K1's single-query modes on the view ``dev`` (its form: K1, K1w or K1w
    compact) against their plain versions on the same arguments, packed by
    ``rank.step_args``: steps of crafted ranges (start 0, whose start - 1
    wraps; end = bwtLength - 1; end < start; ends one block apart; positions
    past the table and, for ``around``, on both sides of 2^32) by every
    letter of the alphabet, the ambiguity and sentinel letters and letters
    beyond the table (32, 255, 256, -1, 2^40), and the LF by value at the
    same positions and the sentinel's (``sentinel_pos``). Tolerance 0."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels, rank

    kname = kernels.form_of(dev, kernels.K1).name
    n, card = dev.bwt_length, dev.cardinality
    beyond = [2**32 - 1, 2**32, 2**40 + 5, 2**63, 2**64 - 1] if dev.wide else [2**32 - 1, 2**32 + 5, -1]
    pts = [0, 1, 7, 8, 255, 256, 257, n - 2, n - 1, n, n + 300, *beyond, *around]
    pts += [int(p) for p in rng.integers(0, n, 4)]
    letters = [*range(card + 2), card + 2, 31, 32, 255, 256, 1000, -1, 2**31, 2**40]
    ranges = [(s, e) for s in pts for e in (s - 1, s, s + 255, s + 256, n - 1)]
    ranges += [(0, n - 1), (0, 0), (n - 1, 0), (300, 20)]
    calls = [(s, e, letters[i % len(letters)]) for i, (s, e) in enumerate(ranges)]
    calls += [(s, e, lett) for s, e in ranges[:: max(1, len(ranges) // 12)] for lett in letters]
    # the plain versions (rank.step_plain, rank.lf_at_plain) row for row,
    # as one batched call of the same plain step and LF
    as_t = lambda v: torch.tensor([rank.int64_of(x) for x in v], dtype=torch.int64,
                                  device=dev.device)
    args = [rank.step_args(dev, s, e, lett) for s, e, lett in calls]
    got = [w for a in args for w in kernels.k1_step(dev, *a)]
    ws, we = rank.backward_step(dev, *(as_t(col) for col in zip(*args)), check_valid=False,
                                occurrence_fn=rank.occurrence_plain)
    want = torch.stack([ws & dev.pos_mask, we & dev.pos_mask], dim=1).reshape(-1)
    rec.compare(f"{kname}.step", f"{tag} crafted steps x{len(calls)}", as_t(got), want)
    mask = rank.word_mask(dev)
    lf_pts = [p & mask for p in pts + ([] if sentinel_pos is None else [sentinel_pos])]
    got = [w for p in lf_pts for w in kernels.k1_lf_at(dev, p)]
    lett, lf = rank.letter_and_lf_plain(dev, as_t(lf_pts))
    rec.compare(f"{kname}.lf_at", f"{tag} crafted LF positions x{len(lf_pts)}", as_t(got),
                torch.stack([lett, lf], dim=1).reshape(-1))


def single_query_calls(rec: "Record", index, kw: dict, walks, lf_pos, device: str, tag: str,
                       record: bool = True) -> dict:
    """The single-query API on the view ``kw`` names, installed on ``index``
    (its launches already checked): (1) the median host us of a call of
    ``iterative_step_backward_search`` and of
    ``backtrace_return_previous_letter_index`` over the walks, against the
    route before K1's step mode (``tools.kernel_ab.occ_route_step`` /
    ``occ_route_lf``: the batched step over K1's occ mode on a one-element
    batch) in turns, old, new, new, old, with equal answers, and the floor
    of a call (an empty launch and a 16 B readback) beside each turn; the
    plain versions a call; (2) a ``torch.profiler`` trace of 16 step calls
    and of 16 LF calls, which must show one K1 kernel of the view's form and
    one device-to-host copy a call and no other kernel and no host-to-device
    copy (a trace without device activity fails). With ``record``, the
    form's ``.step`` and ``.lf_at`` entries of the kernels line take these
    times and bounds."""
    import numpy as np
    import avxwindowfmindex_tpu_torch as pt
    from avxwindowfmindex_tpu_torch.models import alphabet as alpha
    from avxwindowfmindex_tpu_torch.ops import kernels, rank
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import (
        floor_us, occ_route_lf, occ_route_step, trace_calls, walk_calls)

    kw = dict(device=device, **kw)
    dev = index.to_device(**kw)
    kname = kernels.form_of(dev, kernels.K1).name
    new = (pt.iterative_step_backward_search, pt.backtrace_return_previous_letter_index)
    old = (occ_route_step, occ_route_lf)

    def plain_step(ix, s, e, lett, **k):
        view = ix.to_device(**k)
        return rank.step_plain(view, *rank.step_args(view, s, e, lett))

    def plain_lf(ix, p, **k):
        view = ix.to_device(**k)
        lett, lf = rank.lf_at_plain(view, p & rank.word_mask(view))
        return (0, p) if lett == view.sentinel else (lett, lf)

    routes = {"occ route": old, "step mode": new}
    for fns in routes.values():  # warm-up
        walk_calls(index, walks[:1], lf_pos[:1], kw, *fns)
    us = {name: {"step": [], "lf": []} for name in routes}
    floors, want = [], None
    for name in ["occ route", "step mode", "step mode", "occ route"]:
        st, lt, got = walk_calls(index, walks, lf_pos, kw, *routes[name])
        if want is None:
            want = got
        elif got != want:
            raise AssertionError(f"[{tag}] the {name}'s answers differ from the occ route's")
        us[name]["step"].append(float(np.median(st)))
        us[name]["lf"].append(float(np.median(lt)))
        floors.append(floor_us(dev, len(st) + len(lt)))
    pst, plt, got = walk_calls(index, walks[:2], lf_pos[:16], kw, plain_step, plain_lf)
    if got != want[:2] + want[len(walks):len(walks) + 16]:
        raise AssertionError(f"[{tag}] the plain single-query versions differ")
    plain = {"step": float(np.median(pst)), "lf": float(np.median(plt))}
    trace_dir = os.path.join(REPO, "avxwindowfmindex_tpu_torch", "build", "traces")
    steps16, ps = [], [int(c) for c in index.prefix_sums]  # the walks' first 16 steps
    for q in walks:
        letters = alpha.ascii_to_index(np.frombuffer(q, np.uint8), index.alphabet).tolist()
        s, e = ps[letters[-1]], ps[letters[-1] + 1] - 1
        for lett in reversed(letters[:-1]):
            steps16.append((s, e, lett))
            s, e = new[0](index, s, e, lett, **kw)
        if len(steps16) >= 16:
            break
    steps16 = steps16[:16]
    tr = trace_calls(lambda: ([new[0](index, *args, **kw) for args in steps16],
                              [new[1](index, p, **kw) for p in lf_pos[:16]]),
                     trace_dir, f"{tag}-{kname}".replace(" ", "_"))
    if not tr["kernels"] and not tr["dtoh"]:
        raise AssertionError(f"[{tag}] the profiler saw no device activity")
    found = {mode: {k: v for k, v in tr["kernels"].items() if f"k1_{mode}_kernel" in k}
             for mode in ("step", "lf_at")}
    launches = {mode: sum(c for c, _ in ks.values()) for mode, ks in found.items()}
    others = sum(c for c, _ in tr["kernels"].values()) - sum(launches.values())
    if (launches != {"step": 16, "lf_at": 16} or others or tr["dtoh"] != 32 or tr["htod"]
            or tr["other_copies"]):
        raise AssertionError(f"[{tag}] 16 step and 16 LF calls traced {tr}: not one K1 launch "
                             f"and one device-to-host copy a call alone")
    device_us = {mode: sum(d for _, d in found[key].values()) / 16
                 for mode, key in (("step", "step"), ("lf", "lf_at"))}
    log(f"[{tag}] profiler, 16 step and 16 LF calls: {launches['step']} + {launches['lf_at']} "
        f"{kname} launches ({device_us['step']:.2f} / {device_us['lf']:.2f} us each), "
        f"{tr['dtoh']} device-to-host copies, no other kernel, no host-to-device copy")
    for mode, word in (("step", "step"), ("lf", "LF")):
        log(f"[{tag}] {word} call, host us (median a call, in turns): occ route "
            f"{us['occ route'][mode][0]:.2f} / {us['occ route'][mode][1]:.2f}, step mode "
            f"{us['step mode'][mode][0]:.2f} / {us['step mode'][mode][1]:.2f}; floor "
            f"{min(floors):.2f}-{max(floors):.2f}; plain {plain[mode]:.2f}; device "
            f"{device_us[mode]:.2f}")
    if record:
        nb, np_, ms_b = dev.num_blocks, dev.n_planes, dev.milestone_bytes
        for mode, suffix, visits in (("step", "step", 2), ("lf", "lf_at", 1)):
            name = f"{kname}.{suffix}"
            rec.ms[name] = (min(us["step mode"][mode]) / 1e3, plain[mode] / 1e3)
            rec.set_bound(name, [(nb, np_ * 32 + ms_b, visits)], ms_b + 16,
                          visits * rank_ops(np_))
            rec.bound[name]["floor_ms"] = min(floors) / 1e3
            rec.bound[name]["device_ms"] = device_us[mode] / 1e3
    return {"us": us, "floor_us": floors, "plain_us": plain, "device_us": device_us}


class Record:
    """Per-kernel comparison results and main-shape timings."""

    def __init__(self):
        self.err = {}
        self.ms = {}
        self.bound = {}
        self.model = {}  # logged only: row traffic and visits per table
        self.fixed = {}  # logged only: the visits that are no row visits (zero_step_costs)
        self.library = {}
        self.k6 = {}  # K6's single gather and index_select, per call and by graph replay

    def set_bound(self, kernel: str, tables, stream_bytes: int, ops: float,
                  row_visits=None, other_visits=None) -> None:
        """The least time the card could take for the launch timed in
        ``ms[kernel]``. ``tables``: one (rows in the table, bytes a visit
        needs, visits) per table read and per part of its rows that only
        some visits need; ``stream_bytes``: the batch's inputs and
        outputs, each once; ``row_visits``: row visits by calibrated
        table, for the logged model (default: those of ``tables``);
        ``other_visits``: its visits to tables that are no row tables
        (the seed table, the sampled SA), whose bytes ``stream_bytes``
        counts and whose time the model takes from ``zero_step_costs``."""
        once = float(stream_bytes)
        traffic = float(stream_bytes)
        for nb, need, visits in tables:
            once += nb * (1.0 - math.exp(-visits / nb)) * need
            traffic += visits * (-(-need // 32) * 32)
        bytes_ms = once / HBM_BYTES_PER_S * 1e3
        ops_ms = ops / OPS_PER_S * 1e3
        self.bound[kernel] = {
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        }
        self.model[kernel] = {
            "bytes_once": int(once), "operations": int(ops),
            "row_traffic_ms": traffic / HBM_BYTES_PER_S * 1e3,
            "row_visits": row_visits or [int(v) for _, _, v in tables],
            "other_visits": other_visits or {},
        }
        log(f"  {kernel} bound: {json.dumps({**self.bound[kernel], **self.model[kernel]})}")

    def compare(self, kernel: str, what: str, got, want) -> None:
        err = max_abs_err(got, want)
        log(f"  {kernel} {what}: max_abs_err={err} over {got.numel()} values")
        if err > EXACT:
            raise AssertionError(f"{kernel} disagrees with its plain version ({what})")
        self.err[kernel] = max(self.err.get(kernel, 0), err)


def match_ops(n_planes: int, words: int) -> int:
    """Integer operations that form ``words`` 32-bit match words: an xor
    and an or per plane, then a not."""
    return words * (2 * n_planes + 1)


def count_ops(words: int) -> int:
    """Integer operations of one inclusive count over ``words`` match
    words: mask select, and, popcount, add."""
    return words * 4


def rank_ops(n_planes: int) -> int:
    """One rank from a block's 8 match words: one match, one count."""
    return match_ops(n_planes, 8) + count_ops(8)


def pair_step_ops(n_planes: int, words: int = 16) -> int:
    """One backward step inside the window: the pair row's 16 match words
    (8 when both ends lie in the first block) are formed once and counted
    twice (start and end)."""
    return match_ops(n_planes, words) + 2 * count_ops(words)


def step_tables(nb: int, n_planes: int, ms_bytes: int, classes):
    """(table entries for ``Record.set_bound``, integer operations) of
    backward steps over a table of ``nb`` pair rows with ``n_planes``
    planes 64 B apart, ``classes`` = steps in (first block, pair window,
    two rows). Every step needs the first 32 B of each plane and one
    milestone of its row (a two-row step of two rows); a pair-window
    step the planes' second halves too."""
    first, window, two = (int(c) for c in classes)
    tables = [(nb, n_planes * 32 + ms_bytes, first + window + 2 * two),
              (nb, n_planes * 32, window)]
    ops = (first * pair_step_ops(n_planes, 8) + window * pair_step_ops(n_planes)
           + two * 2 * rank_ops(n_planes))
    return tables, ops


def class_shares(classes) -> str:
    total = max(int(sum(classes)), 1)
    return ", ".join(f"{name} {int(c)} ({int(c) / total:.5f})" for name, c in
                     zip(("first block", "pair window", "two rows"), classes))


def window_class_corpus(rng, alphabet=None):
    """(text, K2 queries, K4 41-mers): runs of one letter (700 A, 300 C,
    420 G) inside random text of ``alphabet`` (default DNA), so that at
    seed k = 6 the steps of queries from the runs sit in the pair-window
    and two-row classes and those of random windows in the first block."""
    import numpy as np
    from avxwindowfmindex_tpu_torch import AlphabetType

    def rand(n):
        return random_text(rng, n, alphabet or AlphabetType.DNA).upper()

    text = rand(2500) + b"A" * 700 + rand(2500) + b"C" * 300 + rand(1500) + b"G" * 420 + rand(2000)
    runs = ((2500, 700), (5700, 300), (7500, 420))
    klen = 41
    starts = [lo for lo, _ in runs]
    for lo, length in runs:  # windows across the end of each run
        starts += list(rng.integers(lo + length - klen, lo + length, 40))
    starts += list(rng.integers(0, len(text) - klen, 389))
    k4_qs = [text[s : s + klen] for s in starts]
    k2_qs = (k4_qs[:200] + [text[lo : lo + L] for lo, _ in runs for L in range(7, 40)]
             + [text[s : s + 14] for s in rng.integers(0, len(text) - 14, 256)])
    return text, k2_qs, k4_qs, klen


def pairless_corpora(seed: int = PAIRLESS_CORPUS_SEED):
    """Phase 4p's window-class corpora (``window_class_corpus``), which
    ``tests/test_torch_pairless.py`` shows reach every window class of each
    form on the CPU: (DNA text, its 41-mers, their length) for K4 over
    block rows at seed k = 6, and (amino text, its queries) for K2w over
    compact rows at seed k = ``PAIRLESS_AMINO_SEED_K``."""
    import numpy as np
    from avxwindowfmindex_tpu_torch import AlphabetType

    rng = np.random.default_rng(seed)
    text, _, k4_qs, klen = window_class_corpus(rng)
    aa_text, aa_qs, _, _ = window_class_corpus(rng, AlphabetType.AMINO)
    return text, k4_qs, klen, aa_text, aa_qs


def random_text(rng, n: int, alphabet) -> bytes:
    import numpy as np
    from avxwindowfmindex_tpu_torch import AlphabetType

    pool = b"ACDEFGHIKLMNPQRSTVWY" if alphabet == AlphabetType.AMINO else b"acgt"
    return rng.choice(np.frombuffer(pool, np.uint8), size=n).tobytes()


def crafted_parents(rng, dev):
    """(m, 2) parent ranges in the view's storage type on its device: what
    a BFS level holds and the edges of the block-index rule. Random
    narrow ranges, start == 0 (start - 1 wraps to the last row), absent
    start > end ranges, ranges whose start - 1 and end straddle a block
    boundary (valid and absent), both ends in one block, both on the last
    row, positions past the table; for a wide view also u64 positions no
    search produces (bit 39 set, 2^63, 2^64 - 1)."""
    import numpy as np
    from avxwindowfmindex_tpu_torch.models.index import u32_tensor, u64_tensor

    n, nb = dev.bwt_length, dev.num_blocks
    s = rng.integers(0, n + 1, size=4000).astype(np.uint64)
    ranges = [np.stack([s, s + rng.integers(0, 4, size=4000).astype(np.uint64)], axis=1)]
    fixed = [[0, 0], [0, 5], [0, n - 1], [1, 0], [n, n - 1], [256, 255], [255, 256],
             [257, 256], [n - 1, n - 1], [n, n], [nb * 256 - 1, nb * 256 + 7],
             [(nb - 1) * 256, n - 1], [7, 3], [300, 2], [2**31, 5], [2**32 - 1, 0],
             [1, 2**32 - 1]]
    if dev.wide:
        fixed += [[2**64 - 1, 0], [0, 2**64 - 1], [2**39 + 77, 2**40 + 5], [2**40 + 5, 3],
                  [2**63, 2**63 + 255], [2**32 + 1, 2**32 + 200]]
    ranges.append(np.array(fixed, dtype=np.uint64))
    b = rng.integers(1, nb, size=500).astype(np.uint64) * np.uint64(256)
    ranges.append(np.stack([b - np.uint64(3), b + np.uint64(2)], axis=1))
    ranges.append(np.stack([b + np.uint64(10), b - np.uint64(40)], axis=1))
    return (u64_tensor if dev.wide else u32_tensor)(np.concatenate(ranges), dev.device)


def bfs_mode_checks(rec: Record, entry: str, dev, index, ks, tag: str) -> None:
    """The BFS mode (``kernels.k1_seed_table``) against the plain BFS at
    each k of ``ks``: through ``build_seed_table`` (the form's threshold,
    ``seed_table.bfs_launches`` launches: the BFS mode's and one K1X launch a
    depth past it), and split by ``kernel_ab.split_seed_table`` with the
    whole table in the one launch and with depths 1-2 in it. Each table's
    launches are read from the wrappers' counters."""
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import split_seed_table

    card = dev.cardinality
    form = kernels.form_of(dev, kernels.K1X).name
    for k in ks:
        plain = seed_table.build_seed_table(dev, card, k, index.prefix_sums,
                                            occurrence_fn=rank.occurrence_plain)
        split = seed_table.bfs_depths(card, k, seed_table.bfs_max_parents(dev))
        builds = {split: lambda: seed_table.build_seed_table(dev, card, k, index.prefix_sums)}
        for steps in {k - 1, min(2, k - 1)} - {split}:
            builds[steps] = lambda steps=steps: split_seed_table(dev, k, steps, index.prefix_sums)
        for steps, build in sorted(builds.items()):
            before = kernels.launch_counts()
            got = build()
            after = kernels.launch_counts()
            launched = {key: after.get(key, 0) - before.get(key, 0) for key in (form, f"{form}.bfs")}
            want = {form: k - steps, f"{form}.bfs": 1}
            if launched != want:
                raise AssertionError(f"{tag}: the k={k} BFS with depths 1-{steps} in one launch "
                                     f"launched {launched}, not {want}")
            rec.compare(entry, f"{tag} k={k} BFS mode, depths 1-{steps} in one launch"
                        f"{' (the build)' if steps == split else ''} x{got.shape[0]}", got, plain)
        del plain, got


def phase_kernels(rec: Record, device: str, wide: bool = False):
    """Phase 3 (3w with ``wide``): each kernel against its plain torch
    version on the card; K1w, K2w and K3w on forced-wide views, K4 on the
    narrow ones only."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import (
        AlphabetType, IndexConfiguration, NgramSearchEngine, SearchEngine, create_index,
    )
    from avxwindowfmindex_tpu_torch import search
    from avxwindowfmindex_tpu_torch.ops import kernels, ngram, rank, seed_table

    rng = np.random.default_rng(7)
    kept = None
    tag = "3w" if wide else "3"
    k1, k2, k3 = WIDE_INDEX_KERNELS if wide else INDEX_KERNELS
    kx = "k1w_extend" if wide else "k1_extend"
    for alphabet, k, klen in ((AlphabetType.DNA, 10, 25), (AlphabetType.AMINO, 5, 12)):
        name = alphabet.name + (" wide" if wide else "")
        text = random_text(rng, 1_000_000, alphabet)
        t0 = time.time()
        index = create_index(text, IndexConfiguration(8, k, alphabet), sa_backend="native", device=device)
        torch.cuda.synchronize()
        log(f"[{tag}] {name}: 1M-base index (k={k}, ratio 8) built in {time.time() - t0:.2f}s")
        dev = index.to_device(device, wide=wide)
        if dev.wide != wide:
            raise AssertionError("to_device returned the other width")
        n = dev.bwt_length
        card = dev.cardinality

        # K1X (K1WX): every depth of the BFS and crafted parent tables
        # against the plain extend; the build's table (through K1X) against
        # the plain BFS
        table = seed_table.build_seed_table(dev, card, 1, index.prefix_sums)
        for depth in range(1, k):
            got = kernels.k1_extend(dev, table)
            table = seed_table.extend_level_plain(dev, table)
            rec.compare(kx, f"{name} BFS depth {depth} x{table.shape[0]}", got, table)
        if not torch.equal(table, dev.seed_table):
            raise AssertionError(f"{name}: the plain BFS differs from the build's seed table")
        del got, table
        parents = crafted_parents(rng, dev)
        rec.compare(kx, f"{name} crafted parents x{parents.shape[0]}",
                    kernels.k1_extend(dev, parents), seed_table.extend_level_plain(dev, parents))
        ragged = parents[:37].contiguous()
        rec.compare(kx, f"{name} crafted parents x37", kernels.k1_extend(dev, ragged),
                    seed_table.extend_level_plain(dev, ragged))
        # the BFS mode over this view's rows, at every k up to the index's
        bfs_mode_checks(rec, f"{kx}.bfs", dev, index, range(1, k + 1), f"[{tag}] {name}")
        if wide:
            # the view's table was widened from the narrow one; the BFS
            # through K1WX must give the same
            bfs = seed_table.build_seed_table(dev, card, k, index.prefix_sums)
            rec.compare(kx, f"{name} seed table k={k}: BFS through K1WX == widened", bfs,
                        dev.seed_table)
            del bfs

        # K1 occ mode: 1M random pairs, edge positions, a ragged batch
        # size, and positions no search produces (the block-index rule)
        b = 1_000_000
        pos = rng.integers(0, n, size=b)
        lett = rng.integers(0, card + 1, size=b)
        edges = np.array([0, 7, 8, 255, n - 1])
        beyond = [0xFFFFFFFF, -1, 2**40 + 5, -300, 2**39 + 77] if wide else [0xFFFFFFFF]
        pos = np.concatenate([pos, np.repeat(edges, card + 1), beyond])
        lett = np.concatenate([lett, np.tile(np.arange(card + 1), len(edges)), [0] * len(beyond)])
        pos_t = torch.from_numpy(pos.astype(np.int64)).to(device)
        lett_t = torch.from_numpy(lett.astype(np.int32)).to(device)
        rec.compare(
            k1, f"{name} occ x{len(pos)}",
            kernels.k1_occurrence(dev, pos_t, lett_t), rank.occurrence_plain(dev, pos_t, lett_t),
        )
        lpos = torch.from_numpy(np.concatenate([rng.integers(0, n, size=b), edges])).to(device)
        kl, kf = kernels.k1_letter_and_lf(dev, lpos)
        pl, pf = rank.letter_and_lf_plain(dev, lpos)
        rec.compare(k1, f"{name} letter x{len(lpos)}", kl, pl)
        rec.compare(k1, f"{name} LF x{len(lpos)}", kf, pf)
        # K1's single-query modes, by value, on crafted ranges and letters
        single_edges(rec, dev, rng, f"[{tag}] {name}", sentinel_pos=int(
            np.flatnonzero(index.bwt_letters == index.sentinel_index)[0]))

        # K2: 64K seeded queries and 4K unseeded ones (short or ambiguous)
        eng = SearchEngine(index, device=device, wide=wide)
        starts = rng.integers(0, len(text) - klen, size=1 << 16)
        seeded_q = [text[s : s + klen] for s in starts]
        short = [text[s : s + int(rng.integers(1, k))] for s in rng.integers(0, len(text) - k, 3072)]
        amb = b"X" if alphabet == AlphabetType.AMINO else b"n"
        ambig = [text[s : s + klen - 1] + amb for s in rng.integers(0, len(text) - klen, 1024)]
        k2_in = {}
        for label, qs in (("seeded", seeded_q), ("unseeded", short + ambig)):
            mat, lengths, _ = eng.encode_kmers(qs)
            seeded = eng._seed_eligibility(mat, lengths)
            if label == "seeded" and not seeded.all():
                raise AssertionError("sampled queries must all be seed-eligible")
            args = (
                torch.from_numpy(mat).to(device),
                torch.from_numpy(lengths).to(device),
                torch.from_numpy(seeded.astype(np.uint8)).to(device),
            )
            ks, ke = kernels.k2_ranges(dev, *args)
            ps, pe = search.ranges_plain(dev, *args)
            rec.compare(k2, f"{name} {label} start x{len(qs)}", ks, ps)
            rec.compare(k2, f"{name} {label} end x{len(qs)}", ke, pe)
            k2_in[label] = args

        # K3: 256K positions, SA resident and SA on disk
        bpos = torch.from_numpy(rng.integers(0, n, size=1 << 18)).to(device)
        rec.compare(
            k3, f"{name} hits x{bpos.numel()}",
            kernels.k3_backtrace_resolve(dev, bpos), search.backtrace_resolve_plain(dev, bpos),
        )
        disk = dataclasses.replace(dev, sampled_sa=None)
        kp, ko = kernels.k3_backtrace_resolve(disk, bpos)
        pp, po = search.backtrace_resolve_plain(disk, bpos)
        rec.compare(k3, f"{name} on-disk p", kp, pp)
        rec.compare(k3, f"{name} on-disk off", ko, po)

        # K2, what two lanes a query and letters held in registers could
        # break: seeded and unseeded queries mixed in one odd-sized batch,
        # every length from 1 to the matrix's width, and matrices wider
        # than the registers hold (33-64 letters, then more)
        mixed = seeded_q[:1500] + short[:700] + ambig[:300]
        mixed = [mixed[i] for i in rng.permutation(len(mixed))]
        by_len = [text[s : s + L] for L in range(1, 29) for s in rng.integers(0, len(text) - 80, 24)]
        long_q = [text[s : s + int(L)] for s, L in zip(rng.integers(0, len(text) - 80, 600),
                                                        rng.integers(1, 71, 600))]
        for label, qs, odd in (("mixed", mixed, 2499), ("lengths 1-28", by_len, 671),
                               ("lengths to 44", [q[:44] for q in long_q], 599),
                               ("lengths to 70", long_q, 597)):
            mat, lengths, _ = eng.encode_kmers(qs)
            seeded = eng._seed_eligibility(mat, lengths)
            args = (
                torch.from_numpy(mat[:odd]).to(device),
                torch.from_numpy(lengths[:odd]).to(device),
                torch.from_numpy(seeded[:odd].astype(np.uint8)).to(device),
            )
            if label == "mixed" and not 0 < int(seeded[:odd].sum()) < odd:
                raise AssertionError("the mixed batch must hold seeded and unseeded queries")
            ks, ke = kernels.k2_ranges(dev, *args)
            ps, pe = search.ranges_plain(dev, *args)
            rec.compare(k2, f"{name} {label} (l_pad {mat.shape[1]}) start x{odd}", ks, ps)
            rec.compare(k2, f"{name} {label} (l_pad {mat.shape[1]}) end x{odd}", ke, pe)
            k2_in[f"{label} (l_pad {mat.shape[1]}) x{odd}"] = args

        if not wide:
            # K2 over block rows: the same view without its pair table, on
            # every batch above, equal to its plain version and to K2
            block = dataclasses.replace(dev, packed_pair=None)
            for label, args in k2_in.items():
                ks, ke = kernels.k2_ranges(block, *args)
                ps, pe = search.ranges_plain(block, *args)
                rec.compare("k2_ranges_block", f"{name} {label} start", ks, ps)
                rec.compare("k2_ranges_block", f"{name} {label} end", ke, pe)
                ws, we = kernels.k2_ranges(dev, *args)
                if not (torch.equal(ks, ws) and torch.equal(ke, we)):
                    raise AssertionError(f"{name} {label}: K2 over block rows differs from K2")
            del block

        # K3, what a grid that hands out hits could break: every position
        # of the index (more hits than the grid holds at once, the
        # sentinel's row among them), walks of 0 steps only, fewer hits
        # than a warp has lanes, and a ratio that is no power of two
        every = torch.arange(n, dtype=torch.int64, device=device)
        sampled = (bpos // dev.ratio) * dev.ratio
        odd_ratio = create_index(text[:200_000], IndexConfiguration(3, k, alphabet), device=device)
        odd_dev = odd_ratio.to_device(device, wide=wide)
        odd_pos = torch.arange(odd_dev.bwt_length, dtype=torch.int64, device=device)
        for label, view, positions in (
            ("every position", dev, every), ("0-step walks", dev, sampled),
            ("19 hits", dev, bpos[:19].contiguous()), ("1 hit", dev, bpos[:1].contiguous()),
            ("ratio 3, every position", odd_dev, odd_pos),
        ):
            rec.compare(k3, f"{name} {label} hits x{positions.numel()}",
                        kernels.k3_backtrace_resolve(view, positions),
                        search.backtrace_resolve_plain(view, positions))
            on_disk = dataclasses.replace(view, sampled_sa=None)
            kp, ko = kernels.k3_backtrace_resolve(on_disk, positions)
            pp, po = search.backtrace_resolve_plain(on_disk, positions)
            rec.compare(k3, f"{name} {label} on-disk p", kp, pp)
            rec.compare(k3, f"{name} {label} on-disk off", ko, po)
            if label == "0-step walks" and int(ko.max()) != 0:
                raise AssertionError("the sampled positions must need no LF step")
        del every, odd_ratio, odd_dev, odd_pos

        if wide and alphabet == AlphabetType.AMINO:
            compact_forms(rec, name, index, k, pos_t, lett_t, lpos, k2_in, bpos, device)

        if wide:
            # the wide engine's answers are the narrow engine's
            sub = seeded_q[:4096] + short[:512]
            narrow = SearchEngine(index, device=device, wide=False)
            if not (eng.count(sub) == narrow.count(sub)).all():
                raise AssertionError(f"{name}: wide counts differ from the narrow engine's")
            if not all((a == b).all() for a, b in zip(eng.locate(sub), narrow.locate(sub))):
                raise AssertionError(f"{name}: wide locates differ from the narrow engine's")
            log(f"  {name}: count and locate of {len(sub)} queries equal the narrow engine's")
            if alphabet == AlphabetType.DNA:
                occ_pos, occ_lett = pos_t[:b], lett_t[:b]
                time_in_turns(k1, lambda: kernels.k1_occurrence(dev, occ_pos, occ_lett),
                              lambda: rank.occurrence_plain(dev, occ_pos, occ_lett), 20, 3)
                time_in_turns(k2, lambda: kernels.k2_ranges(dev, *k2_in["seeded"]),
                              lambda: search.ranges_plain(dev, *k2_in["seeded"]), 20, 3)
                time_in_turns(k3, lambda: kernels.k3_backtrace_resolve(dev, bpos),
                              lambda: search.backtrace_resolve_plain(dev, bpos), 20, 3)
        elif alphabet == AlphabetType.DNA:
            kept = (index, text)
            # K4: the 64K seeded 25-mers through n = 2 and 3 tables, biased
            # and not; each also equals the single-step K2 ranges
            k4_mat = k2_in["seeded"][0]
            k2_s, k2_e = kernels.k2_ranges(dev, *k2_in["seeded"])
            k4_tables = {}
            for n_gram in (2, 3):
                for biased in (True, False):
                    ng = ngram.build_ngram_device(index, n_gram, device=device, bias_cn=biased)
                    what = f"{name} n={n_gram} {'biased' if biased else 'unbiased'}"
                    ks, ke = kernels.k4_ngram_ranges(dev, ng, k4_mat, klen)
                    ps, pe = search.ngram_ranges_plain(dev, ng, k4_mat, klen)
                    rec.compare("k4_ngram_ranges", f"{what} start x{len(seeded_q)}", ks, ps)
                    rec.compare("k4_ngram_ranges", f"{what} end x{len(seeded_q)}", ke, pe)
                    if not (torch.equal(ks, k2_s) and torch.equal(ke, k2_e)):
                        raise AssertionError(f"K4 ({what}) ranges differ from K2's")
                    if biased:
                        k4_tables[n_gram] = ng
            # kernel and plain times at these shapes, in turns
            occ_pos, occ_lett = pos_t[:b], lett_t[:b]
            timings = {
                "k1_rank": (
                    lambda: kernels.k1_occurrence(dev, occ_pos, occ_lett),
                    lambda: rank.occurrence_plain(dev, occ_pos, occ_lett),
                ),
                "k2_ranges": (
                    lambda: kernels.k2_ranges(dev, *k2_in["seeded"]),
                    lambda: search.ranges_plain(dev, *k2_in["seeded"]),
                ),
                "k3_backtrace_resolve": (
                    lambda: kernels.k3_backtrace_resolve(dev, bpos),
                    lambda: search.backtrace_resolve_plain(dev, bpos),
                ),
            }
            for n_gram, ng in k4_tables.items():
                timings[f"k4_ngram_ranges n={n_gram} biased"] = (
                    lambda ng=ng: kernels.k4_ngram_ranges(dev, ng, k4_mat, klen),
                    lambda ng=ng: search.ngram_ranges_plain(dev, ng, k4_mat, klen),
                )
            for kname, (kfn, pfn) in timings.items():
                time_in_turns(kname, kfn, pfn, 20, 3)

    # K2 on the pair-window overflow corpus: seeded ranges span > 512
    text = b"A" * 4000 + random_text(rng, 20_000, AlphabetType.DNA).upper()
    index = create_index(text, IndexConfiguration(8, 6, AlphabetType.DNA), device=device)
    dev = index.to_device(device, wide=wide)
    eng = SearchEngine(index, device=device, wide=wide)
    qs = [b"A" * L for L in range(6, 40)] + [text[s : s + 14] for s in rng.integers(0, 3990, 512)]
    mat, lengths, _ = eng.encode_kmers(qs)
    seeded = eng._seed_eligibility(mat, lengths)
    args = (
        torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
        torch.from_numpy(seeded.astype(np.uint8)).to(device),
    )
    ks, ke = kernels.k2_ranges(dev, *args)
    ps, pe = search.ranges_plain(dev, *args)
    rec.compare(k2, "overflow corpus start", ks, ps)
    rec.compare(k2, "overflow corpus end", ke, pe)
    widest = int((search.range_counts(ks, ke)).max())
    if widest <= 512:
        raise AssertionError(f"overflow corpus produced no range wider than 512 ({widest})")
    counts = eng.count(qs[:34])
    want = [count_overlapping(text, q) for q in qs[:34]]
    if list(counts) != want:
        raise AssertionError(f"overflow corpus counts {list(counts)} != {want}")
    log(f"  overflow corpus: widest range {widest}, {len(qs)} queries exact")

    # the window-class corpus: K2's steps must take every class
    wc_text, k2_qs, k4_qs, wc_len = window_class_corpus(rng)
    wc_index = create_index(wc_text, IndexConfiguration(8, 6, AlphabetType.DNA), device=device)
    wc_dev = wc_index.to_device(device, wide=wide)
    wc_eng = SearchEngine(wc_index, device=device, wide=wide)
    mat, lengths, _ = wc_eng.encode_kmers(k2_qs)
    seeded = wc_eng._seed_eligibility(mat, lengths)
    args = (
        torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
        torch.from_numpy(seeded.astype(np.uint8)).to(device),
    )
    classes = torch.zeros(3, dtype=torch.int64, device=device)
    ks, ke = kernels.k2_ranges(wc_dev, *args)
    ps, pe = search.ranges_plain(wc_dev, *args, classes)
    rec.compare(k2, "window-class corpus start", ks, ps)
    rec.compare(k2, "window-class corpus end", ke, pe)
    log(f"  window-class corpus {k2}: {len(k2_qs)} queries exact; steps: {class_shares(classes.tolist())}")
    if min(classes.tolist()) < 1:
        raise AssertionError(f"{k2}: a window class was never taken: {classes.tolist()}")
    counts = wc_eng.count(k2_qs[200:299])
    want = [count_overlapping(wc_text, q) for q in k2_qs[200:299]]
    if list(counts) != want:
        raise AssertionError(f"window-class corpus counts {list(counts)} != {want}")
    if wide:
        return None

    # K2 over block rows on the same corpus (to_device(pair_rows=False)):
    # the window-class queries with short and ambiguous ones, seeded and
    # unseeded in one odd-sized batch; every class must be taken
    wc_block = wc_index.to_device(device, pair_rows=False)
    if wc_block.packed_pair is not None or wc_block.pair_rows:
        raise AssertionError("to_device(pair_rows=False) kept a pair table")
    short = [wc_text[s : s + int(rng.integers(1, 6))] for s in rng.integers(0, len(wc_text) - 6, 300)]
    ambig = [wc_text[s : s + 20] + b"n" for s in rng.integers(0, len(wc_text) - 21, 120)]
    mixed = k2_qs + short + ambig
    mixed = [mixed[i] for i in rng.permutation(len(mixed))]
    mat, lengths, _ = wc_eng.encode_kmers(mixed)
    seeded = wc_eng._seed_eligibility(mat, lengths)
    odd = len(mixed) - 1 if len(mixed) % 2 == 0 else len(mixed)
    args = (
        torch.from_numpy(mat[:odd]).to(device), torch.from_numpy(lengths[:odd]).to(device),
        torch.from_numpy(seeded[:odd].astype(np.uint8)).to(device),
    )
    if not 0 < int(seeded[:odd].sum()) < odd:
        raise AssertionError("the block-row batch must hold seeded and unseeded queries")
    classes = torch.zeros(3, dtype=torch.int64, device=device)
    ks, ke = kernels.k2_ranges(wc_block, *args)
    ps, pe = search.ranges_plain(wc_block, *args, classes)
    rec.compare("k2_ranges_block", f"window-class corpus start x{odd}", ks, ps)
    rec.compare("k2_ranges_block", f"window-class corpus end x{odd}", ke, pe)
    pks, pke = kernels.k2_ranges(wc_dev, *args)
    if not (torch.equal(ks, pks) and torch.equal(ke, pke)):
        raise AssertionError("window-class corpus: K2 over block rows differs from K2")
    log(f"  window-class corpus k2_ranges_block: {odd} queries ({int(seeded[:odd].sum())} seeded) "
        f"exact and equal to K2's; steps: {class_shares(classes.tolist())}")
    if min(classes.tolist()) < 1:
        raise AssertionError(f"k2_ranges_block: a window class was never taken: {classes.tolist()}")

    # K4 on the same corpus: one uniform batch of 40-mers, A x 40 and
    # windows that straddle the end of the A run. A final range wider than
    # 512 means every range before it was too, so the n-gram steps took
    # the two-row branch.
    qs = [b"A" * 40] + [text[s : s + 40] for s in rng.integers(3950, 4000, 511)]
    mat = torch.from_numpy(eng.encode_kmers(qs)[0]).to(device)
    want = [count_overlapping(text, q) for q in qs[:16]]
    for n_gram in (2, 3):
        for biased in (True, False):
            ng = ngram.build_ngram_device(index, n_gram, device=device, bias_cn=biased)
            what = f"overflow corpus n={n_gram} {'biased' if biased else 'unbiased'}"
            ks, ke = kernels.k4_ngram_ranges(dev, ng, mat, 40)
            ps, pe = search.ngram_ranges_plain(dev, ng, mat, 40)
            rec.compare("k4_ngram_ranges", f"{what} start x{len(qs)}", ks, ps)
            rec.compare("k4_ngram_ranges", f"{what} end x{len(qs)}", ke, pe)
            widest = int((search.range_counts(ks, ke)).max())
            if widest <= 512:
                raise AssertionError(f"{what}: no range wider than 512 ({widest})")
        counts = NgramSearchEngine(index, n_gram, device=device).count(qs[:16])
        if list(counts) != want:
            raise AssertionError(f"overflow corpus n={n_gram} counts {list(counts)} != {want}")
    log(f"  overflow corpus K4: widest range {widest} (two-row branch taken), {len(qs)} 40-mers exact")

    # K4 on it: 41-mers (35 letters beyond the seed: a tail step for n = 2
    # and for n = 3), every class for the n-gram steps of both n
    mat = torch.from_numpy(wc_eng.encode_kmers(k4_qs)[0]).to(device)
    want = [count_overlapping(wc_text, q) for q in k4_qs[:16]]
    for n_gram in (2, 3):
        for biased in (True, False):
            ng = ngram.build_ngram_device(wc_index, n_gram, device=device, bias_cn=biased)
            what = f"window-class corpus n={n_gram} {'biased' if biased else 'unbiased'}"
            classes = search.new_step_classes(device)
            ps, pe = search.ngram_ranges_plain(wc_dev, ng, mat, wc_len, classes)
            ks, ke = kernels.k4_ngram_ranges(wc_dev, ng, mat, wc_len)
            rec.compare("k4_ngram_ranges", f"{what} start x{len(k4_qs)}", ks, ps)
            rec.compare("k4_ngram_ranges", f"{what} end x{len(k4_qs)}", ke, pe)
            # a batch that ends inside a block and inside a lane group's warp
            ks, ke = kernels.k4_ngram_ranges(wc_dev, ng, mat[:501], wc_len)
            rec.compare("k4_ngram_ranges", f"{what} ragged start x501", ks, ps[:501])
            rec.compare("k4_ngram_ranges", f"{what} ragged end x501", ke, pe[:501])
            shares = {t: c.tolist() for t, c in classes.items()}
            log(f"  {what}: n-gram steps {class_shares(shares['ngram_pair'])}; "
                f"tail steps {class_shares(shares['pair'])}")
            if min(shares["ngram_pair"]) < 1 or sum(shares["pair"]) < 1:
                raise AssertionError(f"{what}: a window class was never taken: {shares}")
            # K4 with its tail steps over block rows: equal to its plain
            # version on the view without pair rows and to K4
            classes = search.new_step_classes(device)
            bs, be = search.ngram_ranges_plain(wc_block, ng, mat, wc_len, classes)
            ks, ke = kernels.k4_ngram_ranges(wc_block, ng, mat, wc_len)
            rec.compare("k4_ngram_ranges_block", f"{what} start x{len(k4_qs)}", ks, bs)
            rec.compare("k4_ngram_ranges_block", f"{what} end x{len(k4_qs)}", ke, be)
            ks, ke = kernels.k4_ngram_ranges(wc_block, ng, mat[:501], wc_len)
            rec.compare("k4_ngram_ranges_block", f"{what} ragged start x501", ks, bs[:501])
            rec.compare("k4_ngram_ranges_block", f"{what} ragged end x501", ke, be[:501])
            if not (torch.equal(bs, ps) and torch.equal(be, pe)):
                raise AssertionError(f"{what}: K4 over block rows differs from K4")
            tail = classes["pair"].tolist()
            log(f"  {what}, block-row tail: {class_shares(tail)}")
            if sum(tail) < 1:
                raise AssertionError(f"{what}: the block-row tail took no step")
        counts = NgramSearchEngine(wc_index, n_gram, device=device, pair_rows=True).count(k4_qs[:16])
        if list(counts) != want:
            raise AssertionError(f"window-class corpus n={n_gram} counts {list(counts)} != {want}")
    return kept


def host_sample(sample: dict, kmers, text_arr, engines: dict, tag: str, counts=None) -> None:
    """A host-scan sample through ``engines``: ``sample`` names queries of
    ``kmers`` (``"queries"``) and their counts by a scan of the text
    (``"counts"``); each engine's count of them must equal the scan (and,
    with ``counts``, so must the batch's answers there) and every hit of
    its locate must lie in the text and hold its query."""
    import numpy as np

    idx, want = sample["queries"], sample["counts"]
    qs = [kmers[i] for i in idx]
    if counts is not None and [int(counts[i]) for i in idx] != want:
        raise AssertionError(f"{tag} the batch's counts of the sample differ from the host scan")
    length = len(qs[0])
    windows = np.lib.stride_tricks.sliding_window_view(text_arr, length)
    for label, eng in engines.items():
        got = [int(c) for c in eng.count(qs)]
        if got != want:
            raise AssertionError(f"{tag} {label}: sample counts {got} != host scan {want}")
        for q, c, hits in zip(qs, want, eng.locate(qs)):
            h = np.asarray(hits).astype(np.int64)
            if len(h) != c or (h > len(text_arr) - length).any() or not all(
                    windows[p].tobytes() == q for p in h):
                raise AssertionError(f"{tag} {label}: a locate hit of {q!r} does not hold it")
    log(f"{tag} host-scan sample of {len(qs)} {length}-mers ({sum(want)} hits): counts equal "
        f"the scan and every locate hit holds its query, through {', '.join(engines)}")


def pairless_corpus_checks(rec: Record, device: str) -> dict:
    """Phase 4p on the window-class corpora (``pairless_corpora``): K4
    over block rows at n = 2 and 3 and K2w over compact rows against
    their plain versions, whole and ragged; each must take every window
    class of its steps (K4: the n-gram steps and the block-row tail), by
    the plain versions' counts, which are logged and returned."""
    import torch
    from avxwindowfmindex_tpu_torch import (
        AlphabetType, IndexConfiguration, SearchEngine, create_index, search,
    )
    from avxwindowfmindex_tpu_torch.ops import kernels, ngram

    from avxwindowfmindex_tpu_torch.tools.kernel_ab import lengthwise_batch

    text, k4_qs, klen, aa_text, aa_qs = pairless_corpora()
    index = create_index(text, IndexConfiguration(8, 6, AlphabetType.DNA), device=device)
    view = index.to_device(device, pair_rows=False)
    mat = torch.from_numpy(SearchEngine(view, device=device).encode_kmers(k4_qs)[0]).to(device)
    # the 41-mers (letters read from memory) and their last 29 letters (a
    # 32-column matrix: letters in registers)
    batches = {klen: mat, PAIRLESS_SHORT_LEN: lengthwise_batch(mat, klen, PAIRLESS_SHORT_LEN)[0]}
    out = {}
    for n in (2, 3):
        ng = ngram.build_ngram_device(index, n, device=device)
        for length, lmat in batches.items():
            classes = search.new_step_classes(device)
            ps, pe = search.ngram_ranges_plain(view, ng, lmat, length, classes)
            what = f"window-class corpus n={n}, {length}-mers"
            ks, ke = kernels.k4_ngram_ranges(view, ng, lmat, length)
            rec.compare("k4_ngram_ranges_block", f"{what} start x{len(k4_qs)}", ks, ps)
            rec.compare("k4_ngram_ranges_block", f"{what} end x{len(k4_qs)}", ke, pe)
            ks, ke = kernels.k4_ngram_ranges(view, ng, lmat[:501], length)
            rec.compare("k4_ngram_ranges_block", f"{what} ragged start x501", ks, ps[:501])
            rec.compare("k4_ngram_ranges_block", f"{what} ragged end x501", ke, pe[:501])
            shares = {t: c.tolist() for t, c in classes.items()}
            log(f"[4p] K4 over block rows, {what}: n-gram steps "
                f"{class_shares(shares['ngram_pair'])}; block-row tail {class_shares(shares['pair'])}")
            if min(shares["ngram_pair"]) < 1 or min(shares["pair"]) < 1:
                raise AssertionError(f"[4p] K4 over block rows, {what}: a window class was never "
                                     f"taken: {shares}")
            out[f"k4_block_n{n}_{length}"] = shares
    aa = create_index(aa_text, IndexConfiguration(8, PAIRLESS_AMINO_SEED_K, AlphabetType.AMINO),
                      device=device)
    compact = aa.to_device(device, wide=True, pair_rows=False)
    eng = SearchEngine(compact, device=device)
    amat, lengths, _ = eng.encode_kmers(aa_qs)
    seeded = eng._seed_eligibility(amat, lengths)
    args = (torch.from_numpy(amat).to(device), torch.from_numpy(lengths).to(device),
            torch.from_numpy(seeded.astype("uint8")).to(device))
    classes = torch.zeros(3, dtype=torch.int64, device=device)
    ps, pe = search.ranges_plain(compact, *args, classes)
    ks, ke = kernels.k2_ranges(compact, *args)
    rec.compare("k2w_ranges_compact", f"window-class corpus start x{len(aa_qs)}", ks, ps)
    rec.compare("k2w_ranges_compact", f"window-class corpus end x{len(aa_qs)}", ke, pe)
    ks, ke = kernels.k2_ranges(compact, *(a[:333] for a in args))
    rec.compare("k2w_ranges_compact", "window-class corpus ragged start x333", ks, ps[:333])
    rec.compare("k2w_ranges_compact", "window-class corpus ragged end x333", ke, pe[:333])
    classes = classes.tolist()
    log(f"[4p] K2w over compact rows, amino window-class corpus ({len(aa_qs)} queries, "
        f"{int(seeded[:len(aa_qs)].sum())} seeded): steps {class_shares(classes)}")
    if min(classes) < 1:
        raise AssertionError(f"[4p] K2w over compact rows: a window class was never taken: {classes}")
    out["k2w_compact"] = classes
    out["edges"] = pairless_edges(rec, device, corpus_k2_batches(view, k4_qs, klen))
    return out


def corpus_k2_batches(view, k4_qs, klen: int) -> dict:
    """K2's batches of the DNA window-class corpus for ``pairless_edges``:
    its 41-mers (letters read from memory) and their last
    ``PAIRLESS_SHORT_LEN`` letters (letters in registers)."""
    return {f"window-class corpus, {klen}-mers": (view, list(k4_qs)),
            f"window-class corpus, last {PAIRLESS_SHORT_LEN} letters":
                (view, [q[-PAIRLESS_SHORT_LEN:] for q in k4_qs])}


def pairless_edges(rec: Record, device: str, corpus_k2=None) -> dict:
    """Phase 4p: K3w over compact rows and K2 over block rows at their
    edges, each against its plain version. K3w on two small amino indexes,
    SA ratio 6 (no power of two: p % ratio) and 8 (a shift): 0, 1 and 33
    hits, every position of the index, a batch of EDGE_HITS random
    positions (no multiple of a block), walks from the sentinel's row,
    with the SA resident and on disk. K2: batches of 0, 1 and 33 queries, an
    unseeded batch (every length <= k) and the batches of ``corpus_k2``
    (label -> (view, queries): the DNA window-class corpus, each of which
    must take every window class). Returns the walks' step counts and the
    K2 batches' sizes and classes."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import (
        AlphabetType, IndexConfiguration, SearchEngine, create_index, search,
    )
    from avxwindowfmindex_tpu_torch.ops import kernels

    rng = np.random.default_rng(0xED6E)
    out = {"k3w_compact": {}, "k2_block": {}}
    text = random_text(rng, EDGE_RESIDUES, AlphabetType.AMINO)
    for ratio in (6, 8):
        aa = create_index(text, IndexConfiguration(ratio, 3, AlphabetType.AMINO), device=device)
        view = aa.to_device(device, wide=True, pair_rows=False)
        if view.pair_fused or view.packed.shape[1] != 384:
            raise AssertionError("[4p] edges: the amino view is not on compact rows")
        disk = dataclasses.replace(view, sampled_sa=None)
        n = view.bwt_length
        sentinel = int(np.flatnonzero(aa.bwt_letters == aa.sentinel_index)[0])
        every = torch.arange(n, dtype=torch.int64, device=device)
        batches = {"0 hits": every[:0], "1 hit": every[sentinel:sentinel + 1],
                   "33 hits": every[rng.integers(0, n, 33)],
                   f"every position x{n}": every,
                   f"random x{EDGE_HITS}": torch.from_numpy(rng.integers(0, n, EDGE_HITS)).to(device),
                   "the sentinel's row x37": torch.full((37,), sentinel, dtype=torch.int64,
                                                        device=device)}
        for label, pos in batches.items():
            what = f"ratio {ratio}, {label}"
            got = kernels.k3_backtrace_resolve(view, pos)
            rec.compare("k3w_backtrace_resolve_compact", f"edges {what}", got,
                        search.backtrace_resolve_plain(view, pos))
            kp, ko = kernels.k3_backtrace_resolve(disk, pos)
            pp, po = search.backtrace_resolve_plain(disk, pos)
            rec.compare("k3w_backtrace_resolve_compact", f"edges {what} on-disk p", kp, pp)
            rec.compare("k3w_backtrace_resolve_compact", f"edges {what} on-disk off", ko, po)
            out["k3w_compact"][what] = int(po.sum())
        del aa, view, disk, every, batches

    dna = create_index(random_text(rng, EDGE_RESIDUES, AlphabetType.DNA).upper(),
                       IndexConfiguration(8, 6, AlphabetType.DNA), device=device)
    view = dna.to_device(device, pair_rows=False)
    sets = {}
    qs = [random_text(rng, 25, AlphabetType.DNA) for _ in range(33)]
    sets["0 queries"], sets["1 query"], sets["33 queries"] = qs[:0], qs[:1], qs
    sets["unseeded x300 (lengths 1-5)"] = [random_text(rng, int(L), AlphabetType.DNA)
                                          for L in rng.integers(1, 6, 300)]
    batch_views = {label: (view, kmers) for label, kmers in sets.items()}
    batch_views.update(corpus_k2 or {})
    for label, (v, kmers) in batch_views.items():
        e = SearchEngine(v, device=device)
        if kmers:
            mat, lengths, _ = e.encode_kmers(kmers)
            seeded = e._seed_eligibility(mat, lengths)
        else:
            mat = np.zeros((0, 32), np.uint8)
            lengths, seeded = np.zeros(0, np.int32), np.zeros(0, bool)
        m = len(kmers)
        args = (torch.from_numpy(mat[:m]).to(device), torch.from_numpy(lengths[:m]).to(device),
                torch.from_numpy(seeded[:m].astype(np.uint8)).to(device))
        classes = torch.zeros(3, dtype=torch.int64, device=device)
        ps, pe = search.ranges_plain(v, *args, classes)
        ks, ke = kernels.k2_ranges(v, *args)
        rec.compare("k2_ranges_block", f"edges {label} start x{m}", ks, ps)
        rec.compare("k2_ranges_block", f"edges {label} end x{m}", ke, pe)
        out["k2_block"][label] = {"queries": m, "seeded": int(seeded[:m].sum()),
                                  "classes": classes.tolist()}
        if label.startswith("unseeded") and seeded[:m].any():
            raise AssertionError("[4p] edges: the unseeded batch holds a seeded query")
        if label in (corpus_k2 or {}) and min(classes.tolist()) < 1:
            raise AssertionError(f"[4p] edges: K2 over block rows on the {label} never took a "
                                 f"window class: {classes.tolist()}")
    log(f"[4p] edges: K3w over compact rows at ratios 6 and 8 (LF steps by batch: "
        f"{json.dumps(out['k3w_compact'])}), K2 over block rows ({json.dumps(out['k2_block'])}): "
        f"equal to their plain versions")
    return out


def compact_forms(rec: Record, name: str, index, k: int, pos_t, lett_t, lpos, k2_in: dict,
                  bpos, device: str) -> None:
    """Phase 3w, the amino index's wide view without pair rows
    (``to_device(wide=True, pair_rows=False)``: the compact 384 B rows):
    K1WX over every depth of the BFS and crafted parents, its BFS mode at
    every k up to the index's (``bfs_mode_checks``) and traced
    (``trace_bfs``), K1w's occ mode
    on phase 3w's positions (2^64 - 1, 2^40 + 5 and the other block-index
    edges among them) and its LF mode, K2w on every batch of phase 3w, and
    K3w with the SA resident and on disk, on every position too, each
    against its plain version and equal to the pair-fused view's kernel."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import SearchEngine, search
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, seed_table

    rng = np.random.default_rng(17)
    pair = index.to_device(device, wide=True)
    dev = index.to_device(device, wide=True, pair_rows=False)
    if dev.pair_fused or dev.packed_pair is not None or dev.packed.shape[1] != 384:
        raise AssertionError(f"{name}: the view without pair rows is not the compact one")
    tag = f"{name} compact"
    table = seed_table.build_seed_table(dev, dev.cardinality, 1, index.prefix_sums)
    for depth in range(1, k):
        got = kernels.k1_extend(dev, table)
        table = seed_table.extend_level_plain(dev, table)
        rec.compare("k1w_extend_compact", f"{tag} BFS depth {depth} x{table.shape[0]}", got, table)
    if not torch.equal(table, dev.seed_table):
        raise AssertionError(f"{tag}: the BFS differs from the view's (widened) seed table")
    parents = crafted_parents(rng, dev)
    rec.compare("k1w_extend_compact", f"{tag} crafted parents x{parents.shape[0]}",
                kernels.k1_extend(dev, parents), seed_table.extend_level_plain(dev, parents))
    bfs_mode_checks(rec, "k1w_extend_compact.bfs", dev, index, range(1, k + 1), f"[3w] {tag}")
    trace_bfs(dev, index.prefix_sums, k, f"[3w] {tag}:")
    got = kernels.k1_occurrence(dev, pos_t, lett_t)
    rec.compare("k1w_rank_compact", f"{tag} occ x{pos_t.numel()}", got,
                rank.occurrence_plain(dev, pos_t, lett_t))
    if not torch.equal(got, kernels.k1_occurrence(pair, pos_t, lett_t)):
        raise AssertionError(f"{tag}: K1w's occ over compact rows differs from K1w's")
    kl, kf = kernels.k1_letter_and_lf(dev, lpos)
    pl, pf = rank.letter_and_lf_plain(dev, lpos)
    rec.compare("k1w_rank_compact", f"{tag} letter x{lpos.numel()}", kl, pl)
    rec.compare("k1w_rank_compact", f"{tag} LF x{lpos.numel()}", kf, pf)
    for label, args in k2_in.items():
        ks, ke = kernels.k2_ranges(dev, *args)
        ps, pe = search.ranges_plain(dev, *args)
        rec.compare("k2w_ranges_compact", f"{tag} {label} start", ks, ps)
        rec.compare("k2w_ranges_compact", f"{tag} {label} end", ke, pe)
        ws, we = kernels.k2_ranges(pair, *args)
        if not (torch.equal(ks, ws) and torch.equal(ke, we)):
            raise AssertionError(f"{tag} {label}: K2w over compact rows differs from K2w")
    every = torch.arange(dev.bwt_length, dtype=torch.int64, device=device)
    for label, positions in (("hits", bpos), ("every position", every),
                             ("0-step walks", (bpos // dev.ratio) * dev.ratio)):
        got = kernels.k3_backtrace_resolve(dev, positions)
        rec.compare("k3w_backtrace_resolve_compact", f"{tag} {label} x{positions.numel()}", got,
                    search.backtrace_resolve_plain(dev, positions))
        if not torch.equal(got, kernels.k3_backtrace_resolve(pair, positions)):
            raise AssertionError(f"{tag} {label}: K3w over compact rows differs from K3w")
        disk = dataclasses.replace(dev, sampled_sa=None)
        kp, ko = kernels.k3_backtrace_resolve(disk, positions)
        pp, po = search.backtrace_resolve_plain(disk, positions)
        rec.compare("k3w_backtrace_resolve_compact", f"{tag} {label} on-disk p", kp, pp)
        rec.compare("k3w_backtrace_resolve_compact", f"{tag} {label} on-disk off", ko, po)
    eng = SearchEngine(index, device=device, wide=True, pair_rows=False)
    if eng.dev is not dev:
        raise AssertionError(f"{tag}: the engine did not take the installed compact view")
    log(f"  {tag}: K1WX, K1w, K2w and K3w over the 384 B rows equal their plain versions "
        f"and the pair-fused view's kernels")


def block_step_tables(nb: int, n_planes: int, ms_bytes: int, classes):
    """``step_tables`` for steps over a table of ``nb`` block rows (a view
    without pair rows): a first-block step needs the first 32 B of each
    plane and one milestone of its row (both 64 B pieces of a 128 B
    nucleotide row), every wider step the same of two rows."""
    first, window, two = (int(c) for c in classes)
    tables = [(nb, n_planes * 32 + ms_bytes, first + 2 * (window + two))]
    ops = first * pair_step_ops(n_planes, 8) + (window + two) * 2 * rank_ops(n_planes)
    return tables, ops


def phase_main(bases: int, device: str):
    """Phase 4: the main path at full size."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import (
        AlphabetType, DigramSearchEngine, IndexConfiguration, SearchEngine, create_index,
    )

    rng = np.random.default_rng(1234)
    seq_arr = rng.choice(np.frombuffer(b"acgt", np.uint8), size=bases)
    seq_bytes = seq_arr.tobytes()
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=8,
        kmer_length_in_seed_table=MAIN_SEED_K,
        alphabet_type=AlphabetType.DNA,
    )
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    index = create_index(seq_bytes, cfg, sa_backend="native", device=device)
    torch.cuda.synchronize()
    build_s = time.time() - t0
    log(f"[4] create_index: {bases} bases, seed k={MAIN_SEED_K}, ratio 8: {build_s:.3f}s")
    t0 = time.time()
    engine = DigramSearchEngine(index, device=device)
    torch.cuda.synchronize()
    ngram_build_s = time.time() - t0
    ng = engine.ng
    log(
        f"[4] n-gram table (n={ng.n}, Cn-biased): host build_ngram_host + packing + upload "
        f"{ngram_build_s:.3f}s; {ng.packed.shape[0]} rows x {ng.packed.shape[1]} B = "
        f"{(ng.packed.numel() + 4 * ng.cn.numel()) / 1e6:.1f} MB on the card"
    )
    single = SearchEngine(index, device=device)

    starts = rng.integers(0, bases - KMER_LEN, size=QUERIES)
    windows = np.lib.stride_tricks.sliding_window_view(seq_arr, KMER_LEN)
    kmer_ascii = windows[starts]
    buf = kmer_ascii.tobytes()
    kmers = [buf[i * KMER_LEN : (i + 1) * KMER_LEN] for i in range(QUERIES)]
    sample = rng.integers(0, QUERIES, size=32)
    want = np.array([count_overlapping(seq_bytes, kmers[i]) for i in sample])

    stats = {"build_s": build_s, "ngram_build_s": ngram_build_s,
             "host_sample": {"queries": [int(i) for i in sample], "counts": [int(c) for c in want]}}
    answers = None  # the digram engine's (counts, lengths, flat hits), for phase 7
    for label, eng in (("digram", engine), ("single", single)):
        counts, count_s, count_times = timed_engine_call(eng.count, kmers)
        hits, locate_s, locate_times = timed_engine_call(eng.locate, kmers)
        stats[f"{label}_count_qps"] = QUERIES / count_s
        stats[f"{label}_locate_qps"] = QUERIES / locate_s
        log(
            f"[4] {label} count {QUERIES} x {KMER_LEN}-mers: median {count_s:.4f}s of "
            f"{count_times} -> {QUERIES / count_s:.1f} q/s"
        )
        log(
            f"[4] {label} locate {QUERIES} x {KMER_LEN}-mers: median {locate_s:.4f}s of "
            f"{locate_times} -> {QUERIES / locate_s:.1f} q/s"
        )
        if not (counts >= 1).all():
            raise AssertionError(f"{label}: {int((counts < 1).sum())} sampled 25-mers counted 0")
        if not (counts[sample] == want).all():
            raise AssertionError(f"{label} count spot check: {counts[sample]} != {want}")
        log(f"[4] {label} count spot check: 32/32 exact vs host-scan oracle")
        lens = np.array([len(h) for h in hits])
        if not (lens == counts).all():
            raise AssertionError(f"{label}: locate hit-list lengths differ from counts")
        flat = np.concatenate(hits).astype(np.int64)
        if (flat > bases - KMER_LEN).any():
            raise AssertionError(f"{label}: locate returned a hit beyond the last window")
        qid = np.repeat(np.arange(QUERIES), lens)
        if not (windows[flat] == kmer_ascii[qid]).all():
            raise AssertionError(f"{label}: locate returned a non-matching position")
        log(f"[4] {label} locate: {len(flat)} hits, every one matches its window")
        if answers is None:
            answers = (counts, lens, flat.astype(np.uint64))
        del hits, flat, qid

    # bench.py's assertion, on the card: digram ranges == single-step ranges
    digram_ranges = engine.find_ranges(kmers)
    single_ranges = single.find_ranges(kmers)
    if not np.array_equal(digram_ranges, single_ranges):
        bad = int((digram_ranges != single_ranges).any(axis=1).sum())
        raise AssertionError(f"digram ranges differ from single-step ranges on {bad} queries")
    log(f"[4] digram ranges == single-step ranges on all {QUERIES} queries")

    mh_starts = rng.integers(0, bases - MULTIHIT_LEN, size=MULTIHIT_QUERIES)
    mh_windows = np.lib.stride_tricks.sliding_window_view(seq_arr, MULTIHIT_LEN)
    mh_ascii = mh_windows[mh_starts]
    mh_kmers = [row.tobytes() for row in mh_ascii]
    engine.locate(mh_kmers[:64])  # warm-up
    t = time.time()
    mh_hits = engine.locate(mh_kmers)
    mh_s = time.time() - t
    mh_lens = np.array([len(h) for h in mh_hits])
    mh_flat = np.concatenate(mh_hits).astype(np.int64)
    if (mh_flat > bases - MULTIHIT_LEN).any():
        raise AssertionError("multi-hit locate returned a hit beyond the last window")
    if not (mh_windows[mh_flat] == mh_ascii[np.repeat(np.arange(MULTIHIT_QUERIES), mh_lens)]).all():
        raise AssertionError("multi-hit locate returned a non-matching position")
    freq = int(np.argmax(mh_lens))
    freq_want = count_overlapping(seq_bytes, mh_kmers[freq])
    if mh_lens[freq] != freq_want:
        raise AssertionError(f"multi-hit completeness: {mh_lens[freq]} != {freq_want}")
    log(
        f"[4] multi-hit locate {MULTIHIT_QUERIES} x {MULTIHIT_LEN}-mers: {len(mh_flat)} hits "
        f"({mh_lens.mean():.2f}/query) in {mh_s:.4f}s -> {MULTIHIT_QUERIES / mh_s:.1f} q/s, "
        f"{len(mh_flat) / mh_s:.1f} hits/s; all sound, most frequent complete ({freq_want})"
    )
    log(f"[4] peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.3f} GiB")
    stats["multihit_qps"] = MULTIHIT_QUERIES / mh_s
    return stats, engine, kmers, seq_arr, mh_kmers, answers


def phase_main_shapes(rec: Record, engine, kmers) -> dict:
    """After the main path: where one digram locate of the full batch
    spends its time, stage by stage (host clock, synchronized), and each
    kernel against its plain version at the shapes the main path gave it
    — the k = 14 seed table and one of its K1 launches, the 1M-query range
    batch through K4 and through K2, the ~1M-hit backtrace — compared
    exactly and timed in turns."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import search
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, seed_table

    dev, ng = engine.dev, engine.ng
    out = {}
    t = time.time()
    mat, lengths, n = engine.encode_kmers(kmers)
    out["encode_s"] = time.time() - t
    t = time.time()
    # the fast-path test of NgramSearchEngine._ranges_device, then the upload
    if not ((lengths == KMER_LEN).all() and (mat[:, :KMER_LEN] < dev.cardinality).all()):
        raise AssertionError("the main batch must take the n-gram fast path")
    mat_d = torch.from_numpy(mat).to(engine.device)
    torch.cuda.synchronize()
    out["fast_path_check_upload_s"] = time.time() - t
    t = time.time()
    start, end = search.ngram_ranges(dev, ng, mat_d, KMER_LEN)
    torch.cuda.synchronize()
    out["k4_ngram_ranges_s"] = time.time() - t
    t = time.time()
    counts = search.range_counts(start[:n], end[:n])
    positions = search.enumerate_range_positions(start[:n], counts)
    torch.cuda.synchronize()
    out["enumerate_s"] = time.time() - t
    t = time.time()
    hits = search.backtrace_resolve(engine.dev, positions)
    torch.cuda.synchronize()
    out["k3_backtrace_resolve_s"] = time.time() - t
    t = time.time()
    hits_h = hits.cpu().numpy().astype(np.uint64)
    counts_h = counts.cpu().numpy()
    out["to_host_s"] = time.time() - t
    t = time.time()
    np.split(hits_h, np.cumsum(counts_h)[:-1])
    out["split_s"] = time.time() - t
    log(f"[4] digram locate breakdown ({n} queries): {json.dumps(out)}")

    # the single-step engine's stages for the same batch, in place of the
    # fast-path check and K4
    single = {}
    t = time.time()
    seeded = engine._seed_eligibility(mat, lengths)
    args = (
        torch.from_numpy(mat).to(engine.device),
        torch.from_numpy(lengths).to(engine.device),
        torch.from_numpy(seeded.astype(np.uint8)).to(engine.device),
    )
    torch.cuda.synchronize()
    single["eligibility_upload_s"] = time.time() - t
    t = time.time()
    k2_s, k2_e = search.search_ranges(dev, *args)
    torch.cuda.synchronize()
    single["k2_ranges_s"] = time.time() - t
    log(f"[4] single-step stages for the same batch: {json.dumps(single)}")
    out.update({f"single_{key}": v for key, v in single.items()})
    if not (torch.equal(k2_s, start) and torch.equal(k2_e, end)):
        raise AssertionError("K4 and K2 ranges differ at the main shape")
    k = dev.kmer_length_in_seed_table
    out["bfs"] = bfs_routes(rec, dev, k, engine.host_index.prefix_sums, "4", "k1_extend")

    # K1's occ mode at the size of one launch of the per-letter BFS's
    # deepest depths: 2 * CHUNK random (pos, letter) pairs
    rng = np.random.default_rng(99)
    b = 2 * seed_table.CHUNK
    occ_pos = torch.from_numpy(rng.integers(0, dev.bwt_length, size=b)).to(engine.device)
    occ_lett = torch.from_numpy(
        rng.integers(0, dev.cardinality, size=b).astype(np.int32)
    ).to(engine.device)
    rec.compare(
        "k1_rank", f"main occ x{b}",
        kernels.k1_occurrence(dev, occ_pos, occ_lett), rank.occurrence_plain(dev, occ_pos, occ_lett),
    )
    k2_classes = torch.zeros(3, dtype=torch.int64, device=engine.device)
    ps, pe = search.ranges_plain(dev, *args, k2_classes)
    rec.compare("k2_ranges", f"main start x{n}", k2_s, ps)
    rec.compare("k2_ranges", f"main end x{n}", k2_e, pe)
    k4_classes = search.new_step_classes(engine.device)
    ps, pe = search.ngram_ranges_plain(dev, ng, mat_d, KMER_LEN, k4_classes)
    rec.compare("k4_ngram_ranges", f"main n={ng.n} start x{n}", start, ps)
    rec.compare("k4_ngram_ranges", f"main n={ng.n} end x{n}", end, pe)
    del ps, pe
    k2_classes = k2_classes.tolist()
    k4_classes = {t: c.tolist() for t, c in k4_classes.items()}
    log(f"[4] window classes of the main batch ({dev.bwt_length} positions, seed k={k}): "
        f"K4's n-gram steps {class_shares(k4_classes['ngram_pair'])}; its tail steps "
        f"{class_shares(k4_classes['pair'])}; K2's steps {class_shares(k2_classes)}")
    rec.compare(
        "k3_backtrace_resolve", f"main hits x{positions.numel()}",
        hits, search.backtrace_resolve_plain(dev, positions),
    )
    rec.ms["k1_rank"] = time_in_turns(
        f"k1_rank main x{b}",
        lambda: kernels.k1_occurrence(dev, occ_pos, occ_lett),
        lambda: rank.occurrence_plain(dev, occ_pos, occ_lett), 10, 2,
    )
    rec.ms["k2_ranges"] = time_in_turns(
        f"k2_ranges main x{n}",
        lambda: kernels.k2_ranges(dev, *args), lambda: search.ranges_plain(dev, *args), 10, 1,
    )
    rec.ms["k4_ngram_ranges"] = time_in_turns(
        f"k4_ngram_ranges main n={ng.n} x{n}",
        lambda: kernels.k4_ngram_ranges(dev, ng, mat_d, KMER_LEN),
        lambda: search.ngram_ranges_plain(dev, ng, mat_d, KMER_LEN), 10, 1,
    )
    rec.ms["k3_backtrace_resolve"] = time_in_turns(
        f"k3_backtrace_resolve main x{positions.numel()}",
        lambda: kernels.k3_backtrace_resolve(dev, positions),
        lambda: search.backtrace_resolve_plain(dev, positions), 10, 1,
    )
    set_index_bounds(rec, INDEX_KERNELS, dev, b, args[0], positions, k2_classes)
    # K4: floor(m / n) n-gram steps per query, then m mod n single steps,
    # each charged by its window class
    m = KMER_LEN - k
    ng_tables, ng_ops = step_tables(ng.packed.shape[0], 2 * ng.n + 1, 4, k4_classes["ngram_pair"])
    tail_tables, tail_ops = step_tables(dev.packed_pair.shape[0], dev.n_planes, 4, k4_classes["pair"])
    rec.set_bound(
        "k4_ngram_ranges", ng_tables + tail_tables,
        n * (mat_d.shape[1] + 2 * dev.seed_table.element_size() + 16), ng_ops + tail_ops,
        row_visits=[sum(k4_classes["ngram_pair"]) + k4_classes["ngram_pair"][2],
                    sum(k4_classes["pair"]) + k4_classes["pair"][2]],
        other_visits={"seed_table": n},
    )
    traffic = rec.model["k4_ngram_ranges"]["row_traffic_ms"] * 1e-3 * HBM_BYTES_PER_S
    log(f"  k4_ngram_ranges row traffic: {(traffic - n * (mat_d.shape[1] + 24)) / n:.1f} B of row "
        f"sectors per query (whole windows: {(m // ng.n) * 12 * 32 + (m % ng.n) * 7 * 32} B)")
    return out


def bfs_by_depth(dev, k: int, prefix_sums, step):
    """(the k-mer table, ms of each depth): the BFS from the depth-1
    ranges, one ``step(dev, parents)`` a depth, CUDA events around each."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import seed_table

    table = seed_table.build_seed_table(dev, dev.cardinality, 1, prefix_sums)
    events = []
    for _ in range(1, k):
        pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        pair[0].record()
        table = step(dev, table)
        pair[1].record()
        events.append(pair)
    torch.cuda.synchronize()
    return table, [a.elapsed_time(b) for a, b in events]


def bfs_routes(rec: Record, dev, k: int, prefix_sums, tag: str, name: str) -> dict:
    """The k-mer seed table of ``dev`` by four routes: ``name`` (K1X or
    K1WX, one launch a depth, each depth timed); the build's route
    (``build_seed_table``: the BFS mode's one launch for the shallow
    depths, then one ``name`` launch a depth; the whole table timed); the
    per-letter loop over K1's (K1w's) occ mode, the route before K1X,
    kernel and torch work alike (``extend_level_plain`` over
    ``rank.occurrence``, each depth timed); and the plain version (each
    depth timed). In turns:
    plain, kernel, build, per-letter, per-letter, build, kernel, plain;
    each route's best run. Every table must equal the plain one (and the
    view's own, at its k). Then the per-letter route's K1 launches alone
    at the deepest depth, the bound of the per-depth route from this run's
    levels, and the BFS mode alone (``name.bfs``: its one launch of the
    build's shallow depths) against the plain BFS to the same level, with
    its own bound."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import k1_launch_ms

    routes = {
        "plain": seed_table.extend_level_plain,
        "kernel": seed_table.extend_level,
        "per_letter": lambda d, t: seed_table.extend_level_plain(d, t, rank.occurrence),
    }
    best, tables = {}, {}
    for route in ("plain", "kernel", "build", "per_letter", "per_letter", "build", "kernel",
                  "plain"):
        if route == "build":
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            table = seed_table.build_seed_table(dev, dev.cardinality, k, prefix_sums)
            ev[1].record()
            torch.cuda.synchronize()
            ms = [ev[0].elapsed_time(ev[1])]
        else:
            table, ms = bfs_by_depth(dev, k, prefix_sums, routes[route])
        if route not in best or sum(ms) < sum(best[route]):
            best[route] = ms
        if route in ("per_letter", "build"):
            rec.compare(name if route == "per_letter" else f"{name}.bfs",
                        f"k={k} table through the {route} route == through {name}",
                        table, tables["kernel"])
        else:
            tables.setdefault(route, table)
        del table
    rec.compare(name, f"k={k} BFS through {name} == plain x{tables['plain'].shape[0]}",
                tables["kernel"], tables["plain"])
    if k == dev.kmer_length_in_seed_table:
        rec.compare(name, f"k={k} BFS through {name} == the view's seed table",
                    tables["kernel"], dev.seed_table)
    del tables
    totals = {route: sum(ms) for route, ms in best.items()}
    split = seed_table.bfs_depths(dev.cardinality, k, seed_table.bfs_max_parents(dev))
    for route, ms in best.items():
        log(f"[{tag}] BFS k={k} {route}: {totals[route]:.4f} ms; by depth "
            f"{[round(m, 4) for m in ms]}")
    log(f"[{tag}] BFS k={k}: {name} {totals['kernel']:.4f} ms one launch a depth, "
        f"{totals['build']:.4f} ms the build's route (depths 1-{split} in the BFS mode's one "
        f"launch), the per-letter route {totals['per_letter']:.4f} ms "
        f"({totals['per_letter'] / totals['kernel']:.1f}x), plain {totals['plain']:.4f} ms")
    deepest = seed_table.build_seed_table(dev, dev.cardinality, k - 1, prefix_sums)
    k1_ms, k1_launches = k1_launch_ms(dev, deepest)
    del deepest
    log(f"[{tag}] the per-letter route's depth {k - 1}: {best['per_letter'][-1]:.4f} ms, of which "
        f"its {k1_launches} K1 launches {k1_ms:.4f} ms and the torch work around them the rest")
    rec.ms[name] = (totals["kernel"], totals["plain"])
    set_bfs_bound(rec, name, dev, k, prefix_sums, tag)
    # the BFS mode alone: its one launch of the build's depths 1 .. split
    # against the plain BFS to the same level, and its own bound
    mode = (lambda: kernels.k1_seed_table(dev, split + 1))
    plain_mode = (lambda: seed_table.build_seed_table(dev, dev.cardinality, split + 1, prefix_sums,
                                                      occurrence_fn=rank.occurrence_plain))
    rec.compare(f"{name}.bfs", f"k={split + 1} table in one launch of the BFS mode == plain",
                mode(), plain_mode())
    rec.ms[f"{name}.bfs"] = time_in_turns(f"{name}.bfs, depths 1-{split} in one launch", mode,
                                          plain_mode, 10, 1)
    set_bfs_bound(rec, f"{name}.bfs", dev, split + 1, prefix_sums, tag, in_launch=split)
    return {"ms": totals, "depth_ms": best, "per_letter_k1_ms": k1_ms,
            "per_letter_k1_launches": k1_launches, "depths_in_launch": split,
            "bfs_mode_ms": rec.ms[f"{name}.bfs"][0]}


def set_bfs_bound(rec: Record, name: str, dev, k: int, prefix_sums, tag: str,
                  in_launch: int = 0) -> None:
    """The bound of the BFS through K1X (K1WX), from this run's levels: per
    depth, its parents read and children written once, and the distinct
    rows of its visits at the bytes a visit reads (the planes' first block
    and every letter's milestone). A warp of K1X takes 31 parents and
    counts at 32 positions, one row visit each, plus one for each parent
    whose start - 1 is not the previous parent's end; every visit is one
    match and one count per letter. ``in_launch``: the depths 1 ..
    in_launch that the BFS mode steps in one launch, whose inputs are the
    rows and C[] and whose output is its last level alone (the levels
    between lie in its scratch), so only that level's bytes stream from
    them."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import seed_table

    card, np_, nb = dev.cardinality, dev.n_planes, dev.num_blocks
    width = dev.seed_table.element_size()
    table = seed_table.build_seed_table(dev, card, 1, prefix_sums)
    tables, stream, parents, apart = [], 0, 0, 0
    for depth in range(1, k):
        n = table.shape[0]
        start, end = dev.widen(table[:, 0]), dev.widen(table[:, 1])
        follows = ((start[1:] - 1) & dev.pos_mask) == end[:-1]
        first_of_warp = torch.arange(1, n, device=table.device) % 31 == 0
        extra = int((~follows & ~first_of_warp).sum())
        del start, end, follows, first_of_warp
        tables.append((nb, np_ * 32 + card * dev.milestone_bytes, -(-n // 31) * 32 + extra))
        if depth == in_launch:
            stream += n * card * 2 * width  # the BFS mode's output
        elif depth > in_launch:
            stream += n * 2 * width * (1 + card)  # one launch: its parents and children
        parents += n
        apart += extra
        table = seed_table.extend_level(dev, table)
    del table
    visits = sum(v for _, _, v in tables)
    log(f"[{tag}] BFS k={k}: {parents} parents, {apart} of them not following their "
        f"neighbour ({apart / parents:.2e}); {visits} row visits")
    rec.set_bound(name, tables, stream, visits * card * (match_ops(np_, 8) + count_ops(8)),
                  row_visits=[visits])


def set_index_bounds(rec: Record, names, dev, occ_pairs: int, mat_d, positions,
                     step_classes) -> None:
    """Bounds of K1, K2 and K3 (or K1w, K2w, K3w) for the launches timed at
    the main shapes: ``occ_pairs`` (position, letter) pairs; the batch
    ``mat_d`` of seeded KMER_LEN-mers, every one present in the text, so
    each takes all KMER_LEN - k steps, ``step_classes`` of them in each
    window class (from the plain version's run); and the hits at
    ``positions``, whose LF steps are counted by the kernel itself (its
    on-disk form returns them)."""
    from avxwindowfmindex_tpu_torch.ops import kernels

    k1, k2, k3 = names
    nb, np_ = dev.packed.shape[0], dev.n_planes
    ms_b = dev.milestone_bytes
    pos_b = dev.seed_table.element_size()  # 4 narrow, 8 wide
    rec.set_bound(k1, [(nb, np_ * 32 + ms_b, occ_pairs)], occ_pairs * (8 + 4 + 8),
                  occ_pairs * rank_ops(np_))
    n, l_pad = mat_d.shape
    if sum(step_classes) != n * (KMER_LEN - dev.kmer_length_in_seed_table):
        raise AssertionError(f"{k2}: {sum(step_classes)} steps counted for {n} queries")
    k2_tables, k2_ops = step_tables(dev.packed_pair.shape[0], np_, ms_b, step_classes)
    rec.set_bound(k2, k2_tables, n * (l_pad + 4 + 1 + 2 * pos_b + 16), k2_ops,
                  row_visits=[sum(step_classes) + step_classes[2]], other_visits={"seed_table": n})
    _, off = kernels.k3_backtrace_resolve(dataclasses.replace(dev, sampled_sa=None), positions)
    walked = int(off.sum())
    hits = positions.numel()
    log(f"  {k3}: {walked} LF steps for {hits} hits ({walked / max(hits, 1):.3f} per hit)")
    rec.set_bound(k3, [(nb, np_ * 32 + ms_b, walked)], hits * (8 + 8 + pos_b),
                  walked * rank_ops(np_), other_visits={"sampled_sa": hits})
    zero_step_costs(rec, names, dev, mat_d, positions)


def linear_fit(steps, ms):
    """(fixed ms, ms per step) of the least-squares line through the
    (steps, ms) points."""
    import numpy as np

    per_step, fixed = np.polyfit(np.asarray(steps, float), np.asarray(ms, float), 1)
    return float(fixed), float(per_step)


def zero_step_costs(rec: Record, names, dev, mat_d, positions) -> dict:
    """The visits of K2 and K3 (or K2w, K3w) that are no row visits, timed
    by launches that make them and nothing else: K2 on the last k letters
    of each query of ``mat_d`` (the letter reads, the seed-table visit,
    the stores; no step) and K3 on ``positions`` rounded down to sampled
    ones (the position read, the SA visit, the store; no LF step). Kept in
    ``rec.fixed`` for the [models] lines, which charge them beside the row
    visits."""
    from avxwindowfmindex_tpu_torch.ops import kernels
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import lengthwise_batch

    _, k2, k3 = names
    k = dev.kmer_length_in_seed_table
    seed_only = lengthwise_batch(mat_d, KMER_LEN, k)
    sampled = (positions // dev.ratio) * dev.ratio
    out = {
        k2: min(cuda_ms(lambda: kernels.k2_ranges(dev, *seed_only), 10) for _ in range(2)),
        k3: min(cuda_ms(lambda: kernels.k3_backtrace_resolve(dev, sampled), 10) for _ in range(2)),
    }
    entry = 2 * dev.seed_table.element_size()
    log(f"  {k2} with no step: {out[k2]:.4f} ms for {mat_d.shape[0]} queries: one {entry} B visit each "
        f"to a seed table of {dev.seed_table.numel() * dev.seed_table.element_size() / 1e6:.0f} MB "
        f"({mat_d.shape[0] / out[k2] / 1e6:.2f}G visits/s)")
    log(f"  {k3} with no LF step: {out[k3]:.4f} ms for {positions.numel()} hits: one "
        f"{dev.sampled_sa.element_size()} B visit each to a sampled SA of "
        f"{dev.sampled_sa.numel() * dev.sampled_sa.element_size() / 1e6:.0f} MB "
        f"({positions.numel() / out[k3] / 1e6:.2f}G visits/s)")
    rec.fixed.update(out)
    return out


def phase_step_costs(rec: Record, engine, kmers, dense, rates: dict) -> dict:
    """Phase 4s: what K2, K4 and K3 pay per query or hit and what per
    step, on the phase-4 index. K2 and K4 on the last L letters of the
    main batch's 25-mers for several L, fitted to fixed + steps x per
    step; K2 again over a k = 12 seed table built on the same index; K3
    on hits that need no LF step and on the main batch's; and the
    lane-occupancy ratio of a thread-per-hit launch (32 x the longest walk
    of each warp over the steps walked) at the SA ratio of the index and
    on the ratio-4 device SA ``dense``."""
    import torch
    from avxwindowfmindex_tpu_torch import search
    from avxwindowfmindex_tpu_torch.ops import kernels, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import lengthwise_batch
    from avxwindowfmindex_tpu_torch.utils import roofline

    dev, ng = engine.dev, engine.ng
    device = engine.device
    k = dev.kmer_length_in_seed_table
    mat, _, n = engine.encode_kmers(kmers)
    mat_d = torch.from_numpy(mat).to(device)
    out = {}

    def best(fn):
        return min(cuda_ms(fn, 10) for _ in range(2))

    def k2_fit(view, label):
        kk = view.kmer_length_in_seed_table
        steps = [s for s in (0, 1, 3, 7, 11, 13) if kk + s <= KMER_LEN]
        ms = []
        for st in steps:
            args = lengthwise_batch(mat_d, KMER_LEN, kk + st)
            ms.append(best(lambda: kernels.k2_ranges(view, *args)))
        fixed, per_step = linear_fit(steps, ms)
        table_mb = view.seed_table.numel() * view.seed_table.element_size() / 1e6
        log(f"[4s] k2_ranges, seed k={kk} ({table_mb:.0f} MB seed table), {n} queries of k + "
            f"{steps} letters: {[round(m, 4) for m in ms]} ms -> fixed {fixed:.4f} ms + "
            f"{per_step:.4f} ms a step ({n / per_step / 1e6:.2f}G steps/s; the masked walk on the pair "
            f"table: {rates['pair'] / 1e9:.2f}G rows/s)")
        out[label] = {"steps": steps, "ms": ms, "fixed_ms": fixed, "per_step_ms": per_step}

    k2_fit(dev, "k2_by_length")
    t = time.time()
    table12 = seed_table.build_seed_table(dev, dev.cardinality, 12, engine.host_index.prefix_sums)
    torch.cuda.synchronize()
    log(f"[4s] a k=12 seed table of the same index through K1X: {time.time() - t:.3f}s")
    dev12 = dataclasses.replace(dev, seed_table=table12, kmer_length_in_seed_table=12)
    s12, e12 = kernels.k2_ranges(dev12, *lengthwise_batch(mat_d, KMER_LEN, KMER_LEN))
    s14, e14 = kernels.k2_ranges(dev, *lengthwise_batch(mat_d, KMER_LEN, KMER_LEN))
    rec.compare("k2_ranges", f"ranges over the k=12 seed table == over k={k} start x{n}", s12, s14)
    rec.compare("k2_ranges", f"ranges over the k=12 seed table == over k={k} end x{n}", e12, e14)
    k2_fit(dev12, "k2_by_length_seed_k12")
    del table12, dev12, s12, e12

    # K4: m = kmer_len - k letters beyond the seed, m / 2 n-gram steps and
    # for odd m one tail step (the main batch: m = 11)
    ms_k4, ngram_steps = [], []
    for m in (2, 4, 8, 10):
        args = lengthwise_batch(mat_d, KMER_LEN, k + m)
        ms_k4.append(best(lambda: kernels.k4_ngram_ranges(dev, ng, args[0], k + m)))
        ngram_steps.append(m // ng.n)
    fixed, per_step = linear_fit(ngram_steps, ms_k4)
    log(f"[4s] k4_ngram_ranges, {n} queries of k + (2, 4, 8, 10) letters: "
        f"{[round(m, 4) for m in ms_k4]} ms -> fixed {fixed:.4f} ms + {per_step:.4f} ms an n-gram step "
        f"({n / per_step / 1e6:.2f}G steps/s; the masked walk on the n-gram table: "
        f"{rates['ngram_pair'] / 1e9:.2f}G rows/s)")
    out["k4_by_length"] = {"ngram_steps": ngram_steps, "ms": ms_k4, "fixed_ms": fixed,
                           "per_step_ms": per_step}
    rec.fixed["k4_ngram_ranges"] = fixed

    # K3: the main batch's hits, at the index's ratio and on the dense SA
    start, end = s14[:n], e14[:n]
    positions = search.enumerate_range_positions(start, search.range_counts(start, end))
    for label, view in (("k3_by_walk", dev), ("k3_by_walk_dense", dense)):
        sampled = (positions // view.ratio) * view.ratio
        zero_ms = best(lambda: kernels.k3_backtrace_resolve(view, sampled))
        main_ms = best(lambda: kernels.k3_backtrace_resolve(view, positions))
        _, off = kernels.k3_backtrace_resolve(dataclasses.replace(view, sampled_sa=None), positions)
        walked = int(off.sum())
        occupancy = roofline.warp_lane_occupancy(off)
        log(f"[4s] k3_backtrace_resolve at ratio {view.ratio}: {positions.numel()} hits with no LF step "
            f"{zero_ms:.4f} ms; the main batch's hits ({walked} steps, longest walk {int(off.max())}) "
            f"{main_ms:.4f} ms -> {(main_ms - zero_ms) / max(walked, 1) * 1e6:.4f} ns a step beyond "
            f"the zero-step launch ({walked / max(main_ms - zero_ms, 1e-9) / 1e6:.2f}G steps/s; the walk "
            f"on the block rows: {rates['single'] / 1e9:.2f}G rows/s); lane-occupancy ratio of one "
            f"thread a hit: {occupancy:.4f}")
        out[label] = {"ratio": view.ratio, "hits": positions.numel(), "lf_steps": walked,
                      "zero_step_ms": zero_ms, "ms": main_ms, "lane_occupancy_ratio": occupancy}
    return out


def phase_probes(rec: Record, device: str) -> None:
    """Phase 3b: K5 and K6 against their plain versions at the
    experiments' own shapes, exactly, each timed in turns."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import probes
    from avxwindowfmindex_tpu_torch.tools import gather_probe as gp

    batch = 1 << 19
    shapes = {  # row bytes -> (sum bytes, [(ring, chunk)]): P2/P4, P2/P4, P3
        128: (128, [(8, 512), (16, 512)]),
        512: (512, [(8, 512), (16, 512)]),
        1024: (128, [(8, 512), (16, 512), (32, 1024)]),
    }
    for r, (sum_bytes, configs) in shapes.items():
        table = gp._random_table((1 << 30) // r, r, device, 7)
        idx = gp._random_idx(batch, table.shape[0], device, 8)
        for ring, chunk in configs:
            what = f"u8x{r} sum {sum_bytes} K={ring} CHUNK={chunk}"
            got = probes.gather_reduce(table, idx, sum_bytes=sum_bytes, chunk=chunk, ring=ring)
            want = probes.gather_reduce_plain(table, idx, sum_bytes, chunk)
            rec.compare("k5_gather_reduce", f"{what} partials x{got.numel()}", got, want)
            rec.compare(
                "k5_gather_reduce", f"{what} total",
                torch.tensor([probes.wrapped_total(got)]), torch.tensor([probes.wrapped_total(want)]),
            )
            # device time with the queue kept full: the wrapper's host work
            # (some 30 us) outlasts the launch
            times = time_in_turns(
                f"k5_gather_reduce {what} x{batch}",
                lambda: probes.gather_reduce(table, idx, sum_bytes=sum_bytes, chunk=chunk, ring=ring),
                lambda: probes.gather_reduce_plain(table, idx, sum_bytes, chunk), 20, 3,
                kernel_timer=device_ms,
            )
            if (r, ring) == (128, 16):
                # the launch the kernels line reports (P2's shape): its time,
                # its bound (every byte of a row summed, one add per byte) and
                # the one PyTorch call for it, table[idx] and a sum
                rec.ms["k5_gather_reduce"] = times
                rec.set_bound("k5_gather_reduce", [(table.shape[0], r, batch)],
                              batch * 4 + got.numel() * 4, batch * sum_bytes)
                idx64 = idx.long()
                rec.library["k5_gather_reduce"] = cuda_ms(
                    lambda: table[idx64].sum(dtype=torch.int64), 20)
                log(f"  k5_gather_reduce library table[idx].sum(): {rec.library['k5_gather_reduce']:.4f} ms")
        if r == 512:
            # in what pieces device memory is read: the walk over this
            # 1 GiB table (no L2 reuse) reading 8 of a row's 16 sectors,
            # every other one (8 pieces of 64 B touched) or the first 8
            # (4 pieces of 64 B), and all 16
            for what, mask in (("every other sector", 0x5555), ("the first 8 sectors", 0x00FF),
                               ("all 16 sectors", 0xFFFF)):
                rec.compare("k5_gather_reduce", f"walk u8x512 {what} seg=8 x{batch}",
                            probes.gather_walk(table, idx, 8, mask),
                            probes.gather_walk_plain(table, idx, 8, mask))
                t1 = cuda_ms(lambda: probes.gather_walk(table, idx, 8, mask), 10)
                log(f"  walk over 1 GiB of 512 B rows, {what}: {t1:.4f} ms for {batch} lanes x 8 steps "
                    f"({batch * 8 / t1 / 1e6:.2f}G rows/s)")
            # every byte 0xFF: each partial and the total wrap as int32
            table.fill_(0xFF)
            got = probes.gather_reduce(table, idx, sum_bytes=512, chunk=512, ring=8)
            total = probes.wrapped_total(got)
            want = probes.wrapped_total(probes.gather_reduce_plain(table, idx, 512, 512))
            rec.compare("k5_gather_reduce", f"all-0xFF total {total} (wrapped)",
                        torch.tensor([total]), torch.tensor([want]))
        del table, idx
        torch.cuda.empty_cache()
    # every lane layout of the reduce (8, 16 or 32 lanes a row, two pieces
    # a lane for a 1 KB sum), every ring depth, chunks of 1, 100 and 512
    # rows over 10,000 indices (a ragged last chunk), indices past the
    # table on both sides (clamped)
    for r, sum_bytes in ((128, 16), (384, 48), (256, 256), (384, 384), (512, 512),
                         (1024, 128), (1024, 1024)):
        table = gp._random_table(4096, r, device, r)
        idx = torch.cat([gp._random_idx(9996, 4096, device, 5), torch.tensor(
            [-1, -(2**31), 4096, 2**31 - 1], dtype=torch.int32, device=device)])
        for ring in probes.K5_RING_DEPTHS:
            for chunk in (1, 100, 512):
                rec.compare("k5_gather_reduce", f"u8x{r} sum {sum_bytes} K={ring} CHUNK={chunk} x10000",
                            probes.gather_reduce(table, idx, sum_bytes=sum_bytes, chunk=chunk, ring=ring),
                            probes.gather_reduce_plain(table, idx, sum_bytes, chunk))
    log("[3b] K5 equals its plain version at every P2/P3/P4 shape, every lane layout and ring depth, "
        "ragged chunks and clamped indices")
    for s_rows in (2048, 8192):
        gen = torch.Generator(device=device).manual_seed(s_rows)
        slab = torch.randint(-(2**31), 2**31, (s_rows, probes.SLAB_LANES), dtype=torch.int32,
                             device=device, generator=gen)
        idx = gp._random_idx(s_rows, s_rows, device, 11)
        # a count that is no multiple of a tile of rows or of a block's
        # tiles, with indices below 0 and past the slab (clamped)
        ragged = torch.cat([idx[: s_rows - 13], torch.tensor(
            [-1, -(2**31), s_rows, s_rows + 7, 2**31 - 1], dtype=torch.int32, device=device)])
        rec.compare("k6_slab_gather", f"P5 S={s_rows} single",
                    probes.slab_gather(slab, idx), probes.slab_gather_plain(slab, idx))
        rec.compare("k6_slab_gather", f"P5 S={s_rows} ragged x{ragged.numel()}",
                    probes.slab_gather(slab, ragged), probes.slab_gather_plain(slab, ragged))
        for seg in (2, 8):
            rec.compare("k6_slab_gather", f"P5 S={s_rows} chain seg={seg}",
                        probes.slab_chain(slab, idx, seg), probes.slab_chain_plain(slab, idx, seg))
        times = time_in_turns(f"k6_slab_gather P5 S={s_rows} single", lambda: probes.slab_gather(slab, idx),
                              lambda: probes.slab_gather_plain(slab, idx), 20, 3)
        if s_rows == 8192:
            # the launch the kernels line reports (P5's shape): a pure move,
            # no operation counted; the one PyTorch call is index_select.
            # Both ways, in turns: per call (the wrapper's or the
            # dispatcher's host work between launches) and the device time
            # of 20 launches replayed from one CUDA graph.
            from avxwindowfmindex_tpu_torch.ops import kernels

            row_b = 4 * probes.SLAB_LANES
            rec.set_bound("k6_slab_gather", [(s_rows, row_b, s_rows)], s_rows * (4 + row_b), 0)
            idx64 = idx.long()
            out_k = torch.empty_like(slab)
            out_l = torch.empty_like(slab)
            fns = {
                "k6": lambda: kernels.k6_slab_gather(slab, idx, out_k),
                "index_select": lambda: torch.index_select(slab, 0, idx64, out=out_l),
            }
            per_call = {name: [] for name in fns}
            replay = {name: [] for name in fns}
            order = list(fns) + list(fns)[::-1]
            for name in order:
                per_call[name].append(cuda_ms(fns[name], 200))
            for name in order:
                replay[name].append(graph_ms(fns[name]))
            for name in fns:
                log(f"  {name} at S={s_rows}: per call {per_call[name][0]:.4f} / {per_call[name][1]:.4f} ms, "
                    f"graph replay {replay[name][0]:.4f} / {replay[name][1]:.4f} ms")
            if not torch.equal(out_k, out_l):
                raise AssertionError("K6 under graph replay differs from index_select")
            log("  the kernels line takes the graph-replay pair: K6 and index_select")
            rec.ms["k6_slab_gather"] = (min(replay["k6"]), times[1])
            rec.library["k6_slab_gather"] = min(replay["index_select"])
            rec.k6 = {name: {"per_call_ms": min(per_call[name]), "graph_replay_ms": min(replay[name])}
                      for name in fns}
        time_in_turns(f"k6_slab_gather P5 S={s_rows} chain seg=8",
                      lambda: probes.slab_chain(slab, idx, 8),
                      lambda: probes.slab_chain_plain(slab, idx, 8), 20, 3)
    log("[3b] K6 equals its plain version at S = 2048 and 8192, single (ragged and "
        "out-of-range indices) and chained")


def phase_enumerate(rec: Record, device: str) -> int:
    """Phase 3e: K7 (``search.enumerate_flat`` on the card) against its
    plain version on the same CUDA tensors, exactly, narrow and wide: crafted
    batches (no range, every range empty, queries without a hit first, in
    the middle and last, a capacity that cuts inside a range and one far
    past the total, capacity 0, u64 ranges above 2^32 and at 2^64 - 10),
    then the benchmark's locate shapes (``tools.kernel_ab.ENUMERATE_SHAPES``:
    locate11's 524,288 ranges of ~60 hits, locate25's 4,194,304 of one)
    at their rounded capacity and cut at half the total, each timed in
    turns; the kernels line takes locate11's time."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import search
    from avxwindowfmindex_tpu_torch.ops import kernels
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import ENUMERATE_SHAPES, enumerate_batch

    err = 0

    def check(what, start, end, cap, wide):
        nonlocal err
        got = search.enumerate_flat(start, end, capacity=cap, wide=wide)
        want = search.enumerate_flat_plain(start, end, capacity=cap, wide=wide)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if g.dtype != w.dtype:
                raise AssertionError(f"[3e] {what}: K7 gives {g.dtype}, not {w.dtype}")
            err = max(err, max_abs_err(g, w))
        if err:
            raise AssertionError(f"[3e] {what}: K7 differs from its plain version by {err}")

    u32 = 2**32
    crafted = {  # name -> (start, end, capacity)
        "no range": ([], [], 8),
        "every range empty": ([5, 9, 100, u32 - 1], [4, 2, 0, 7], 16),
        "no hit first": ([7, 7, 3, 20], [6, 6, 5, 21], 8),
        "no hit in the middle": ([50, 3, 9, 60, 1], [51, 2, 8, 62, 1], 12),
        "no hit last": ([5, 9, 11, 2], [6, 11, 10, 1], 7),
        "a cut inside a range": ([100, 200, 300], [102, 204, 303], 6),
        "far past the total": ([100, 200, 300], [102, 204, 303], 1000),
        "capacity 0": ([10, 40], [12, 41], 0),
        "u64 ranges": ([u32 - 3, -10, 2**40, 2**40 + 9], [u32 + 4, -5, 2**40 + 7, 5], 40),
    }
    for what, (start, end, cap) in crafted.items():
        s = torch.tensor(start, dtype=torch.int64, device=device)
        e = torch.tensor(end, dtype=torch.int64, device=device)
        for wide in (False, True):
            if wide or what != "u64 ranges":
                check(f"{what}, wide={wide}", s, e, cap, wide)
    log(f"[3e] K7 equals its plain version on {len(crafted)} crafted batches, narrow and wide")
    rng = np.random.default_rng(0x3E)
    for name, (n, extra) in ENUMERATE_SHAPES.items():
        start, end, cap = enumerate_batch(n, extra, rng, device)
        total = int(search.range_counts(start, end).sum())
        for c in (cap, total // 2 + 1):
            check(f"{name} capacity {c}", start, end, c, False)
        kernel_ms, plain_ms = time_in_turns(
            f"k7_enumerate {name} ({n} ranges, {total} slots)",
            lambda: search.enumerate_flat(start, end, capacity=cap),
            lambda: search.enumerate_flat_plain(start, end, capacity=cap), 20, 5)
        if name == "locate11":
            rec.ms["k7_enumerate"] = (kernel_ms, plain_ms)
            # 13 B written a slot, 16 B read a range, each once
            rec.set_bound("k7_enumerate", [], 13 * cap + 16 * n, 0)
        del start, end
    torch.cuda.empty_cache()
    rec.err["k7_enumerate"] = err


def phase_bench(rec: Record, engine, kmers, seq_arr, device: str) -> dict:
    """Phase 6: the bench protocol on the phase-4 index, its launches
    counted; then K5 and K6 at the calibration shapes."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import suffix_array
    from avxwindowfmindex_tpu_torch.models import alphabet as alpha
    from avxwindowfmindex_tpu_torch.models.config import AlphabetType
    from avxwindowfmindex_tpu_torch.models.index import as_device, widen_u32
    from avxwindowfmindex_tpu_torch.ops import kernels, probes
    from avxwindowfmindex_tpu_torch.search import locate_flat_device, ngram_ranges, total_hits_host
    from avxwindowfmindex_tpu_torch.tools import bench
    from avxwindowfmindex_tpu_torch.utils import roofline

    index, ng = engine.host_index, engine.ng
    dev = index.to_device(device)  # the config-ratio view, before densify replaces it
    t = time.time()
    dense = index.densify_device_sa(4, device=device)
    torch.cuda.synchronize()
    densify_s = time.time() - t
    t = time.time()
    text = np.concatenate([alpha.sanitize(seq_arr, AlphabetType.DNA), np.frombuffer(b"$", np.uint8)])
    sa = suffix_array.build_suffix_array(text, backend="native")
    rec.compare(
        "k3_backtrace_resolve", f"densify_device_sa(4) == sa[::4] x{dense.sampled_sa.numel()}",
        widen_u32(dense.sampled_sa), torch.from_numpy(sa[::4].astype(np.int64)).to(device),
    )
    log(f"[6] densify_device_sa(4): {densify_s:.4f}s, equal to the host sa[::4] "
        f"(host SA-IS {time.time() - t:.2f}s)")
    del sa, text

    p = bench.Protocol(
        num_bases=len(seq_arr), num_queries=QUERIES, seed_k=MAIN_SEED_K, runs=3,
        multihit_kmer_len=bench.default_multihit_kmer_len(len(seq_arr)),
        multihit_queries=BENCH_MULTIHIT_QUERIES, calib_batch=QUERIES,
    )
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    meta, headline = bench.run_protocol(
        p, index, seq_arr, np.random.default_rng(1235), dev=dev, dev_dense=dense, ng=ng,
        device=as_device(device), build_s=None, digram_build_s=None,
        t_start=time.time(),
    )
    launches = expect_launches("6", ("k2_ranges", "k3_backtrace_resolve", "k4_ngram_ranges",
                                     "k5_gather_reduce", "k6_slab_gather", "k7_enumerate"))
    # every locate_flat_device call of the protocol: one scan, one write
    scan, write = launches["k7_enumerate.scan"], launches["k7_enumerate.write"]
    if scan != write or launches["k7_enumerate"] != scan + write:
        raise AssertionError(f"[6] K7: {scan} scans, {write} writes, "
                             f"{launches['k7_enumerate']} launches")
    log(f"[6] meta: {json.dumps(meta)}")
    log(f"[6] headline: {json.dumps(headline)}")
    # a ceiling is a ceiling: with the masked walk and visit bytes in
    # place no stage may read above its gather ceiling or the HBM rate
    for key, roof in meta.items():
        if key.endswith("_roofline") and roof is not None:
            fractions = (roof["fraction_of_gather_ceiling"], roof["fraction_of_hbm_sol"])
            log(f"[6] {key}: {fractions[0]} of the gather ceiling, {fractions[1]} of the HBM rate, "
                f"{roof['bytes_per_query']} B per query "
                f"(L2-held: {sorted({t for ph in roof['phases'].values() for t in ph['l2_held']})}); "
                f"the card: DRAM busy {roof.get('memory_busy_pct')}%, at most "
                f"{roof.get('dram_bytes_per_query_at_most')} B per query")
            if not all(f is not None and f <= 1 for f in fractions):
                raise AssertionError(f"{key}: a fraction above 1: {fractions}")

    # locate_flat_device by query == SearchEngine.locate on 4,096 queries
    sub = kmers[:4096]
    want = engine.locate(sub)
    mat, _, n = engine.encode_kmers(sub)
    s, e = ngram_ranges(dev, ng, torch.from_numpy(mat).to(device), KMER_LEN)
    s, e = s[:n], e[:n]
    cap = ((total_hits_host(s, e) + 65535) // 65536) * 65536
    hits, qid, mask = locate_flat_device(dev, s, e, capacity=cap)
    mask_h = mask.cpu().numpy()
    lens = np.array([len(w) for w in want])
    if not (np.array_equal(hits.cpu().numpy()[mask_h], np.concatenate(want).astype(np.int64))
            and np.array_equal(qid.cpu().numpy()[mask_h], np.repeat(np.arange(n), lens))):
        raise AssertionError("locate_flat_device differs from SearchEngine.locate")
    log(f"[6] locate_flat_device == SearchEngine.locate on {n} queries ({int(lens.sum())} hits)")

    # K5's walk and K6's chain at the calibration shapes: over whole rows
    # and over the sectors of a first-block visit, which the bench walked
    rng = np.random.default_rng(99)
    tables = {"single": dev.packed, "pair": dev.packed_pair, "ngram_pair": ng.packed}
    visits = roofline.first_block_visits(ngram_n=ng.n)
    for name, table in tables.items():
        idx = torch.from_numpy(rng.integers(0, table.shape[0], size=QUERIES).astype(np.int32)).to(device)
        mask, read = visits[name]
        for what, m, nbytes in (("whole rows", probes.ALL_SECTORS, table.shape[1]),
                                ("first-block visit", mask, read)):
            if what != "whole rows" and read == table.shape[1]:
                continue  # the visit is the whole row
            for seg in (4, 20):
                rec.compare(
                    "k5_gather_reduce",
                    f"walk {name} ({nbytes} of {table.shape[1]} B, {what}) seg={seg} x{QUERIES}",
                    probes.gather_walk(table, idx, seg, m), probes.gather_walk_plain(table, idx, seg, m))
            time_in_turns(
                f"k5_gather_reduce walk {name} {what} seg=20 x{QUERIES}",
                lambda: probes.gather_walk(table, idx, 20, m),
                lambda: probes.gather_walk_plain(table, idx, 20, m), 10, 1,
            )
            # logged, not in the kernels line: every byte read is summed
            rec.set_bound(f"k5 walk {name} {what}", [(table.shape[0], nbytes, QUERIES * 20)],
                          QUERIES * (4 + 4), QUERIES * 20 * nbytes)
    whole_rates = roofline.calibrate_gather_rates(tables, QUERIES, device=device)
    for name in tables:
        log(f"[6] calibrated rate of {name}: {meta['gather_rates_rows_per_sec'][name]} rows/s over the "
            f"{visits[name][1]} B of a first-block visit (the ceilings), {whole_rates[name]:.0f} rows/s "
            f"over whole {tables[name].shape[1]} B rows")
    SLAB_ROWS = roofline.SLAB_ROWS
    gen = torch.Generator(device=device).manual_seed(SLAB_ROWS)
    slab = torch.randint(-(2**31), 2**31, (SLAB_ROWS, probes.SLAB_LANES), dtype=torch.int32,
                         device=device, generator=gen)
    sidx = torch.from_numpy(rng.integers(0, SLAB_ROWS, size=QUERIES).astype(np.int32)).to(device)
    for seg in (4, 20):
        rec.compare("k6_slab_gather", f"slab chain S={SLAB_ROWS} seg={seg} x{QUERIES}",
                    probes.slab_chain(slab, sidx, seg), probes.slab_chain_plain(slab, sidx, seg))
    time_in_turns(
        f"k6_slab_gather chain S={SLAB_ROWS} seg=20 x{QUERIES}",
        lambda: probes.slab_chain(slab, sidx, 20),
        lambda: probes.slab_chain_plain(slab, sidx, 20), 10, 1,
    )
    rec.set_bound("k6 chain", [(SLAB_ROWS, 4 * probes.SLAB_LANES, QUERIES * 20)],
                  QUERIES * (4 + 4), QUERIES * 20 * 3)
    return {"launches": launches, "meta": meta, "headline": headline, "dense": dense,
            "whole_row_rates": {t: round(r) for t, r in whole_rates.items()}}


def phase_wide_main(rec: Record, index, narrow_dev, dense_narrow, kmers, mh_kmers, seq_arr,
                    answers, device: str) -> dict:
    """Phase 4w: the 64-bit path at full width, on the phase-4 index as a
    wide view, held equal to the narrow engines' answers (phase 4's for
    the main batch)."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import SearchEngine, search
    from avxwindowfmindex_tpu_torch.models.index import widen_u32
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, seed_table
    from avxwindowfmindex_tpu_torch.utils.roofline import calibrate_gather_rates

    bases = len(seq_arr)
    seq_bytes = seq_arr.tobytes()
    narrow = SearchEngine(narrow_dev, device=device)  # the ratio-8 narrow view of phase 4
    stats = {}

    kernels.reset_launch_counts()
    t = time.time()
    wide = SearchEngine(index, device=device, wide=True)
    torch.cuda.synchronize()
    dev = wide.dev
    stats["wide_view_s"] = time.time() - t
    log(
        f"[4w] wide view: {dev.packed.shape[0]} rows x {dev.packed.shape[1]} B, seed table "
        f"{tuple(dev.seed_table.shape)} {dev.seed_table.dtype}, SA ratio {dev.ratio}: "
        f"{stats['wide_view_s']:.3f}s (host packing + upload, seed table widened on the card)"
    )
    if not (dev.wide and dev.ratio == narrow_dev.ratio):
        raise AssertionError("phase 4w needs the wide view at the config ratio")
    if not torch.equal(dev.seed_table, widen_u32(narrow_dev.seed_table)):
        raise AssertionError("the widened k=14 seed table differs from the narrow one")
    # the wide view's own BFS, as attach_seed_table runs it on a wide index,
    # at k = 13 (the k = 14 table of 4.3 GB is widened, not rebuilt)
    k_wide = MAIN_SEED_K - 1
    t = time.time()
    bfs_wide = seed_table.build_seed_table(dev, dev.cardinality, k_wide, index.prefix_sums)
    torch.cuda.synchronize()
    stats["seed_table_k13_wide_s"] = time.time() - t
    t = time.time()
    bfs_narrow = seed_table.build_seed_table(narrow_dev, dev.cardinality, k_wide, index.prefix_sums)
    torch.cuda.synchronize()
    stats["seed_table_k13_narrow_s"] = time.time() - t
    rec.compare("k1w_extend", f"seed table k={k_wide}: BFS through K1WX == the narrow BFS, widened",
                bfs_wide, widen_u32(bfs_narrow))
    log(f"[4w] seed table k={k_wide}: through K1WX {stats['seed_table_k13_wide_s']:.4f}s, "
        f"through K1X {stats['seed_table_k13_narrow_s']:.4f}s (host clock)")
    del bfs_wide, bfs_narrow

    rng = np.random.default_rng(4321)
    sample = rng.integers(0, QUERIES, size=32)
    want = np.array([count_overlapping(seq_bytes, kmers[i]) for i in sample])
    windows = np.lib.stride_tricks.sliding_window_view(seq_arr, KMER_LEN)

    # the narrow answers are phase 4's (its digram and single-step engines
    # gave the same, in the same order), timed there
    w_counts, count_s, count_times = timed_engine_call(wide.count, kmers)
    hits, locate_s, locate_times = timed_engine_call(wide.locate, kmers)
    stats["wide_count_qps"] = QUERIES / count_s
    stats["wide_locate_qps"] = QUERIES / locate_s
    log(f"[4w] wide count {QUERIES} x {KMER_LEN}-mers: median {count_s:.4f}s of "
        f"{count_times} -> {QUERIES / count_s:.1f} q/s")
    log(f"[4w] wide locate {QUERIES} x {KMER_LEN}-mers: median {locate_s:.4f}s of "
        f"{locate_times} -> {QUERIES / locate_s:.1f} q/s")
    w_lens, w_flat = np.array([len(h) for h in hits]), np.concatenate(hits)
    del hits
    n_counts, n_lens, n_flat = answers
    if not (np.array_equal(w_counts, n_counts) and np.array_equal(w_lens, n_lens)
            and np.array_equal(w_flat, n_flat)):
        raise AssertionError("wide count or locate differs from the narrow engine's")
    log(f"[4w] wide == narrow on all {QUERIES} queries: counts and {len(w_flat)} hits, in order")
    if not ((w_counts >= 1).all() and (w_counts[sample] == want).all()):
        raise AssertionError(f"wide count spot check: {w_counts[sample]} != {want}")
    flat = w_flat.astype(np.int64)
    qid = np.repeat(np.arange(QUERIES), w_lens)
    kmer_ascii = np.frombuffer(b"".join(kmers), np.uint8).reshape(QUERIES, KMER_LEN)
    if (flat > bases - KMER_LEN).any() or not (windows[flat] == kmer_ascii[qid]).all():
        raise AssertionError("wide locate returned a non-matching position")
    log("[4w] wide count spot check 32/32 exact vs host scan; every wide hit matches its window")
    del flat, qid

    mh_n = narrow.locate(mh_kmers)
    t = time.time()
    mh_w = wide.locate(mh_kmers)
    mh_s = time.time() - t
    mh_lens = np.array([len(h) for h in mh_w])
    if not all(np.array_equal(a, b) for a, b in zip(mh_w, mh_n)):
        raise AssertionError("wide multi-hit locate differs from the narrow engine's")
    mh_windows = np.lib.stride_tricks.sliding_window_view(seq_arr, MULTIHIT_LEN)
    mh_ascii = np.frombuffer(b"".join(mh_kmers), np.uint8).reshape(len(mh_kmers), MULTIHIT_LEN)
    mh_flat = np.concatenate(mh_w).astype(np.int64)
    if not (mh_windows[mh_flat] == mh_ascii[np.repeat(np.arange(len(mh_kmers)), mh_lens)]).all():
        raise AssertionError("wide multi-hit locate returned a non-matching position")
    freq = int(np.argmax(mh_lens))
    freq_want = count_overlapping(seq_bytes, mh_kmers[freq])
    if mh_lens[freq] != freq_want:
        raise AssertionError(f"wide multi-hit completeness: {mh_lens[freq]} != {freq_want}")
    stats["wide_multihit_qps"] = len(mh_kmers) / mh_s
    log(f"[4w] wide multi-hit locate {len(mh_kmers)} x {MULTIHIT_LEN}-mers: {len(mh_flat)} hits in "
        f"{mh_s:.4f}s, equal to the narrow engine's, all sound, most frequent complete ({freq_want})")

    t = time.time()
    dense = index.densify_device_sa(4, device=device)  # finds the wide view installed
    torch.cuda.synchronize()
    stats["wide_densify_s"] = time.time() - t
    if not (dense.wide and dense.ratio == 4):
        raise AssertionError("densify_device_sa did not densify the wide view")
    rec.compare("k3w_backtrace_resolve",
                f"wide densify_device_sa(4) == the narrow one x{dense.sampled_sa.numel()}",
                dense.sampled_sa, widen_u32(dense_narrow.sampled_sa))
    log(f"[4w] wide densify_device_sa(4): {stats['wide_densify_s']:.4f}s")
    stats["launches"] = expect_launches("4w", WIDE_PATH_KERNELS, exact={
        "k1w_extend": seed_table.bfs_launches(dev, k_wide), "k1w_extend.bfs": 1})
    del dense
    stats["bfs"] = bfs_routes(rec, dev, k_wide, index.prefix_sums, "4w", "k1w_extend")

    # each wide kernel against its plain version at this path's shapes
    b = 2 * seed_table.CHUNK
    rng = np.random.default_rng(99)
    occ_pos = torch.from_numpy(rng.integers(0, dev.bwt_length, size=b)).to(device)
    occ_lett = torch.from_numpy(rng.integers(0, dev.cardinality, size=b).astype(np.int32)).to(device)
    rec.compare("k1w_rank", f"main occ x{b}", kernels.k1_occurrence(dev, occ_pos, occ_lett),
                rank.occurrence_plain(dev, occ_pos, occ_lett))
    mat, lengths, n = wide.encode_kmers(kmers)
    seeded = wide._seed_eligibility(mat, lengths)
    args = (
        torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
        torch.from_numpy(seeded.astype(np.uint8)).to(device),
    )
    ws, we = search.search_ranges(dev, *args)
    k2w_classes = torch.zeros(3, dtype=torch.int64, device=device)
    ps, pe = search.ranges_plain(dev, *args, k2w_classes)
    rec.compare("k2w_ranges", f"main start x{n}", ws, ps)
    rec.compare("k2w_ranges", f"main end x{n}", we, pe)
    del ps, pe
    counts = search.range_counts(ws[:n], we[:n], wide=True)
    positions = search.enumerate_range_positions(ws[:n], counts)
    rec.compare("k3w_backtrace_resolve", f"main hits x{positions.numel()}",
                search.backtrace_resolve(dev, positions), search.backtrace_resolve_plain(dev, positions))
    rec.ms["k1w_rank"] = time_in_turns(
        f"k1w_rank main x{b}", lambda: kernels.k1_occurrence(dev, occ_pos, occ_lett),
        lambda: rank.occurrence_plain(dev, occ_pos, occ_lett), 10, 2)
    rec.ms["k2w_ranges"] = time_in_turns(
        f"k2w_ranges main x{n}", lambda: kernels.k2_ranges(dev, *args),
        lambda: search.ranges_plain(dev, *args), 10, 1)
    rec.ms["k3w_backtrace_resolve"] = time_in_turns(
        f"k3w_backtrace_resolve main x{positions.numel()}",
        lambda: kernels.k3_backtrace_resolve(dev, positions),
        lambda: search.backtrace_resolve_plain(dev, positions), 10, 1)
    set_index_bounds(rec, WIDE_INDEX_KERNELS, dev, b, args[0], positions, k2w_classes.tolist())
    for narrow_name, wide_name in zip(INDEX_KERNELS, WIDE_INDEX_KERNELS):
        log(f"[4w] {wide_name} {rec.ms[wide_name][0]:.4f} ms against {narrow_name} "
            f"{rec.ms[narrow_name][0]:.4f} ms at the same shape "
            f"({rec.ms[wide_name][0] / rec.ms[narrow_name][0]:.3f}x)")
    stats["gather_rate_rows_per_sec"] = calibrate_gather_rates(
        {"wide": dev.packed}, QUERIES, device=device)["wide"]
    log(f"[4w] calibrated random-row rate of the wide table ({dev.packed.shape[1]} B rows): "
        f"{stats['gather_rate_rows_per_sec']:.0f} rows/s")
    return stats


def phase_straddle(rec: Record, device: str, boundary: int = 2**32) -> dict:
    """Phase 4x: K1w, K2w, K1WX and K3w on a table of more than 2^32
    positions (``boundary``, smaller only for trials: the table holds
    boundary + boundary / 16 positions and the checks look across
    ``boundary``)."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import search
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import (
        closed_form_occ, straddle_table, straddle_view)

    # mostly ACGT, so that T's whole-letter range [C[3], C[4]) straddles
    # the boundary, with a few ambiguity letters
    t = time.time()
    info = straddle_table(device, boundary, seed=4096, pair=True)
    table, nb, n, rng = info["table"], info["nb"], info["n"], info["rng"]
    dev = straddle_view(info, device)
    card = dev.cardinality
    torch.cuda.synchronize()
    ps = dev.prefix_sums.cpu().numpy().view(np.uint64)
    log(f"[4x] table of {n} positions ({boundary} + {n - boundary}): {nb} rows x 256 B = "
        f"{table.numel() / 1e9:.2f} GB, tiled and given its milestones on the card in "
        f"{time.time() - t:.2f}s; C = {ps.tolist()}")
    if not (ps[3] < boundary < ps[4]):
        raise AssertionError("T's range must straddle the boundary")

    # K1w occ: around the boundary and anywhere, against the closed form
    m = 1 << 20
    pos = np.concatenate([rng.integers(boundary - 5000, boundary + 5000, m), rng.integers(0, n, m),
                          [boundary - 1, boundary, boundary + 255, n - 1]]).astype(np.int64)
    lett = rng.integers(0, card + 1, size=len(pos)).astype(np.int32)
    want = closed_form_occ(info, pos, lett)
    pos_t = torch.from_numpy(pos).to(device)
    lett_t = torch.from_numpy(lett).to(device)
    got = kernels.k1_occurrence(dev, pos_t, lett_t)
    rec.compare("k1w_rank", f"straddle occ vs the closed form x{len(pos)}", got,
                torch.from_numpy(want).to(device))
    rec.compare("k1w_rank", f"straddle occ vs plain x{len(pos)}", got,
                rank.occurrence_plain(dev, pos_t, lett_t))
    if not (int(got.max()) > boundary // 8 and int(pos_t.max()) > boundary):
        raise AssertionError("the straddle positions did not pass the boundary")
    kl, kf = kernels.k1_letter_and_lf(dev, pos_t)
    pl, pf = rank.letter_and_lf_plain(dev, pos_t)
    rec.compare("k1w_rank", f"straddle letter x{len(pos)}", kl, pl)
    rec.compare("k1w_rank", f"straddle LF x{len(pos)}", kf, pf)
    if int(kf.max()) < boundary:
        raise AssertionError("no LF value above the boundary")
    # K1w's single-query modes with start - 1 and end on both sides of 2^32
    single_edges(rec, dev, rng, "[4x]", around=[boundary + d for d in (-300, -257, -256, -1, 1, 2, 256)]
                 + [int(ps[3]), int(ps[4]) - 1])

    # K2w: unseeded queries start from whole-letter ranges; those ending in
    # T start on a range that straddles the boundary and step through
    # ranges on both sides of it
    qn, qlen = 1 << 16, 12
    mat = rng.integers(0, card, size=(qn, qlen)).astype(np.uint8)
    lengths = rng.integers(1, qlen + 1, size=qn).astype(np.int32)
    mat[: qn // 2, :] = np.where(rng.random((qn // 2, qlen)) < 0.7, 3, mat[: qn // 2, :])
    args = (torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
            torch.zeros(qn, dtype=torch.uint8, device=device))
    ks, ke = kernels.k2_ranges(dev, *args)
    ps_, pe_ = search.ranges_plain(dev, *args)
    rec.compare("k2w_ranges", f"straddle start x{qn}", ks, ps_)
    rec.compare("k2w_ranges", f"straddle end x{qn}", ke, pe_)
    valid = ks <= ke
    above = int((valid & (ks >= boundary)).sum())
    across = int((valid & (ks < boundary) & (ke >= boundary)).sum())
    if above == 0 or across == 0:
        raise AssertionError(f"K2w's final ranges never passed {boundary} ({above} above, {across} across)")
    log(f"[4x] K1w and K2w exact on the table above {boundary}: {across} final ranges straddle it, "
        f"{above} lie above it, {int(valid.sum())} of {qn} valid")

    # K1WX: one BFS depth over parents around the boundary, ranges up to 600
    # positions wide (one row or two) and as many absent ones (start > end)
    m = 1 << 18
    starts = rng.integers(boundary - 5000, boundary + 5000, m).astype(np.uint64)
    widths = rng.integers(0, 600, m).astype(np.uint64)
    ends = np.where(np.arange(m) % 2 == 0, starts + widths, starts - widths - np.uint64(1))
    parents = torch.from_numpy(np.stack([starts, ends], axis=1).view(np.int64)).to(device)
    got = kernels.k1_extend(dev, parents)
    rec.compare("k1w_extend", f"straddle extend x{m} parents", got,
                seed_table.extend_level_plain(dev, parents))
    if not (int(got[:, 0].max()) > boundary and int(got[:, 0].min()) < boundary):
        raise AssertionError(f"the extend's children did not straddle {boundary}")
    log(f"[4x] K1WX exact on {m} parents around {boundary}: {4 * m} children")
    del parents, got
    stats = straddle_backtrace(rec, dev, rng, boundary)
    del info, table, dev
    torch.cuda.empty_cache()
    return stats


def straddle_backtrace(rec: Record, dev, rng, boundary: int) -> dict:
    """Phase 4x's K3w: its (position, offset) output (the view has no
    sampled SA) on starts within 2^20 of ``boundary`` on both sides, held
    exactly to the plain version, then timed over random starts across
    the whole table, both picked by ``short_walks``."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import search
    from avxwindowfmindex_tpu_torch.ops import kernels
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import short_walks

    span = min(2**20, boundary // 16)
    near = np.concatenate([rng.integers(boundary - span, boundary, 4096),
                           rng.integers(boundary, boundary + span, 4096)])
    near = short_walks(dev, torch.from_numpy(near).to(dev.packed.device))
    kp, koff = kernels.k3_backtrace_resolve(dev, near)
    pp, poff = search.backtrace_resolve_plain(dev, near)
    rec.compare("k3w_backtrace_resolve", f"straddle sampled positions x{near.numel()}", kp, pp)
    rec.compare("k3w_backtrace_resolve", f"straddle walk offsets x{near.numel()}", koff, poff)
    above = int(((near >= boundary) & (koff > 0)).sum())
    below = int(((near < boundary) & (koff > 0)).sum())
    if above == 0 or below == 0:
        raise AssertionError(f"K3w walked from {above} starts above {boundary} and {below} below")
    spread = short_walks(dev, torch.from_numpy(rng.integers(0, dev.bwt_length, 1 << 20)).to(
        dev.packed.device))
    _, off = kernels.k3_backtrace_resolve(dev, spread)
    steps = int(off.sum())
    ms = min(cuda_ms(lambda: kernels.k3_backtrace_resolve(dev, spread), 10) for _ in range(2))
    piece_ms = steps * (dev.n_planes + 1) * 64 / HBM_BYTES_PER_S * 1e3
    log(f"[4x] K3w exact on {near.numel()} starts within 2^20 of {boundary} ({above} walks from above "
        f"it, {below} from below, {int(koff.sum())} LF steps); over {spread.numel()} starts across the "
        f"{dev.packed.numel() / 1e9:.2f} GB table: {ms:.4f} ms for {steps} LF steps "
        f"({steps / ms / 1e6:.3f}G steps/s), piece model {piece_ms:.4f} ms")
    return {"k3w_starts": spread.numel(), "k3w_lf_steps": steps, "k3w_ms": ms,
            "k3w_piece_model_ms": piece_ms}


def phase_roundtrip(index, text: bytes, device: str) -> str:
    """Phase 5: .awfmi write, read back, equal counts and locates. Returns
    the file's path (phase 7c reloads from it)."""
    import numpy as np
    from avxwindowfmindex_tpu_torch import SearchEngine, read_index_from_file, write_index_to_file

    out_dir = os.path.join(REPO, "avxwindowfmindex_tpu_torch", "build", "chip_smoke")
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "smoke.awfmi")
    write_index_to_file(index, path)
    rng = np.random.default_rng(11)
    qs = [text[s : s + int(rng.integers(4, 20))] for s in rng.integers(0, len(text) - 20, 4096)]
    want_c = SearchEngine(index, device=device).count(qs)
    want_l = SearchEngine(index, device=device).locate(qs)
    for in_memory in (True, False):
        eng = SearchEngine(read_index_from_file(path, in_memory), device=device)
        if not (eng.count(qs) == want_c).all():
            raise AssertionError(f"round trip counts differ (SA in memory: {in_memory})")
        if not all((a == b).all() for a, b in zip(eng.locate(qs), want_l)):
            raise AssertionError(f"round trip locates differ (SA in memory: {in_memory})")
    log(f"[5] .awfmi round trip: {len(qs)} counts and locates equal (SA in memory and on disk)")
    return path

def same_locates(got, lens, flat) -> bool:
    """``got`` (one hit array per query) equals phase 4's answers given as
    per-query lengths and the flat hits."""
    import numpy as np

    return (len(got) == len(lens)
            and np.array_equal(np.array([len(h) for h in got]), lens)
            and np.array_equal(np.concatenate(got).astype(np.uint64), flat))


def timed_call(fn, *args):
    import torch

    t = time.time()
    out = fn(*args)
    torch.cuda.synchronize()
    return out, time.time() - t


def host_copies(fn, *args):
    """``(fn(*args), copies)``: every copy of a CUDA tensor of more than
    one element to the host during the call, as (elements, K3 launches so
    far), so a caller can tell whether ranges left the card before the
    backtrace."""
    from unittest import mock

    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels

    seen = []
    real_cpu, real_to = torch.Tensor.cpu, torch.Tensor.to

    def cpu(t, *a, **kw):
        if t.is_cuda and t.numel() > 1:
            seen.append((t.numel(), kernels.K3.launches))
        return real_cpu(t, *a, **kw)

    def to(t, *a, **kw):
        out = real_to(t, *a, **kw)
        if t.is_cuda and not out.is_cuda and t.numel() > 1:
            seen.append((t.numel(), kernels.K3.launches))
        return out

    with mock.patch.object(torch.Tensor, "cpu", cpu), mock.patch.object(torch.Tensor, "to", to):
        return fn(*args), seen


def phase_public_api(engine, kmers, seq_arr, answers, small_index, small_text: bytes,
                     small_path: str, main: dict, device: str) -> dict:
    """Phase 7: the public API at full size, on the phase-4 index (64M
    bases, k = 14, ratio 8): .awfmx artifacts (7a), the batch API (7b),
    the retrying engine (7c), the chunked corpus (7d) and the
    query-parallel engine (7e); each part's launches reset before it and
    read after it. ``main``: phase 4's stats, whose build time and API q/s
    (same process) the chunked and query-parallel engines are set beside."""
    import functools

    import numpy as np
    import torch
    import avxwindowfmindex_tpu_torch as pt
    from avxwindowfmindex_tpu_torch import build as build_mod
    from avxwindowfmindex_tpu_torch.io import artifact
    from avxwindowfmindex_tpu_torch.ops import kernels, seed_table
    from avxwindowfmindex_tpu_torch.parallel import api, chunked, dist, reliability

    index = engine.host_index
    counts, lens, flat = answers
    stats = {}
    out_dir = os.path.dirname(small_path)

    # 7a. artifacts: the 64M index without its seed table, rebuilt by K1X
    path = os.path.join(out_dir, "main.awfmx")
    t = time.time()
    artifact.save_artifact(index, path, compress=False)
    stats["save_s"] = time.time() - t
    stats["file_mb"] = os.path.getsize(path) / 1e6
    rebuild = []
    real_attach = build_mod.attach_seed_table

    def timed_attach(idx, dev, *rest):
        t0 = time.time()
        real_attach(idx, dev, *rest)
        torch.cuda.synchronize()
        rebuild.append(time.time() - t0)

    kernels.reset_launch_counts()
    build_mod.attach_seed_table = timed_attach
    try:
        loaded, stats["load_s"] = timed_call(functools.partial(artifact.load_artifact, device=device),
                                             path)
    finally:
        build_mod.attach_seed_table = real_attach
    stats["launches_7a"] = expect_launches("7a", ("k1_extend",), exact={
        "k1_extend": seed_table.bfs_launches(engine.dev, MAIN_SEED_K), "k1_rank": 0})
    stats["rebuild_s"] = rebuild[0]
    with np.load(path) as z:
        if "kmer_seed_table" in z:
            raise AssertionError("the artifact of an index built on the card carries its seed table")
    if not torch.equal(loaded._device_cache.seed_table, engine.dev.seed_table):
        raise AssertionError("the seed table rebuilt by load_artifact differs from phase 4's")
    log(f"[7a] save_artifact(compress=False) {stats['save_s']:.3f}s, {stats['file_mb']:.1f} MB "
        f"without the seed table; load_artifact {stats['load_s']:.3f}s, of which the view and "
        f"K1X's BFS {stats['rebuild_s']:.3f}s; seed table torch.equal to phase 4's")
    kernels.reset_launch_counts()
    t = time.time()
    dg = pt.DigramSearchEngine(loaded, device=device)
    got_c = dg.count(kmers)
    got_l = dg.locate(kmers)
    if not (np.array_equal(got_c, counts) and same_locates(got_l, lens, flat)):
        raise AssertionError("the loaded index's digram answers differ from phase 4's")
    expect_launches("7a", ("k4_ngram_ranges", "k3_backtrace_resolve"))
    log(f"[7a] DigramSearchEngine over the loaded index: {len(kmers)} counts and "
        f"{len(flat)} hits equal to phase 4's ({time.time() - t:.3f}s with its n-gram table)")
    del dg, got_l, loaded
    os.remove(path)

    small = os.path.join(out_dir, "small.awfmx")
    artifact.save_artifact(small_index, small, pull_device_seed_table=True)
    kernels.reset_launch_counts()
    small_loaded = artifact.load_artifact(small, device=device)
    if kernels.K1.launches or kernels.K1X.launches:
        raise AssertionError("a file that carries its seed table launched K1 or K1X")
    if not np.array_equal(small_loaded.kmer_seed_table, small_index.seed_table_host()):
        raise AssertionError("the pulled seed table did not round-trip")
    log("[7a] the 1M-base index saved with pull_device_seed_table=True loads with 0 K1 and 0 K1X "
        "launches")
    os.remove(small)
    del small_loaded

    # 7b. the batch API and the search-list shim on 65,536 of the 25-mers
    sub = kmers[:1 << 16]
    single = pt.SearchEngine(engine.dev, device=device)
    want_c, want_l = single.count(sub), single.locate(sub)
    kernels.reset_launch_counts()
    got_c = pt.parallel_search_count(index, sub, device=device)
    got_l = pt.parallel_search_locate(index, sub, num_threads=8, device=device)
    if not (np.array_equal(got_c, want_c) and all(np.array_equal(a, b) for a, b in zip(got_l, want_l))
            and len(got_l) == len(want_l)):
        raise AssertionError("parallel_search_* differ from SearchEngine's")
    if pt.parallel_search_count(index, [], device=device).shape != (0,) or \
            pt.parallel_search_locate(index, [], device=device) != []:
        raise AssertionError("an empty list must return an empty result")
    slist = api.create_kmer_search_list(4096)
    slist.set_kmers(sub[:4096])
    slist.search_count(index, device=device)
    slist.search_locate(index, device=device)
    if not all(d.count == int(c) and np.array_equal(d.position_list, w)
               for d, c, w in zip(slist.kmer_search_data, want_c, want_l)):
        raise AssertionError("KmerSearchList differs from SearchEngine's")
    expect_launches("7b", ("k2_ranges", "k3_backtrace_resolve"))
    log(f"[7b] parallel_search_count / _locate of {len(sub)} 25-mers == SearchEngine's; empty "
        f"list -> empty; a KmerSearchList round of {len(sub[:4096])} equal")
    del got_l, want_l, slist

    # 7c. the retrying engine: a fault injected on the first call, then
    # the 64M index in shards of 2^18
    class Flaky(pt.SearchEngine):
        failures = 1

        def count(self, kmers_):
            if Flaky.failures:
                Flaky.failures -= 1
                raise RuntimeError("injected fault")
            return super().count(kmers_)

    rng = np.random.default_rng(71)
    sm_q = [small_text[s : s + int(rng.integers(4, 20))]
            for s in rng.integers(0, len(small_text) - 20, 4096)]
    small_eng = pt.SearchEngine(small_index, device=device)
    reloaded = pt.read_index_from_file(small_path)
    kernels.reset_launch_counts()
    rel = reliability.ReliableSearchEngine(
        reloaded, shard_size=1024,
        policy=reliability.RetryPolicy(max_attempts=3, backoff_seconds=0.0),
        engine_factory=functools.partial(Flaky, device=device),
    )
    got = rel.count(sm_q)
    if not np.array_equal(got, small_eng.count(sm_q)):
        raise AssertionError("the retried counts differ")
    if rel.stats != {"shards": 4, "retries": 1, "reloads": 1} or rel.index is reloaded:
        raise AssertionError(f"retry statistics {rel.stats}")
    expect_launches("7c", ("k2_ranges",))
    log(f"[7c] a RuntimeError on the first shard: retried after a reload from {small_path}, "
        f"answers equal, stats {rel.stats}")
    n_shards = -(-len(kmers) // (1 << 18))
    kernels.reset_launch_counts()
    rel = reliability.ReliableSearchEngine(index, shard_size=1 << 18, device=device)
    (got_c, got_l), rel_s = timed_call(lambda: (rel.count(kmers), rel.locate(kmers)))
    if not (np.array_equal(got_c, counts) and same_locates(got_l, lens, flat)):
        raise AssertionError("the sharded retrying engine's answers differ from phase 4's")
    if rel.stats != {"shards": 2 * n_shards, "retries": 0, "reloads": 0}:
        raise AssertionError(f"retry statistics {rel.stats}")
    expect_launches("7c", ("k2_ranges", "k3_backtrace_resolve"),
                    exact={"k2_ranges": 2 * n_shards, "k3_backtrace_resolve": n_shards})
    log(f"[7c] ReliableSearchEngine, shards of 2^18: {len(kmers)} counts and locates equal to "
        f"phase 4's in {rel_s:.3f}s, stats {rel.stats}")
    del got_l, rel, small_eng, reloaded
    os.remove(small_path)

    # 7d. the chunked corpus: chunks of 2^24 bases, overlap 255, digram engines
    boundaries = list(range(CHUNK_BASES, len(seq_arr), CHUNK_BASES))
    kernels.reset_launch_counts()
    t = time.time()
    chunks = chunked.ChunkedCorpusIndex.build(
        seq_arr, index.config, chunk_bases=CHUNK_BASES, overlap=255,
        engine_factory=functools.partial(pt.DigramSearchEngine, device=device), device=device,
    )
    torch.cuda.synchronize()
    stats["chunked_build_s"] = time.time() - t
    if chunks.num_chunks != len(boundaries) + 1 or len(chunks.junction_texts) != len(boundaries):
        raise AssertionError(f"{chunks.num_chunks} chunks, {len(chunks.junction_texts)} junctions")
    ch_c, stats["chunked_count_s"] = timed_call(chunks.count, kmers)
    ch_l, stats["chunked_locate_s"] = timed_call(chunks.locate, kmers)
    if not np.array_equal(ch_c, counts):
        raise AssertionError("chunked counts differ from phase 4's")
    # phase 4's hits per query are in range order; the chunked merge sorts them
    order = np.concatenate([np.sort(h) for h in np.split(flat, np.cumsum(lens)[:-1])])
    if not same_locates(ch_l, lens, order):
        raise AssertionError("chunked locates differ from phase 4's")
    del ch_l, order
    rng = np.random.default_rng(72)
    cross = [seq_arr[s : s + KMER_LEN].tobytes()
             for b in boundaries for s in rng.integers(b - KMER_LEN + 1, b, 4096)]
    want_c, want_l = engine.count(cross), engine.locate(cross)
    got_c, got_l = chunks.count(cross), chunks.locate(cross)
    if not (np.array_equal(got_c, want_c) and all(
            np.array_equal(a, np.sort(b)) for a, b in zip(got_l, want_l))):
        raise AssertionError("chunked answers across the boundaries differ from the monolithic engine's")
    stats["launches_7d"] = expect_launches(
        "7d", ("k1_extend", "k2_ranges", "k3_backtrace_resolve", "k4_ngram_ranges"),
        exact={"k1_rank": 0})
    log(f"[7d] chunked corpus: {chunks.num_chunks} chunks of {CHUNK_BASES} + 255 bases, digram "
        f"engines, built in {stats['chunked_build_s']:.3f}s (phase 4's monolithic index and n-gram "
        f"table: {main['build_s'] + main['ngram_build_s']:.3f}s); {len(kmers)} counts and locates "
        f"equal to phase 4's, "
        f"{len(cross)} 25-mers across the {len(boundaries)} boundaries equal to the monolithic "
        f"engine's")
    for op in ("count", "locate"):
        log(f"[7d] {op} {len(kmers)} x {KMER_LEN}-mers: chunked {stats[f'chunked_{op}_s']:.3f}s "
            f"-> {len(kmers) / stats[f'chunked_{op}_s']:.1f} q/s; the monolithic "
            f"DigramSearchEngine (phase 4's median) {main[f'digram_{op}_qps']:.1f} q/s")
    del chunks
    torch.cuda.empty_cache()

    # 7e. the query-parallel engine: every card, or two parts on the one card
    devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
               if torch.cuda.device_count() > 1 else [device, device])
    par = dist.DistributedSearchEngine(index, devices)
    n_part = len(devices)
    kernels.reset_launch_counts()
    got_c, stats["dist_count_s"] = timed_call(par.count, kmers)
    expect_launches("7e", ("k2_ranges",), exact={"k2_ranges": n_part})
    kernels.reset_launch_counts()
    (got_l, host_reads), first_s = timed_call(host_copies, par.locate, kmers)
    expect_launches("7e", ("k2_ranges", "k3_backtrace_resolve"),
                    exact={"k2_ranges": n_part, "k3_backtrace_resolve": n_part})
    early = [c for c in host_reads if c[1] < n_part]
    if early or not host_reads:
        raise AssertionError(f"locate copied {early or 'nothing'} to the host before every "
                             f"part's K3 had launched; only hits and counts may come back")
    # phase 4's medians follow a warm-up call: time a second call beside them
    again, stats["dist_locate_s"] = timed_call(par.locate, kmers)
    if not same_locates(again, lens, flat):
        raise AssertionError("the query-parallel engine's second locate differs from phase 4's")
    del again
    kernels.reset_launch_counts()
    rep_c, stats["dist_count_replicated_s"] = timed_call(par.count_replicated, kmers)
    expect_launches("7e", ("k2_ranges",), exact={"k2_ranges": n_part})
    if not (np.array_equal(got_c, counts) and np.array_equal(rep_c, counts)
            and same_locates(got_l, lens, flat)):
        raise AssertionError("the query-parallel engine's answers differ from phase 4's")
    copies = list(par.replicated_counts.values())
    if not all(torch.equal(c.cpu(), copies[0].cpu()) for c in copies):
        raise AssertionError("the replicated counts differ between devices")
    del got_l
    log(f"[7e] DistributedSearchEngine over {devices}: count, locate and count_replicated of "
        f"{len(kmers)} 25-mers equal to phase 4's; K2 once a part; locate copied "
        f"{len(host_reads)} tensors to the host, all after the last part's K3 "
        f"(elements {[c[0] for c in host_reads]}); its first call {first_s:.3f}s")
    for op in ("count", "locate"):
        log(f"[7e] {op}: {n_part} parts {stats[f'dist_{op}_s']:.3f}s -> "
            f"{len(kmers) / stats[f'dist_{op}_s']:.1f} q/s; SearchEngine (phase 4's median) "
            f"{main[f'single_{op}_qps']:.1f} q/s")
    log(f"[7e] count_replicated: {stats['dist_count_replicated_s']:.3f}s -> "
        f"{len(kmers) / stats['dist_count_replicated_s']:.1f} q/s")
    del par
    wide_view = index.to_device(device, wide=True)
    wpar = dist.DistributedSearchEngine(wide_view, devices)
    kernels.reset_launch_counts()
    got_c, stats["dist_wide_count_s"] = timed_call(wpar.count, kmers)
    expect_launches("7e", ("k2w_ranges",), exact={"k2w_ranges": n_part})
    if not np.array_equal(got_c, counts):
        raise AssertionError("the query-parallel engine's wide counts differ from narrow")
    log(f"[7e] the same over the forced-wide view: {len(kmers)} counts equal to narrow, "
        f"K2w once a part, {stats['dist_wide_count_s']:.3f}s")
    del wpar
    return stats


def rs_edge_positions(eng) -> list:
    """Phase 8a's crafted positions: every shard's first and last block
    (their first and last position), the zero padding of the last shard,
    ``start - 1`` at ``start == 0`` (u32 0xFFFFFFFF; u64 2^64 - 1), past
    the padded table; wide: above 2^32 and with bit 39 set (its block
    reads negative as int32)."""
    bps, n = eng.blocks_per_shard, eng.n_dev
    out = []
    for i in range(n):
        for blk in (i * bps, (i + 1) * bps - 1):
            out += [blk * 256, blk * 256 + 255]
    top = bps * n * 256
    out += [eng.host_index.bwt_length - 1, eng.host_index.bwt_length, top - 1, top, top + 300,
            2**32 - 1]
    if eng.wide:
        out += [2**64 - 1, 2**32 + 5, 2**39, 2**39 + 777, 2**40 + 5, 2**63 + 9]
    return out


def routed_step(shards, first_blocks, bps: int, wide: bool, pos, out, *, letters_in=None,
                ratio: int = 0, off=None, letters=None, unowned: int = 0, plain: bool = False):
    """One routed step over ``shards`` on the current stream: the route, then
    each shard over its slice, through the kernels (``plain``: their plain
    versions); occ mode with ``letters_in``, else LF mode. Returns the
    route's (slot_pos, slot_lane, counts)."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels, sharded

    n = len(shards)
    counts = torch.empty(n + 1, dtype=torch.int32, device=pos.device)
    route = sharded.route_plain if plain else kernels.k1r_route
    slot_pos, slot_lane = route(pos, out, n, bps, wide, unowned, counts, ratio, off, letters)
    for i, (shard, fb) in enumerate(zip(shards, first_blocks)):
        if letters_in is not None:
            fn = sharded.shard_occurrence_plain if plain else kernels.k1r_occurrence
            fn(shard, fb, slot_pos, slot_lane, counts, i, letters_in, out)
        else:
            fn = sharded.shard_lf_plain if plain else kernels.k1r_lf
            fn(shard, fb, slot_pos, slot_lane, counts, i, out, letters)
    return slot_pos, slot_lane, counts


def slices_by_lane(slot_pos, slot_lane, counts, n: int):
    """The route's slices, each sorted by lane: (totals, lanes, positions),
    comparable whatever order the route wrote them in."""
    import torch

    sizes = [int(c) for c in counts[:n].tolist()]
    lanes, pos, begin = [], [], 0
    for c in sizes:
        lane = slot_lane[begin : begin + c].to(torch.int64)
        order = torch.argsort(lane)
        lanes.append(lane[order])
        pos.append(slot_pos[begin : begin + c][order])
        begin += c
    return sizes, torch.cat(lanes), torch.cat(pos)


def compare_routes(rec: Record, what: str, got, want, n: int) -> list:
    """The route kernel's (slot_pos, slot_lane, counts) against the plain
    route's, slice by slice; returns the totals."""
    import torch

    g_sizes, g_lanes, g_pos = slices_by_lane(*got, n)
    w_sizes, w_lanes, w_pos = slices_by_lane(*want, n)
    rec.compare("k1r_route", f"{what}: lanes a shard", torch.tensor(g_sizes), torch.tensor(w_sizes))
    rec.compare("k1r_route", f"{what}: slices' lanes", g_lanes, w_lanes)
    rec.compare("k1r_route", f"{what}: slices' positions", g_pos, w_pos)
    return g_sizes


def masked_sum(shards, first_blocks, fn):
    """The every-lane step, JAX-literal: ``fn(shard, first_block)`` (a tuple
    of tensors) on every shard, summed."""
    total = None
    for shard, fb in zip(shards, first_blocks):
        got = fn(shard, fb)
        total = got if total is None else tuple(a + b for a, b in zip(total, got))
    return total


def rs_compare(rec: Record, name: str, shards, first_blocks, bps: int, wide: bool, pos, lett,
               unowned: int, tag: str) -> list:
    """The route and each shard's K1R (K1Rw) against their plain versions
    (tolerance 0) in occ mode, LF mode with the done rule, and letter mode
    (letter and LF, no done rule); then each routed step against the
    JAX-literal masked sum (every shard on every lane, summed, the LF
    formed after the sum). Returns the routed lanes a shard of the occ
    step."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, sharded

    n, ratio, mask = len(shards), shards[0].ratio, shards[0].pos_mask

    # occ mode: the route alone, then the shards over the kernel route's slices
    out_k, out_p = torch.full_like(pos, -7), torch.full_like(pos, -7)
    ck, cp = (torch.empty(n + 1, dtype=torch.int32, device=pos.device) for _ in range(2))
    rk = kernels.k1r_route(pos, out_k, n, bps, wide, 0, ck)
    rp = sharded.route_plain(pos, out_p, n, bps, wide, 0, cp)
    owned = compare_routes(rec, f"{tag}, occ route", rk + (ck,), rp + (cp,), n)
    rec.compare("k1r_route", f"{tag}, occ route's lanes no shard owns", out_k, out_p)
    out_p = out_k.clone()
    for i, (shard, fb) in enumerate(zip(shards, first_blocks)):
        kernels.k1r_occurrence(shard, fb, rk[0], rk[1], ck, i, lett, out_k)
        sharded.shard_occurrence_plain(shard, fb, rk[0], rk[1], ck, i, lett, out_p)
    rec.compare(name, f"{tag}, occ over the slices x{pos.numel()}", out_k, out_p)
    want, = masked_sum(shards, first_blocks,
                       lambda s, fb: (sharded.local_occurrence_plain(s, pos, lett, fb),))
    rec.compare(name, f"{tag}, the routed occ step vs the masked sum", out_k, want)

    # LF mode with the done rule, in place, as the backtrace steps
    p0 = pos & mask
    off0 = pos & 7
    pk, offk, pp, offp = p0.clone(), off0.clone(), p0.clone(), off0.clone()
    rk = kernels.k1r_route(pk, pk, n, bps, wide, unowned, ck, ratio, offk)
    rp = sharded.route_plain(pp, pp, n, bps, wide, unowned, cp, ratio, offp)
    compare_routes(rec, f"{tag}, LF route (ratio {ratio})", rk + (ck,), rp + (cp,), n)
    rec.compare("k1r_route", f"{tag}, LF route's positions", pk, pp)
    rec.compare("k1r_route", f"{tag}, LF route's offsets", offk, offp)
    pp = pk.clone()
    for i, (shard, fb) in enumerate(zip(shards, first_blocks)):
        kernels.k1r_lf(shard, fb, rk[0], rk[1], ck, i, pk)
        sharded.shard_lf_plain(shard, fb, rk[0], rk[1], ck, i, pp)
    rec.compare(name, f"{tag}, LF over the slices", pk, pp)
    lett_s, occ_s = masked_sum(shards, first_blocks,
                               lambda s, fb: sharded.local_letter_occ_plain(s, p0, fb))
    lf = rank.lf_from_letter_occ(shards[0], lett_s, occ_s)
    done = (sharded._u64_mod(p0, ratio) if wide else p0 % ratio) == 0
    rec.compare(name, f"{tag}, the routed LF step vs the masked sum", pk, torch.where(done, p0, lf))
    rec.compare("k1r_route", f"{tag}, the routed LF step's offsets vs the masked sum", offk,
                torch.where(done, off0, off0 + 1))

    # letter mode: the letter and the LF of every lane
    lk, lp = (torch.empty(pos.shape, dtype=torch.int32, device=pos.device) for _ in range(2))
    fk, fp = p0.clone(), p0.clone()
    routed_step(shards, first_blocks, bps, wide, fk, fk, letters=lk, unowned=unowned)
    routed_step(shards, first_blocks, bps, wide, fp, fp, letters=lp, unowned=unowned, plain=True)
    rec.compare(name, f"{tag}, letter mode's letters", lk, lp)
    rec.compare(name, f"{tag}, letter mode's LF", fk, fp)
    rec.compare(name, f"{tag}, letter mode vs the masked sum", fk, lf)
    rec.compare(name, f"{tag}, letter mode's letters vs the masked sum", lk, lett_s)
    return owned


def host_us(fn, calls: int = 200) -> float:
    """Host microseconds a call of fn takes to enqueue (no synchronize
    inside the loop)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(calls):
        fn()
    host = (time.perf_counter() - t) / calls * 1e6
    torch.cuda.synchronize()
    return host


def rs_time(rec: Record, name: str, shards, first_blocks, bps: int, wide: bool, pos, lett,
            unowned: int, tag: str, eng=None, record: bool = False) -> dict:
    """Each part of a routed step on the card, 50 calls after a warm-up:
    the route, each shard's launch and the whole step (route + n launches
    on one stream), occ over ``pos`` and LF (no done rule, so every lane is
    routed) over its first RS_LF_LANES, as device time (``device_ms``);
    the whole step through ``eng`` as the wall time a caller waits
    (``cuda_ms``: the host's work included) beside its device time; the
    host time of a wrapper call. With ``record``, the route's and shard
    0's occ launch against their plain versions in turns, with bounds, for
    the kernels line."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels, sharded

    n = len(shards)
    counts = torch.empty(n + 1, dtype=torch.int32, device=pos.device)
    out = torch.empty_like(pos)
    t = {"lanes_occ": pos.numel()}
    t["route_occ_ms"] = device_ms(lambda: kernels.k1r_route(pos, out, n, bps, wide, 0, counts), 50)
    sp, sl = kernels.k1r_route(pos, out, n, bps, wide, 0, counts)
    t["routed_occ"] = [int(c) for c in counts[:n].tolist()]
    t["shard_occ_ms"] = [
        device_ms(lambda: kernels.k1r_occurrence(s, fb, sp, sl, counts, i, lett, out), 50)
        for i, (s, fb) in enumerate(zip(shards, first_blocks))]
    t["step_occ_ms"] = device_ms(
        lambda: routed_step(shards, first_blocks, bps, wide, pos, out, letters_in=lett), 50)
    if eng is not None:
        t["engine_occ_wall_ms"] = cuda_ms(lambda: eng.occurrence(pos, lett), 50)
        t["engine_occ_ms"] = device_ms(lambda: eng.occurrence(pos, lett), 50)
    p = (pos[:RS_LF_LANES] & shards[0].pos_mask).contiguous()
    buf = torch.empty_like(p)
    t["lanes_lf"] = p.numel()
    lcounts = torch.empty_like(counts)  # the occ slices' totals stay in counts
    t["route_lf_ms"] = device_ms(
        lambda: kernels.k1r_route(p, buf, n, bps, wide, unowned, lcounts), 50)
    lsp, lsl = kernels.k1r_route(p, buf, n, bps, wide, unowned, lcounts)
    t["routed_lf"] = [int(c) for c in lcounts[:n].tolist()]
    t["shard_lf_ms"] = [
        device_ms(lambda: kernels.k1r_lf(s, fb, lsp, lsl, lcounts, i, buf), 50)
        for i, (s, fb) in enumerate(zip(shards, first_blocks))]
    t["step_lf_ms"] = device_ms(
        lambda: routed_step(shards, first_blocks, bps, wide, p, buf, unowned=unowned), 50)
    if eng is not None:
        t["engine_lf_wall_ms"] = cuda_ms(lambda: eng._step(p, buf), 50)
        t["engine_lf_ms"] = device_ms(lambda: eng._step(p, buf), 50)
    t["host_us"] = {
        "route": host_us(lambda: kernels.k1r_route(p, buf, n, bps, wide, unowned, lcounts)),
        "shard_lf": host_us(lambda: kernels.k1r_lf(shards[0], first_blocks[0], lsp, lsl, lcounts,
                                                   0, buf)),
    }
    log(f"[8a] {tag} times: {json.dumps(t)}")
    if not record:
        return t
    fb0, own0 = first_blocks[0], t["routed_occ"][0]
    ms, plain = time_in_turns(
        f"[8a] {name} occ, shard 0 of {n}, {own0} routed of {pos.numel()}",
        lambda: kernels.k1r_occurrence(shards[0], fb0, sp, sl, counts, 0, lett, out),
        lambda: sharded.shard_occurrence_plain(shards[0], fb0, sp, sl, counts, 0, lett, out),
        50, 3, kernel_timer=device_ms)
    rec.ms[name] = (ms, plain)
    np_, ms_b = shards[0].n_planes, shards[0].milestone_bytes
    # per routed lane: its position (8 B) and lane index (4 B), its letter (4 B) and
    # its count (8 B); the distinct rows the slice visits
    rec.set_bound(name, [(shards[0].packed.shape[0], np_ * 32 + ms_b, own0)],
                  own0 * (8 + 4 + 4 + 8), own0 * rank_ops(np_))
    log(f"[8a] {name}: shard 0's occ launch {ms:.4f} ms over {own0} routed lanes, bound "
        f"{rec.bound[name]['bound_ms']:.4f} ms, ms / bound {ms / rec.bound[name]['bound_ms']:.2f}")
    if "k1r_route" not in rec.ms:
        routed = sum(t["routed_occ"])
        pc = torch.empty_like(counts)
        rms, rplain = time_in_turns(
            f"[8a] k1r_route, occ, {n} shards, {pos.numel()} positions",
            lambda: kernels.k1r_route(pos, out, n, bps, wide, 0, counts),
            lambda: sharded.route_plain(pos, out, n, bps, wide, 0, pc), 50, 3,
            kernel_timer=device_ms)
        rec.ms["k1r_route"] = (rms, rplain)
        # each position read once (8 B); a routed lane's position and lane index
        # written (12 B), an unowned lane's 0 (8 B); about ten integer operations a lane
        rec.set_bound("k1r_route", [], pos.numel() * 8 + routed * 12
                      + (pos.numel() - routed) * 8 + 4 * (n + 1), 10 * pos.numel())
        log(f"[8a] k1r_route: {rms:.4f} ms, bound {rec.bound['k1r_route']['bound_ms']:.4f} ms")
    return t


def phase_rs_kernels(rec: Record, engine, device: str) -> dict:
    """Phase 8a: the route and K1R / K1Rw (occ, LF with the done rule,
    letter mode) against their plain versions and the routed steps
    against the JAX-literal masked sum (tolerance 0), on the phase-4 index
    (``engine``: phase 4's, narrow) split into 2 and 4 shards (narrow block
    rows) and into 2 (compact wide rows), at crafted edge positions and
    RS_POSITIONS random ones (a backward step's 2B at 1M queries); the
    routed occ equal to K1's rank over the whole view; every part of a
    step timed. Returns the engines, for 8b and 8c, and the times."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels
    from avxwindowfmindex_tpu_torch.parallel.range_sharded import RangeShardedSearchEngine

    rng = np.random.default_rng(88)
    engines, times = {}, {}
    for n, wide in ((2, False), (4, False), (2, True)):
        t = time.time()
        eng = RangeShardedSearchEngine(engine.host_index, [device] * n, wide=wide)
        torch.cuda.synchronize()
        engines[n, wide] = eng
        name = "k1rw_rank" if wide else "k1r_rank"
        shard0 = eng.shards[0]
        log(f"[8a] {n} shards, {'compact wide' if wide else 'narrow'} rows: {eng.blocks_per_shard} "
            f"blocks x {shard0.packed.shape[1]} B and {eng.samples_per_shard} samples a shard, "
            f"cut on the host and uploaded in {time.time() - t:.3f}s")
        rnd = rng.integers(0, eng.host_index.bwt_length, RS_POSITIONS).astype(np.uint64)
        pos_np = np.concatenate([np.array(rs_edge_positions(eng), dtype=np.uint64), rnd])
        pos = torch.from_numpy(pos_np.view(np.int64)).to(device)
        lett = torch.from_numpy(
            rng.integers(0, eng.dev.cardinality + 1, len(pos_np)).astype(np.int32)).to(device)
        args = (eng.shards, eng.first_blocks, eng.blocks_per_shard, wide)
        owned = rs_compare(rec, name, *args, pos, lett, eng.lf_unowned, f"[8a] {n} shards")
        p_rnd, l_rnd = pos[-RS_POSITIONS:], lett[-RS_POSITIONS:]
        rec.compare(name, f"{n} shards routed vs K1 over the whole view x{RS_POSITIONS}",
                    eng.occurrence(p_rnd, l_rnd), kernels.k1_occurrence(engine.dev, p_rnd, l_rnd))
        log(f"[8a] {name}, {n} shards: exact on {pos.numel()} positions (routed a shard: {owned}, "
            f"{sum(owned)} of {pos.numel()})")
        times[f"{n}{'w' if wide else ''}"] = rs_time(
            rec, name, *args, p_rnd, l_rnd, eng.lf_unowned, f"{n} shards{' wide' if wide else ''}",
            eng=eng, record=n == 2)
    return engines, times


def slices_from_owners(shards, first_blocks, pos):
    """Slices of ``pos`` for shards of unequal sizes, which the route does
    not take: each shard's lanes by its own ownership test."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import sharded

    lanes = [torch.nonzero(sharded.owned_rows(s, pos, fb)[1])[:, 0]
             for s, fb in zip(shards, first_blocks)]
    slot_lane = torch.cat(lanes)
    n = pos.numel()
    slot_pos = torch.empty(n, dtype=torch.int64, device=pos.device)
    lane_buf = torch.empty(n, dtype=torch.int32, device=pos.device)
    slot_pos[: slot_lane.numel()] = pos[slot_lane]
    lane_buf[: slot_lane.numel()] = slot_lane.to(torch.int32)
    counts = torch.tensor([x.numel() for x in lanes] + [0], dtype=torch.int32, device=pos.device)
    return slot_pos, lane_buf, counts


def phase_rs_straddle(rec: Record, device: str, boundary: int = 2**32) -> dict:
    """Phase 8a above 2^32, on a compact-row table tiled to boundary +
    boundary / 16 positions (4.56 GB) with milestones that straddle 2^32:
    split unevenly at a block above ``boundary`` (shard slices by each
    shard's own ownership test), each shard's K1Rw (occ and LF) against
    its plain version and the occ against a closed form; then split into
    two 2.28 GB shards, beyond the L2, through the route: everything
    ``rs_compare`` holds, the closed form, and every part of a step
    timed. Returns the times."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch.ops import kernels, rank, sharded
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import (
        closed_form_occ, straddle_shard, straddle_table)

    t = time.time()
    info = straddle_table(device, boundary)
    table, nb, n, rng = info["table"], info["nb"], info["n"], info["rng"]
    edge = (boundary >> 8) + 2048  # shard 1's first block: above the boundary
    torch.cuda.synchronize()
    log(f"[8a] compact table of {n} positions: {nb} rows x 256 B = {table.numel() / 1e9:.2f} GB, "
        f"milestones {info['offset']} .. {info['ms_max']}, uneven shard edge at block "
        f"{edge} (position {edge * 256}), tiled in {time.time() - t:.2f}s")
    m = RS_POSITIONS // 2
    pos = np.concatenate([
        rng.integers(boundary - 5000, boundary + 5000, m), rng.integers(0, n, m),
        rng.integers(edge * 256 - 5000, edge * 256 + 5000, m // 4),
        [boundary - 1, boundary, edge * 256 - 1, edge * 256, n - 1],
    ]).astype(np.int64)
    lett = rng.integers(0, 5, size=len(pos)).astype(np.int32)
    want = torch.from_numpy(closed_form_occ(info, pos, lett)).to(device)
    # bit 39 set: no shard owns them; 2^40 + 5 and 2^63 + 9 alias block 0
    crafted = np.array([2**64 - 1, 2**39, 2**39 + 777, 2**40 + 5, 2**63 + 9], dtype=np.uint64)
    pos_t = torch.from_numpy(np.concatenate([pos, crafted.view(np.int64)])).to(device)
    lett_t = torch.from_numpy(np.concatenate([lett, np.arange(len(crafted), dtype=np.int32) % 5])).to(device)

    uneven = [straddle_shard(table[:edge], n, device), straddle_shard(table[edge:], n, device)]
    slot_pos, slot_lane, counts = slices_from_owners(uneven, [0, edge], pos_t)
    out_k, out_p = torch.zeros_like(pos_t), torch.zeros_like(pos_t)
    lf_k, lf_p = pos_t.clone(), pos_t.clone()
    for i, (s, fb) in enumerate(zip(uneven, (0, edge))):
        kernels.k1r_occurrence(s, fb, slot_pos, slot_lane, counts, i, lett_t, out_k)
        sharded.shard_occurrence_plain(s, fb, slot_pos, slot_lane, counts, i, lett_t, out_p)
        kernels.k1r_lf(s, fb, slot_pos, slot_lane, counts, i, lf_k)
        sharded.shard_lf_plain(s, fb, slot_pos, slot_lane, counts, i, lf_p)
    owned = [int(c) for c in counts[:2].tolist()]
    rec.compare("k1rw_rank", "above 2^32, uneven split, occ over the slices", out_k, out_p)
    rec.compare("k1rw_rank", "above 2^32, uneven split, LF over the slices", lf_k, lf_p)
    rec.compare("k1rw_rank", f"above 2^32, uneven split vs the closed form x{len(pos)}",
                out_k[: len(pos)], want)
    if int(out_k[len(pos) : len(pos) + 3].abs().sum()) != 0:
        raise AssertionError("a position no shard owns counted")
    if not (int(out_k.max()) > 2**32 and min(owned) > 0):
        raise AssertionError("the straddle counts did not pass 2^32")
    log(f"[8a] K1Rw exact above 2^32 on the uneven split: owned {owned}, counts up to "
        f"{int(out_k.max())}")
    del uneven, slot_pos, slot_lane, out_k, out_p, lf_k, lf_p

    half = nb // 2
    even = [straddle_shard(table[i * half : (i + 1) * half], n, device) for i in range(2)]
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    unowned = int(rank.lf_from_letter_occ(even[0], zero, zero)[0])
    rnd = torch.from_numpy(rng.integers(0, n, RS_POSITIONS)).to(device)
    lett_r = torch.from_numpy(rng.integers(0, 5, RS_POSITIONS).astype(np.int32)).to(device)
    p_all, l_all = torch.cat([pos_t, rnd]), torch.cat([lett_t, lett_r])
    owned = rs_compare(rec, "k1rw_rank", even, [0, half], half, True, p_all, l_all, unowned,
                       f"[8a] 2 x {half * 256 / 1e9:.2f} GB shards")
    got = torch.empty_like(pos_t)
    routed_step(even, [0, half], half, True, pos_t, got, letters_in=lett_t)
    rec.compare("k1rw_rank", f"above 2^32, 2 even shards routed vs the closed form x{len(pos)}",
                got[: len(pos)], want)
    log(f"[8a] K1Rw exact on two shards of {half} rows ({half * 256 / 1e9:.2f} GB each): routed "
        f"{owned}")
    times = rs_time(rec, "k1rw_rank", even, [0, half], half, True, rnd, lett_r, unowned,
                    f"2 x {half * 256 / 1e9:.2f} GB shards")
    del table, info, even, got, p_all, l_all
    torch.cuda.empty_cache()
    return times


def phase_range_sharded(rec: Record, engine, kmers, answers, device: str) -> dict:
    """Phase 8: the range-sharded engine on the phase-4 index (8a the
    kernels; 8b narrow, 2 and 4 shards on the one card; 8c compact wide
    rows, 2 shards; 8d the planner over 4 devices). Returns the stats,
    with each kernel's launches from its checked calls."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import SearchEngine
    from avxwindowfmindex_tpu_torch.ops import kernels
    from avxwindowfmindex_tpu_torch.utils import capacity

    engines, times = phase_rs_kernels(rec, engine, device)
    times["straddle"] = phase_rs_straddle(rec, device)
    counts_want, lens_want, flat_want = answers
    steps = KMER_LEN - MAIN_SEED_K
    stats = {"launches": {"k1r_rank": 0, "k1rw_rank": 0, "k1r_route": 0}, "step_times": times}

    def median_qps(fn, runs=3):
        fn(kmers[:4096])  # warm-up
        times = []
        for _ in range(runs):
            t = time.time()
            fn(kmers)
            torch.cuda.synchronize()
            times.append(time.time() - t)
        return len(kmers) / float(np.median(times)), times

    single = SearchEngine(engine.host_index, device=device)
    for (n, wide), eng in engines.items():
        tag = "8c" if wide else "8b"
        name = "k1rw_rank" if wide else "k1r_rank"
        kernels.reset_launch_counts()
        counts = eng.count(kmers)
        # a step: one route and one launch a shard over the lanes it owns
        launches = expect_launches(tag, (name, "k1r_route"),
                                   exact={name: steps * n, "k1r_route": steps})
        if not np.array_equal(counts, counts_want):
            raise AssertionError(f"[{tag}] {n} shards: counts differ from phase 4's")
        kernels.reset_launch_counts()
        if (n, wide) == (2, False):  # the public locate once, its split included
            hits = eng.locate(kmers)
            lens = np.array([len(h) for h in hits])
            flat = np.concatenate(hits)
            del hits
        else:
            flat, lens = eng._locate_flat(kmers)
        bt = dict(eng.last_backtrace)
        per_step = bt.pop("routed_per_step")
        launches_l = expect_launches(tag, (name, "k1r_route"), exact={
            name: steps * n + bt["launches"], "k1r_route": steps + bt["lf_steps"]})
        if not (np.array_equal(lens, lens_want) and np.array_equal(flat, flat_want)):
            raise AssertionError(f"[{tag}] {n} shards: locate differs from phase 4's")
        if max(per_step) > len(flat) or bt["routed_lanes"] > bt["lane_steps"]:
            raise AssertionError(f"[{tag}] a step routed more lanes than it had: {bt}")
        for k in (name, "k1r_route"):
            stats["launches"][k] += launches[k] + launches_l[k]
        log(f"[{tag}] {n} shards{' (compact wide rows)' if wide else ''}: count and locate of "
            f"{len(kmers)} {KMER_LEN}-mers equal to phase 4's; {name} {launches[name]} launches a "
            f"count ({steps} steps x {n}, {steps} routes), {launches_l[name]} a locate (its "
            f"ranges, then the LF loop: {bt['segments']} segments, {bt['lf_steps']} steps, "
            f"{bt['lane_steps']} lane steps for {len(flat)} hits, {bt['routed_lanes']} routed "
            f"lanes launched once each where the every-lane form launched {n} x "
            f"{bt['lane_steps']}; the most in a step {max(per_step)}; {bt['launches']} launches)")
        cq, ct = median_qps(eng.count)
        lq, lt = median_qps(eng._locate_flat)
        stats[f"{n}{'w' if wide else ''}"] = {"count_qps": cq, "locate_qps": lq, "lf": bt}
        log(f"[{tag}] {n} shards: count median {cq:.1f} q/s of {ct}, locate (flat hits) median "
            f"{lq:.1f} q/s of {lt}")
    cq, ct = median_qps(single.count)
    lq, lt = median_qps(single._locate_flat)
    stats["single"] = {"count_qps": cq, "locate_qps": lq}
    log(f"[8b] SearchEngine in the same process: count median {cq:.1f} q/s of {ct}, locate "
        f"(flat hits) median {lq:.1f} q/s of {lt}")
    del engines, single
    torch.cuda.empty_cache()

    hbm, src = capacity.detect_hbm_bytes(device)
    corpus = 100_000_000_000
    try:
        capacity.plan_capacity(corpus, device=device)
    except ValueError as e:
        log(f"[8d] {corpus} bases on one card ({src}, {hbm} B): {e}")
    else:
        raise AssertionError("[8d] the corpus was meant not to fit one card")
    plan = capacity.plan_capacity(corpus, device=device, n_devices=4)
    if plan.engine != "range_sharded" or plan.per_chip_bytes > plan.budget:
        raise AssertionError(f"[8d] plan over 4 devices: {plan.summary()}")
    log(f"[8d] plan_capacity({corpus}, n_devices=4): {plan.summary()}; notes {plan.notes}")
    stats["plan"] = plan.summary()
    return stats


def phase_single_query(rec: Record, engine, kmers, device: str) -> dict:
    """Phase 7f: the single-query API over the forced-wide view of the
    phase-4 index, its narrow view and that view without pair rows:
    16 25-mers walked letter by letter by ``iterative_step_backward_search``
    (K1's step mode, K1w's on the wide view: one launch and one readback a
    step) equal to the engine's ranges, and
    ``backtrace_return_previous_letter_index`` (their LF mode by value)
    equal to the plain LF; the launch counts, by mode, reset before each
    view's calls and read after them. Then each view's calls timed against
    the route before the step mode, in turns, beside the floor of a call,
    and traced (``single_query_calls``). Returns each kernel's launches and
    the times."""
    import numpy as np
    import torch
    import avxwindowfmindex_tpu_torch as pt
    from avxwindowfmindex_tpu_torch.models import alphabet as alpha
    from avxwindowfmindex_tpu_torch.ops import kernels, rank

    index = engine.host_index
    rng = np.random.default_rng(73)
    walks = [kmers[i] for i in rng.integers(0, len(kmers), 16)]
    lf_pos = [int(p) for p in rng.integers(0, index.bwt_length, 64)]
    want_ranges = engine.find_ranges(walks)
    ps = [int(c) for c in index.prefix_sums]
    stats = {"launches": {}, "calls": {}}
    narrow = None
    for tag, kw in (("wide", {"wide": True}), ("narrow", {"wide": False, "pair_rows": True}),
                    ("narrow without pair rows", {"wide": False, "pair_rows": False})):
        t = time.time()
        if kw["wide"] or kw["pair_rows"]:
            view = index.to_device(device, **kw)
            narrow = None if kw["wide"] else view
        else:
            # what to_device(pair_rows=False) would pack anew: the narrow
            # view's block rows without its pair table, installed as the
            # index's view, so that the calls naming that layout find it
            view = index._device_cache = dataclasses.replace(narrow, packed_pair=None)
            if index.to_device(device, **kw) is not view:
                raise AssertionError("7f: the view without pair rows is not the installed one")
        name = kernels.form_of(view, kernels.K1).name
        lett_want, lf_want = rank.letter_and_lf_plain(
            view, torch.tensor(lf_pos, dtype=torch.int64, device=device))
        kernels.reset_launch_counts()
        for q, (want_s, want_e) in zip(walks, want_ranges):
            letters = alpha.ascii_to_index(np.frombuffer(q, np.uint8), index.alphabet).tolist()
            s, e = ps[letters[-1]], ps[letters[-1] + 1] - 1
            for lett in reversed(letters[:-1]):
                s, e = pt.iterative_step_backward_search(index, s, e, lett, device=device, **kw)
            if (s, e) != (int(want_s), int(want_e)):
                raise AssertionError(f"7f: {q} walked to {(s, e)}, the engine's range is "
                                     f"{(want_s, want_e)}")
        for p, lw, fw in zip(lf_pos, lett_want.tolist(), lf_want.tolist()):
            got = pt.backtrace_return_previous_letter_index(index, p, device=device, **kw)
            want = (0, p) if lw == view.sentinel else (lw, fw)
            if got != want:
                raise AssertionError(f"7f: LF of {p} gave {got}, the plain version {want}")
        steps = len(walks) * (KMER_LEN - 1)
        launches = expect_launches("7f", (name,), exact={
            name: steps + len(lf_pos), f"{name}.step": steps, f"{name}.lf_at": len(lf_pos),
            f"{name}.occ": 0, f"{name}.letter_lf": 0})
        for key in (name, f"{name}.step", f"{name}.lf_at"):
            stats["launches"][key] = launches[key]
        log(f"[7f] single-query API, {tag} view: {len(walks)} 25-mers walked by "
            f"iterative_step_backward_search ({steps} steps) equal to the engine's ranges, "
            f"{len(lf_pos)} backtrace_return_previous_letter_index calls equal to the plain LF; "
            f"{launches[name]} {name} launches ({launches[f'{name}.step']} step, "
            f"{launches[f'{name}.lf_at']} LF by value), {time.time() - t:.3f}s")
        stats["calls"][tag] = single_query_calls(rec, index, kw, walks, lf_pos, device,
                                                 f"7f {tag}", record=tag != "narrow without pair rows")
    index._device_cache = narrow  # the narrow view with pair rows, as phase 7f found it built
    return stats


def trace_bfs(view, prefix_sums, k: int, tag: str) -> dict:
    """A profiler trace of one k-mer table through ``build_seed_table`` on
    ``view``, which must show the BFS mode's launch, no host-to-device copy
    and no other kernel; its launches come from the wrappers' counters (one
    a table, in the BFS mode). Phase 3w takes it first of the script's traces: the
    profiler has returned traces without a device event in this process
    after earlier ones."""
    from avxwindowfmindex_tpu_torch.ops import kernels, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import trace_calls

    card = view.cardinality
    form = kernels.form_of(view, kernels.K1X).name

    def build():
        return seed_table.build_seed_table(view, card, k, prefix_sums)

    before = kernels.launch_counts()
    trace_dir = os.path.join(REPO, "avxwindowfmindex_tpu_torch", "build", "traces")
    # a trace in which the profiler saw nothing on the device is taken
    # again, at most twice more; the launches come from the wrappers'
    # counters
    for traces in range(1, 4):
        tr = trace_calls(build, trace_dir, f"{form}-bfs-k{k}")
        if tr["kernels"] or tr["htod"] or tr["dtoh"] or tr["other_copies"] or tr["memsets"]:
            break
        log(f"{tag} trace {traces} of one k={k} BFS saw no device activity")
    after = kernels.launch_counts()
    counted = {name: after.get(name, 0) - before.get(name, 0) for name in after
               if after.get(name, 0) != before.get(name, 0)}
    mode = {name: v for name, v in tr["kernels"].items() if "k1_seed_table_kernel" in name}
    others = {name: v for name, v in tr["kernels"].items() if name not in mode}
    # an empty trace would show neither a copy nor another kernel
    if not mode:
        raise AssertionError(f"{tag} the profiler saw no BFS-mode launch in {traces} traces: {tr}")
    if others or tr["htod"] or tr["other_copies"]:
        raise AssertionError(f"{tag} a traced k={k} BFS ran {others} beside the BFS mode, "
                             f"{tr['htod']} host-to-device copies: {tr}")
    # each trace ran the BFS twice (a warm-up cycle, then the traced one)
    if counted != {form: 2 * traces, f"{form}.bfs": 2 * traces}:
        raise AssertionError(f"{tag} {2 * traces} traced k={k} BFS counted {counted}, not one "
                             f"BFS-mode launch each")
    log(f"{tag} profiler, one k={k} BFS: {sum(c for c, _ in mode.values())} BFS-mode launch "
        f"({sum(d for _, d in mode.values()):.1f} us), no other kernel, {tr['htod']} host-to-device "
        f"and {tr['dtoh']} device-to-host copies, {tr['memsets']} memset (the mode's counters); "
        f"the wrapper counted {counted}")
    return tr


def compact_bfs(rec: Record, view, prefix_sums, bfs) -> dict:
    """Phase 4p(b)'s seed tables over the compact rows: the k = 5 table
    ``bfs`` (built through the BFS mode) and one k = 6 table through it
    against the plain BFS, and the per-depth route (one K1WX launch a
    depth from the depth-1 ranges, ``kernel_ab.split_seed_table`` with no
    depth in the BFS mode) against it too; both k timed in turns, BFS mode
    against the per-depth route; the
    k = 5 BFS mode against the plain BFS, the kernels line's times of
    ``k1w_extend_compact.bfs`` and (the per-depth route) of
    ``k1w_extend_compact``."""
    import torch
    from avxwindowfmindex_tpu_torch.ops import rank, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import split_seed_table

    card, out = view.cardinality, {}

    def build(k, **kw):
        return lambda: seed_table.build_seed_table(view, card, k, prefix_sums, **kw)

    def by_depth(k):
        return lambda: split_seed_table(view, k, 0, prefix_sums)

    for k in (AMINO_SEED_K, AMINO_BIG_SEED_K):
        got = bfs if k == AMINO_SEED_K else build(k)()
        plain = build(k, occurrence_fn=rank.occurrence_plain)()
        rec.compare("k1w_extend_compact.bfs", f"main k={k} BFS x{got.numel()}", got, plain)
        rec.compare("k1w_extend_compact", f"main k={k} BFS, one launch a depth x{got.numel()}",
                    by_depth(k)(), plain)
        del got, plain
        torch.cuda.empty_cache()
        reps = 5 if k == AMINO_SEED_K else 3
        out[f"k={k}"] = forms_in_turns(f"the k={k} BFS over compact rows ({card}^{k} ranges)", {
            "one launch a depth": by_depth(k), "BFS mode": build(k)}, reps)
        torch.cuda.empty_cache()
    k = AMINO_SEED_K
    ms, plain_ms = time_in_turns(f"k1w_extend_compact.bfs, the k={k} BFS", build(k),
                                 build(k, occurrence_fn=rank.occurrence_plain), 5, 1)
    rec.ms["k1w_extend_compact.bfs"] = (ms, plain_ms)
    rec.ms["k1w_extend_compact"] = (min(out[f"k={k}"]["one launch a depth"]), plain_ms)
    return out


def phase_pairless(rec: Record, engine, kmers, mh_kmers, answers, main: dict, seq_arr,
                   device: str) -> dict:
    """Phase 4p: views without pair rows at full size. (a) The phase-4
    index as ``to_device(device, pair_rows=False)``, its seed table the one
    the index holds on the card: SearchEngine and DigramSearchEngine over
    it, count and locate of phase 4's 1,048,576 25-mers and its 4,096
    multi-hit 11-mers equal to phase 4's, the launch counts reset just
    before and read just after (K2's and K4's block-row forms and K3, no
    pair-row K2 or K4); phase 4's host-scan sample of 32 25-mers through
    the K4-over-block-rows engines at n = 2 and n = 3 (counts against the
    scan, every locate hit against its window); then K2 and K4 in both
    forms in turns at the main shapes, each block-row form against its
    plain version (K4 at n = 2 and n = 3), with the window classes and
    bounds, and K4 over block rows at n = 2 and 3 and K2w over compact rows
    on the window-class corpora of ``pairless_corpora`` (every class taken,
    by the plain versions' counts); the calibrated rate of the n = 3
    n-gram rows. (b) A 2^26-residue amino index (seed k = 5, SA ratio 8)
    as a wide view on compact rows: K1WX's BFS over them equal to the
    narrow table widened, SearchEngine's count and locate of 1,048,576
    sampled 12-mers equal to the narrow amino engine's, a sample of 32 of
    them against a host scan of the text (counts, every locate hit against
    its window), the single-query API over 256 of them equal to the narrow
    answers, the launches read around all of it; then each compact form
    against its plain version (K1WX's whole BFS against the plain BFS) and
    K2w and K3w against their pair-fused forms, in turns, the C launchers'
    layout refusals, and the calibrated rate of the compact rows."""
    import numpy as np
    import torch
    import avxwindowfmindex_tpu_torch as pt
    from avxwindowfmindex_tpu_torch import (
        AlphabetType, DigramSearchEngine, IndexConfiguration, NgramSearchEngine, SearchEngine,
        create_index, search,
    )
    from avxwindowfmindex_tpu_torch.models import alphabet as alpha
    from avxwindowfmindex_tpu_torch.ops import kernels, probes, rank, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import CEILING_LANES, lengthwise_batch
    from avxwindowfmindex_tpu_torch.utils import roofline

    t_phase = time.time()
    stats = {"launches": {}}
    index, pair = engine.host_index, engine.dev
    mh_want = flat_hits(engine.locate(mh_kmers))
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    t = time.time()
    view = index.to_device(device, pair_rows=False)
    torch.cuda.synchronize()
    stats["view_s"] = time.time() - t
    grew = torch.cuda.memory_allocated() - before
    seed_bytes = view.seed_table.numel() * view.seed_table.element_size()
    if view.pair_rows or view.packed_pair is not None:
        raise AssertionError("[4p] to_device(pair_rows=False) kept a pair table")
    if grew >= seed_bytes or not torch.equal(view.seed_table, pair.seed_table):
        raise AssertionError(f"[4p] the view's seed table is not the one the index holds "
                             f"(device memory grew {grew} B)")
    log(f"[4p] to_device(pair_rows=False) in {stats['view_s']:.3f}s: {view.packed.shape[0]} block "
        f"rows x {view.packed.shape[1]} B = {view.packed.numel() / 1e6:.1f} MB and no pair table "
        f"(phase 4's view: {pair.packed_pair.numel() / 1e6:.1f} MB of pair rows beside the same "
        f"block rows); device memory grew {grew / 1e6:.1f} MB, the {seed_bytes / 1e9:.2f} GB seed "
        f"table is the one the index holds")
    single = SearchEngine(view, device=device)
    t = time.time()
    digram = DigramSearchEngine(index, device=device, pair_rows=False)
    log(f"[4p] DigramSearchEngine(pair_rows=False) with its n-gram table: {time.time() - t:.3f}s")
    if digram.dev is not view:
        raise AssertionError("[4p] the digram engine did not take the installed view")

    kernels.reset_launch_counts()
    for label, eng in (("digram", digram), ("single", single)):
        counts, count_s, count_times = timed_engine_call(eng.count, kmers)
        hits, locate_s, locate_times = timed_engine_call(eng.locate, kmers)
        lens, flat = flat_hits(hits)
        del hits
        if not (np.array_equal(counts, answers[0]) and np.array_equal(lens, answers[1])
                and np.array_equal(flat, answers[2])):
            raise AssertionError(f"[4p] {label}: counts or hits differ from phase 4's")
        stats[f"{label}_count_qps"] = QUERIES / count_s
        stats[f"{label}_locate_qps"] = QUERIES / locate_s
        log(f"[4p] {label} over block rows: count {QUERIES} x {KMER_LEN}-mers median {count_s:.4f}s "
            f"of {count_times} -> {QUERIES / count_s:.1f} q/s (phase 4: "
            f"{main[f'{label}_count_qps']:.1f}); locate median {locate_s:.4f}s of {locate_times} -> "
            f"{QUERIES / locate_s:.1f} q/s (phase 4: {main[f'{label}_locate_qps']:.1f}); "
            f"{len(flat)} hits; counts and hits equal to phase 4's")
    mh = flat_hits(digram.locate(mh_kmers))
    if not all(np.array_equal(a, b) for a, b in zip(mh, mh_want)):
        raise AssertionError("[4p] multi-hit locate over block rows differs from phase 4's engine")
    log(f"[4p] multi-hit locate {len(mh_kmers)} x {MULTIHIT_LEN}-mers: {len(mh[1])} hits equal "
        f"to phase 4's engine")
    launches = expect_launches("4p", PAIRLESS_KERNELS,
                               exact={"k2_ranges": 0, "k4_ngram_ranges": 0, "k1_rank": 0,
                                      "k1_extend": 0})
    stats["launches"].update({n: launches[n] for n in PAIRLESS_KERNELS if n.endswith("_block")})
    ngram3 = NgramSearchEngine(index, 3, device=device, pair_rows=False)
    if ngram3.dev is not view:
        raise AssertionError("[4p] the n = 3 engine did not take the installed view")
    host_sample(main["host_sample"], kmers, seq_arr, {"digram": digram, "n=3": ngram3}, "[4p]")

    # K2 and K4 in both forms at the main path's shapes
    mat, lengths, n = engine.encode_kmers(kmers)
    seeded = engine._seed_eligibility(mat, lengths)
    args = (torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
            torch.from_numpy(seeded.astype(np.uint8)).to(device))
    mat_d, ng = args[0], digram.ng
    k2_classes = torch.zeros(3, dtype=torch.int64, device=device)
    ps, pe = search.ranges_plain(view, *args, k2_classes)
    ks, ke = kernels.k2_ranges(view, *args)
    rec.compare("k2_ranges_block", f"main start x{n}", ks, ps)
    rec.compare("k2_ranges_block", f"main end x{n}", ke, pe)
    k4_classes = search.new_step_classes(device)
    ps, pe = search.ngram_ranges_plain(view, ng, mat_d, KMER_LEN, k4_classes)
    ks, ke = kernels.k4_ngram_ranges(view, ng, mat_d, KMER_LEN)
    rec.compare("k4_ngram_ranges_block", f"main n={ng.n} start x{n}", ks, ps)
    rec.compare("k4_ngram_ranges_block", f"main n={ng.n} end x{n}", ke, pe)
    ng3, k4_3_classes = ngram3.ng, search.new_step_classes(device)
    ps, pe = search.ngram_ranges_plain(view, ng3, mat_d, KMER_LEN, k4_3_classes)
    ks, ke = kernels.k4_ngram_ranges(view, ng3, mat_d, KMER_LEN)
    rec.compare("k4_ngram_ranges_block", f"main n=3 start x{n}", ks, ps)
    rec.compare("k4_ngram_ranges_block", f"main n=3 end x{n}", ke, pe)
    del ps, pe, ks, ke
    k4_3_classes = {t: c.tolist() for t, c in k4_3_classes.items()}
    log(f"[4p] K4 n=3 over block rows: n-gram steps {class_shares(k4_3_classes['ngram_pair'])}, "
        f"tail steps {class_shares(k4_3_classes['pair'])}")
    k2_classes = k2_classes.tolist()
    k4_classes = {t: c.tolist() for t, c in k4_classes.items()}
    log(f"[4p] window classes over block rows: K2's steps {class_shares(k2_classes)}; K4's "
        f"n-gram steps {class_shares(k4_classes['ngram_pair'])}, its tail steps "
        f"{class_shares(k4_classes['pair'])}; a first-block visit reads the block row (2 of its "
        f"64 B pieces) in both views, which differ only in the pair-window class")
    stats["forms"] = {
        "k2_ranges": forms_in_turns(f"K2, {n} 25-mers, the pair window over pair rows "
                                   f"against two block rows", {
            "pair": lambda: kernels.k2_ranges(pair, *args),
            "block": lambda: kernels.k2_ranges(view, *args)}),
        "k4_ngram_ranges": forms_in_turns(f"K4 n={ng.n}, {n} 25-mers, the tail's pair window "
                                          f"over pair rows against two block rows", {
            "pair": lambda: kernels.k4_ngram_ranges(pair, ng, mat_d, KMER_LEN),
            "block": lambda: kernels.k4_ngram_ranges(view, ng, mat_d, KMER_LEN)}),
    }
    rec.ms["k2_ranges_block"] = time_in_turns(
        f"k2_ranges_block main x{n}", lambda: kernels.k2_ranges(view, *args),
        lambda: search.ranges_plain(view, *args), 10, 1)
    rec.ms["k4_ngram_ranges_block"] = time_in_turns(
        f"k4_ngram_ranges_block main n={ng.n} x{n}",
        lambda: kernels.k4_ngram_ranges(view, ng, mat_d, KMER_LEN),
        lambda: search.ngram_ranges_plain(view, ng, mat_d, KMER_LEN), 10, 1)
    # logged, not in the kernels line: the same form at n = 3
    rec.ms["k4_ngram_ranges_block n=3"] = time_in_turns(
        f"k4_ngram_ranges_block main n=3 x{n}",
        lambda: kernels.k4_ngram_ranges(view, ng3, mat_d, KMER_LEN),
        lambda: search.ngram_ranges_plain(view, ng3, mat_d, KMER_LEN), 10, 1)
    nb, np_ = view.num_blocks, view.n_planes
    rng_walk = np.random.default_rng(4099)
    tables, ops = block_step_tables(nb, np_, 4, k2_classes)
    rec.set_bound("k2_ranges_block", tables, n * (mat_d.shape[1] + 4 + 1 + 2 * 4 + 16), ops,
                  other_visits={"seed_table": n})
    ng_tables, ng_ops = step_tables(ng.packed.shape[0], 2 * ng.n + 1, 4, k4_classes["ngram_pair"])
    tail_tables, tail_ops = block_step_tables(nb, np_, 4, k4_classes["pair"])
    rec.set_bound(
        "k4_ngram_ranges_block", ng_tables + tail_tables,
        n * (mat_d.shape[1] + 2 * 4 + 16), ng_ops + tail_ops,
        row_visits=[sum(k4_classes["ngram_pair"]) + k4_classes["ngram_pair"][2],
                    tail_tables[0][2]],
        other_visits={"seed_table": n})
    ng3_tables, ng3_ops = step_tables(ng3.packed.shape[0], 2 * ng3.n + 1, 4,
                                      k4_3_classes["ngram_pair"])
    tail3_tables, tail3_ops = block_step_tables(nb, np_, 4, k4_3_classes["pair"])
    rec.set_bound(
        "k4_ngram_ranges_block n=3", ng3_tables + tail3_tables,
        n * (mat_d.shape[1] + 2 * 4 + 16), ng3_ops + tail3_ops,
        row_visits=[sum(k4_3_classes["ngram_pair"]) + k4_3_classes["ngram_pair"][2],
                    tail3_tables[0][2]],
        other_visits={"seed_table": n})
    seed_only = lengthwise_batch(mat_d, KMER_LEN, view.kmer_length_in_seed_table)
    rec.fixed["k2_ranges_block"] = min(
        cuda_ms(lambda: kernels.k2_ranges(view, *seed_only), 10) for _ in range(2))
    # the seed-table visit and the stores are K4's in both forms and at
    # both n: phase 4s's fit
    rec.fixed["k4_ngram_ranges_block"] = rec.fixed["k4_ngram_ranges"]
    rec.fixed["k4_ngram_ranges_block n=3"] = rec.fixed["k4_ngram_ranges"]
    log(f"  k2_ranges_block with no step: {rec.fixed['k2_ranges_block']:.4f} ms")
    mask3 = roofline.first_block_visits(ngram_n=3)["ngram_pair"][0]
    stats["rates"] = {"ngram_pair3": roofline.calibrate_gather_rates(
        {"ngram_pair3": ng3.packed}, QUERIES, device=device, sector_masks={"ngram_pair3": mask3},
        log=lambda m: log(f"[4p] {m}"))["ngram_pair3"]}
    # the block rows' ceiling: K5's walk with CEILING_LANES lanes a chain,
    # against its plain version, then calibrated
    bmask = roofline.first_block_visits()["single"][0]
    walk_idx = torch.from_numpy(rng_walk.integers(0, nb, QUERIES).astype(np.int32)).to(device)
    rec.compare("k5_gather_reduce", f"walk block rows, {CEILING_LANES} lanes a chain, seg=4 x{QUERIES}",
                probes.gather_walk(view.packed, walk_idx, 4, bmask, CEILING_LANES),
                probes.gather_walk_plain(view.packed, walk_idx, 4, bmask))
    stats["rates"]["single, ceiling"] = roofline.calibrate_gather_rates(
        {"block": view.packed}, QUERIES, device=device, sector_masks={"block": bmask},
        lanes=CEILING_LANES, log=lambda m: log(f"[4p] {m}"))["block"]
    del walk_idx
    del args, mat_d, seed_only, single, digram, ngram3, ng3, view
    torch.cuda.empty_cache()
    stats["corpora"] = pairless_corpus_checks(rec, device)
    stats["a_s"] = time.time() - t_phase

    # (b) a wide amino view on compact rows
    t_b = time.time()
    rng = np.random.default_rng(2614)
    text = random_text(rng, AMINO_RESIDUES, AlphabetType.AMINO)
    t = time.time()
    aa = create_index(text, IndexConfiguration(8, AMINO_SEED_K, AlphabetType.AMINO),
                      sa_backend="native", device=device)
    torch.cuda.synchronize()
    stats["amino_build_s"] = time.time() - t
    narrow = SearchEngine(aa, device=device)
    arr = np.frombuffer(text, np.uint8)
    windows = np.lib.stride_tricks.sliding_window_view(arr, AMINO_KMER_LEN)
    buf = windows[rng.integers(0, len(arr) - AMINO_KMER_LEN, size=QUERIES)].tobytes()
    aa_kmers = [buf[i * AMINO_KMER_LEN : (i + 1) * AMINO_KMER_LEN] for i in range(QUERIES)]
    del windows, buf
    want_counts = narrow.count(aa_kmers)
    want_lens, want_flat = flat_hits(narrow.locate(aa_kmers))
    if not (want_counts >= 1).all():
        raise AssertionError("[4p] a sampled amino 12-mer counted 0")
    walks = aa_kmers[:SINGLE_QUERY_WALKS]
    want_ranges = narrow.find_ranges(walks)
    lf_pos = [int(p) for p in rng.integers(0, aa.bwt_length, SINGLE_QUERY_WALKS)]
    lett_want, lf_want = rank.letter_and_lf_plain(
        narrow.dev, torch.tensor(lf_pos, dtype=torch.int64, device=device))
    log(f"[4p] amino index: {AMINO_RESIDUES} residues, seed k={AMINO_SEED_K}, ratio 8, built in "
        f"{stats['amino_build_s']:.3f}s; the narrow engine's answers to {QUERIES} "
        f"{AMINO_KMER_LEN}-mers: {len(want_flat)} hits")
    t = time.time()
    view = aa.to_device(device, wide=True, pair_rows=False)
    torch.cuda.synchronize()
    if view.pair_fused or view.packed.shape[1] != 384:
        raise AssertionError("[4p] the amino view without pair rows is not on compact rows")
    log(f"[4p] to_device(wide=True, pair_rows=False) in {time.time() - t:.3f}s: "
        f"{view.packed.shape[0]} rows x {view.packed.shape[1]} B = {view.packed.numel() / 1e6:.1f} MB "
        f"(pair-fused: {view.packed.shape[0] * 512 / 1e6:.1f} MB)")

    kernels.reset_launch_counts()
    t = time.time()
    bfs = seed_table.build_seed_table(view, view.cardinality, AMINO_SEED_K, aa.prefix_sums)
    torch.cuda.synchronize()
    stats["amino_bfs_s"] = time.time() - t
    if not torch.equal(bfs, view.seed_table):
        raise AssertionError("[4p] K1WX's BFS over compact rows differs from the narrow table widened")
    if seed_table.bfs_launches(view, AMINO_SEED_K) != 1:
        raise AssertionError(f"[4p] the k={AMINO_SEED_K} BFS over compact rows is not one launch")
    comp = SearchEngine(aa, device=device, wide=True, pair_rows=False)
    if comp.dev is not view:
        raise AssertionError("[4p] the compact engine did not take the installed view")
    counts, count_s, _ = timed_engine_call(comp.count, aa_kmers)
    hits, locate_s, _ = timed_engine_call(comp.locate, aa_kmers)
    lens, flat = flat_hits(hits)
    del hits
    if not (np.array_equal(counts, want_counts) and np.array_equal(lens, want_lens)
            and np.array_equal(flat, want_flat)):
        raise AssertionError("[4p] the compact amino engine differs from the narrow amino engine")
    stats["amino_count_qps"] = QUERIES / count_s
    stats["amino_locate_qps"] = QUERIES / locate_s
    pick = np.random.default_rng(2615).integers(0, QUERIES, HOST_SAMPLE)
    host_sample({"queries": pick.tolist(), "counts": [count_overlapping(text, aa_kmers[i]) for i in pick]},
                aa_kmers, arr, {"compact amino": comp}, "[4p]", counts=counts)
    ps_host = [int(c) for c in aa.prefix_sums]
    for q, (want_s, want_e) in zip(walks, want_ranges):
        letters = alpha.ascii_to_index(np.frombuffer(q, np.uint8), aa.alphabet).tolist()
        s, e = ps_host[letters[-1]], ps_host[letters[-1] + 1] - 1
        for lett in reversed(letters[:-1]):
            s, e = pt.iterative_step_backward_search(aa, s, e, lett, device=device, wide=True,
                                                     pair_rows=False)
        if (s, e) != (int(want_s), int(want_e)):
            raise AssertionError(f"[4p] {q} walked to {(s, e)}, the narrow range is "
                                 f"{(want_s, want_e)}")
    for p, lw, fw in zip(lf_pos, lett_want.tolist(), lf_want.tolist()):
        got = pt.backtrace_return_previous_letter_index(aa, p, device=device, wide=True,
                                                        pair_rows=False)
        if got != ((0, p) if lw == view.sentinel else (lw, fw)):
            raise AssertionError(f"[4p] LF of {p} over compact rows gave {got}")
    steps = SINGLE_QUERY_WALKS * (AMINO_KMER_LEN - 1)
    launches = expect_launches("4p", COMPACT_KERNELS, exact={
        "k1w_extend_compact": 1, "k1w_extend_compact.bfs": 1,
        "k1w_rank_compact": steps + len(lf_pos),
        "k1w_rank_compact.step": steps, "k1w_rank_compact.lf_at": len(lf_pos),
        "k1w_rank_compact.occ": 0, "k1w_rank": 0,
        "k1w_extend": 0, "k2w_ranges": 0, "k3w_backtrace_resolve": 0})
    stats["launches"].update({n: launches[n] for n in COMPACT_KERNELS})
    stats["launches"].update({f"k1w_rank_compact.{m}": launches[f"k1w_rank_compact.{m}"]
                              for m in ("step", "lf_at")})
    steps += len(lf_pos)
    single_edges(rec, view, rng, "[4p]", sentinel_pos=int(
        np.flatnonzero(aa.bwt_letters == aa.sentinel_index)[0]))
    stats["single_query"] = single_query_calls(
        rec, aa, {"wide": True, "pair_rows": False}, walks[:16], lf_pos[:64], device, "4p")
    log(f"[4p] compact amino engine: count {QUERIES} x {AMINO_KMER_LEN}-mers "
        f"{QUERIES / count_s:.1f} q/s, locate {QUERIES / locate_s:.1f} q/s ({len(flat)} hits), "
        f"equal to the narrow amino engine; K1WX's k={AMINO_SEED_K} BFS over the 384 B rows "
        f"{stats['amino_bfs_s']:.4f}s equal to the narrow table widened; the single-query API "
        f"over {SINGLE_QUERY_WALKS} 12-mers ({steps} K1w launches) equal to the narrow answers")

    # each compact form against its plain version, and K2w, K3w against
    # their pair-fused forms, at this path's shapes
    stats["bfs"] = compact_bfs(rec, view, aa.prefix_sums, bfs)
    del bfs
    mat, lengths, n = comp.encode_kmers(aa_kmers)
    seeded = comp._seed_eligibility(mat, lengths)
    args = (torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
            torch.from_numpy(seeded.astype(np.uint8)).to(device))
    classes = torch.zeros(3, dtype=torch.int64, device=device)
    ps, pe = search.ranges_plain(view, *args, classes)
    ks, ke = kernels.k2_ranges(view, *args)
    rec.compare("k2w_ranges_compact", f"main start x{n}", ks, ps)
    rec.compare("k2w_ranges_compact", f"main end x{n}", ke, pe)
    classes = classes.tolist()
    positions = search.enumerate_range_positions(ks[:len(aa_kmers)], search.range_counts(
        ks[:len(aa_kmers)], ke[:len(aa_kmers)], wide=True))
    rec.compare("k3w_backtrace_resolve_compact", f"main hits x{positions.numel()}",
                kernels.k3_backtrace_resolve(view, positions),
                search.backtrace_resolve_plain(view, positions))
    occ_n = 1 << 23
    occ_pos = torch.from_numpy(rng.integers(0, view.bwt_length, occ_n)).to(device)
    occ_lett = torch.from_numpy(rng.integers(0, view.cardinality, occ_n).astype(np.int32)).to(device)
    rec.compare("k1w_rank_compact", f"main occ x{occ_n}", kernels.k1_occurrence(view, occ_pos, occ_lett),
                rank.occurrence_plain(view, occ_pos, occ_lett))
    ps_arr = aa.prefix_sums
    rec.ms["k1w_rank_compact"] = time_in_turns(
        f"k1w_rank_compact x{occ_n}", lambda: kernels.k1_occurrence(view, occ_pos, occ_lett),
        lambda: rank.occurrence_plain(view, occ_pos, occ_lett), 10, 2)
    rec.ms["k2w_ranges_compact"] = time_in_turns(
        f"k2w_ranges_compact x{n}", lambda: kernels.k2_ranges(view, *args),
        lambda: search.ranges_plain(view, *args), 10, 1)
    # the [models] lines' other visits: K2w's seed-table visit and stores,
    # K3w's SA visit, each by a launch that makes no step
    seed_only = lengthwise_batch(args[0], AMINO_KMER_LEN, AMINO_SEED_K)
    sampled = (positions // view.ratio) * view.ratio
    rec.fixed["k2w_ranges_compact"] = min(
        cuda_ms(lambda: kernels.k2_ranges(view, *seed_only), 10) for _ in range(2))
    rec.fixed["k3w_backtrace_resolve_compact"] = min(
        cuda_ms(lambda: kernels.k3_backtrace_resolve(view, sampled), 10) for _ in range(2))
    log(f"  k2w_ranges_compact with no step: {rec.fixed['k2w_ranges_compact']:.4f} ms; "
        f"k3w_backtrace_resolve_compact with no LF step: "
        f"{rec.fixed['k3w_backtrace_resolve_compact']:.4f} ms")
    del seed_only, sampled
    rec.ms["k3w_backtrace_resolve_compact"] = time_in_turns(
        f"k3w_backtrace_resolve_compact x{positions.numel()}",
        lambda: kernels.k3_backtrace_resolve(view, positions),
        lambda: search.backtrace_resolve_plain(view, positions), 10, 1)
    fused = aa.to_device(device, wide=True, pair_rows=True)
    if not fused.pair_fused or fused.packed.shape[1] != 512:
        raise AssertionError("[4p] the amino view with pair rows is not pair-fused")
    ws, we = kernels.k2_ranges(fused, *args)
    wh = kernels.k3_backtrace_resolve(fused, positions)
    if not (torch.equal(ws, ks) and torch.equal(we, ke)
            and torch.equal(wh, kernels.k3_backtrace_resolve(view, positions))):
        raise AssertionError("[4p] K2w or K3w over compact rows differs from the pair-fused form")
    # the C launchers check the rows' layout themselves: each refuses the
    # other layout's table before it launches anything
    lib = kernels._library()
    refused = torch.empty(4, dtype=torch.int64, device=device)
    for entry, other in (("awfm_k1w_occ", view), ("awfm_k1w_compact_occ", fused),
                         ("awfm_k1_occ", view)):
        rc = getattr(lib, entry)(view.device.index, ctypes.byref(kernels._tables(other)),
                                 occ_pos.data_ptr(), occ_lett.data_ptr(), 4, refused.data_ptr(),
                                 kernels._stream(view.device))
        if rc == 0:
            raise AssertionError(f"[4p] {entry} took {other.packed.shape[1]} B rows")
    log("[4p] awfm_k1w_occ refused the 384 B compact rows, awfm_k1w_compact_occ the 512 B "
        "pair-fused rows and awfm_k1_occ the compact rows, before any launch")
    stats["forms"]["k2w_ranges"] = forms_in_turns(
        f"K2w, {n} amino 12-mers, pair-fused rows against compact rows", {
            "pair-fused": lambda: kernels.k2_ranges(fused, *args),
            "compact": lambda: kernels.k2_ranges(view, *args)})
    stats["forms"]["k3w_backtrace_resolve"] = forms_in_turns(
        f"K3w, {positions.numel()} hits, pair-fused rows against compact rows", {
            "pair-fused": lambda: kernels.k3_backtrace_resolve(fused, positions),
            "compact": lambda: kernels.k3_backtrace_resolve(view, positions)})
    del fused, ws, we, wh
    nb, np_, ms_b = view.num_blocks, view.n_planes, view.milestone_bytes
    rec.set_bound("k1w_rank_compact", [(nb, np_ * 32 + ms_b, occ_n)], occ_n * (8 + 4 + 8),
                  occ_n * rank_ops(np_))
    tables, ops = block_step_tables(nb, np_, ms_b, classes)
    rec.set_bound("k2w_ranges_compact", tables, n * (mat.shape[1] + 4 + 1 + 2 * 8 + 16), ops,
                  other_visits={"seed_table": n})
    _, off = kernels.k3_backtrace_resolve(dataclasses.replace(view, sampled_sa=None), positions)
    walked = int(off.sum())
    rec.set_bound("k3w_backtrace_resolve_compact", [(nb, np_ * 32 + ms_b, walked)],
                  positions.numel() * (8 + 8 + 8), walked * rank_ops(np_),
                  other_visits={"sampled_sa": positions.numel()})
    set_bfs_bound(rec, "k1w_extend_compact", view, AMINO_SEED_K, ps_arr, "4p")
    set_bfs_bound(rec, "k1w_extend_compact.bfs", view, AMINO_SEED_K, ps_arr, "4p",
                  in_launch=seed_table.bfs_depths(view.cardinality, AMINO_SEED_K,
                                                  seed_table.bfs_max_parents(view)))
    cmask = roofline.first_block_visits(AlphabetType.AMINO, compact=True)["compact"][0]
    stats["rates"]["compact"] = roofline.calibrate_gather_rates(
        {"compact": view.packed}, QUERIES, device=device, sector_masks={"compact": cmask},
        log=lambda m: log(f"[4p] {m}"))["compact"]
    log(f"[4p] K2w's steps over compact rows: {class_shares(classes)}; K3w: {walked} LF steps "
        f"for {positions.numel()} hits")
    del view, comp, narrow, aa, args, positions, occ_pos, occ_lett, ks, ke, ps, pe
    torch.cuda.empty_cache()
    stats["b_s"] = time.time() - t_b
    log(f"[4p] phase 4p took {time.time() - t_phase:.1f}s ((a) {stats['a_s']:.1f}s, "
        f"(b) {stats['b_s']:.1f}s)")
    return stats



def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def rank_main(config_path: str, rank: int) -> int:
    """One rank of a phase-9a world (``chip_smoke.py --rank-of CONFIG RANK``):
    join the world, load the 64M index's .awfmx on this rank's card (K1X
    rebuilds the seed table), then over the narrow and the forced-wide
    view run ``count_allgather`` on this rank's slice of the 25-mers and
    ``resolve_allgather`` on its slice of the positions, a warm-up call and
    a timed one each; save the merged arrays and time the all-gather of a
    slice's worth of int64 alone. Prints one ``RANK {...}`` line."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch.io import artifact
    from avxwindowfmindex_tpu_torch.ops import kernels
    from avxwindowfmindex_tpu_torch.parallel import dist

    with open(config_path) as fh:
        cfg = json.load(fh)
    world, device = cfg["world"], cfg["devices"][rank]
    backend = dist.init_process_group(world, rank, cfg["init"], device, backend=cfg["backend"])
    kernels.build()
    rec = {"rank": rank, "device": device, "backend": backend,
           "card": torch.cuda.get_device_name(torch.device(device))}
    kernels.reset_launch_counts()
    t = time.perf_counter()
    index = artifact.load_artifact(cfg["artifact"], device=device)
    torch.cuda.synchronize()
    rec["load_s"] = time.perf_counter() - t
    rec["launches"] = {"load": kernels.launch_counts()}

    def part(arr):
        return arr[rank * len(arr) // world : (rank + 1) * len(arr) // world]

    local_kmers = [row.tobytes() for row in part(np.load(cfg["kmers"]))]
    local_pos = part(np.load(cfg["positions"]))
    for tag, wide in (("narrow", False), ("wide", True)):
        eng = dist.DistributedSearchEngine(index.to_device(device, wide=wide), [device])
        kernels.reset_launch_counts()
        for op, fn, arg in (("count", eng.count_allgather, local_kmers),
                            ("resolve", eng.resolve_allgather, local_pos)):
            fn(arg)  # warm-up
            torch.distributed.barrier()
            t = time.perf_counter()
            merged = fn(arg)
            rec[f"{tag}_{op}_s"] = time.perf_counter() - t
            np.save(os.path.join(cfg["out"], f"{tag}_{op}_{rank}.npy"), merged)
        rec["launches"][tag] = kernels.launch_counts()
        del eng
    payload = torch.zeros(len(local_pos), dtype=torch.int64, device=device)
    dist.process_allgather(payload)
    torch.cuda.synchronize()
    reps = 10
    t = time.perf_counter()
    for _ in range(reps):
        dist.process_allgather(payload)
    torch.cuda.synchronize()
    rec["allgather_ms"] = (time.perf_counter() - t) / reps * 1e3
    torch.distributed.destroy_process_group()
    print("RANK " + json.dumps(rec), flush=True)
    return 0


def phase_multiprocess(engine, kmers, answers, main: dict, device: str) -> dict:
    """Phase 9a: the multi-process front at full size. The 64M index is
    saved as an .awfmx of its own; each world's ranks (``rank_main``) load
    it on their cards and merge counts and hits by all-gather; the parent
    holds every rank's merged arrays to phase 4's counts and to its own
    ``SearchEngine.resolve_positions`` on the same positions, exactly.
    Worlds: NCCL, one card a rank, on a host of two or more cards; on one
    card, two gloo ranks sharing cuda:0 (NCCL refuses two ranks on one
    card) and a one-rank NCCL world. Returns each world's numbers and the
    ranks' launches summed."""
    import tempfile

    import numpy as np
    import torch
    import avxwindowfmindex_tpu_torch as pt
    from avxwindowfmindex_tpu_torch.io import artifact
    from avxwindowfmindex_tpu_torch.ops import seed_table
    from avxwindowfmindex_tpu_torch.parallel import dist

    counts = answers[0]
    main_bfs = seed_table.bfs_launches(engine.dev, MAIN_SEED_K)  # K1X's launches a load
    single = pt.SearchEngine(engine.dev, device=device)
    ranges = single.find_ranges(kmers)
    positions = np.where(ranges[:, 0] <= ranges[:, 1], ranges[:, 0], 0).astype(np.uint64)
    want = {"count": counts, "resolve": single.resolve_positions(positions)}
    n_cards = torch.cuda.device_count()
    worlds = ([("nccl", [f"cuda:{i}" for i in range(n_cards)])] if n_cards >= 2 else
              [("gloo", [device, device]), ("nccl", [device])])
    torch.cuda.empty_cache()
    stats = {"worlds": [], "rank_launches": {}}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    build_dir = os.path.join(REPO, "avxwindowfmindex_tpu_torch", "build", "chip_smoke")
    os.makedirs(build_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as td:
        path = os.path.join(td, "main.awfmx")
        t = time.time()
        artifact.save_artifact(engine.host_index, path, compress=False)
        np.save(os.path.join(td, "kmers.npy"),
                np.frombuffer(b"".join(kmers), np.uint8).reshape(len(kmers), KMER_LEN))
        np.save(os.path.join(td, "positions.npy"), positions)
        log(f"[9a] the 64M index saved as an .awfmx without its seed table, the "
            f"{len(kmers)} 25-mers and their ranges' first positions: {time.time() - t:.3f}s")
        for backend, devices in worlds:
            world = len(devices)
            cfg = {"world": world, "devices": devices, "backend": backend,
                   "init": f"tcp://127.0.0.1:{free_port()}", "artifact": path,
                   "kmers": os.path.join(td, "kmers.npy"),
                   "positions": os.path.join(td, "positions.npy"), "out": td}
            cfg_path = os.path.join(td, f"world_{backend}_{world}.json")
            with open(cfg_path, "w") as fh:
                json.dump(cfg, fh)
            t = time.time()
            outs = dist.spawn_ranks([sys.executable, os.path.abspath(__file__), "--rank-of",
                                     cfg_path], world, timeout=RANK_TIMEOUT_S, env=env)
            wall = time.time() - t
            recs = [json.loads(line[len("RANK "):]) for out in outs
                    for line in out.splitlines() if line.startswith("RANK ")]
            if sorted(r["rank"] for r in recs) != list(range(world)):
                raise AssertionError(f"[9a] {backend} world of {world}: rank lines {recs}")
            label = (f"{backend}, {world} rank(s) on {sorted(set(devices))}"
                     + (" (collectives through host memory)" if backend == "gloo" else ""))
            for r in recs:
                load, narrow, wide = (r["launches"][k] for k in ("load", "narrow", "wide"))
                if load["k1_extend"] != main_bfs or load.get("k1_extend.bfs") != 1 or load["k1_rank"]:
                    raise AssertionError(f"[9a] rank {r['rank']}: load launched K1X "
                                         f"{load['k1_extend']} times and K1 {load['k1_rank']}")
                for launches, names in ((narrow, ("k2_ranges", "k3_backtrace_resolve")),
                                        (wide, ("k2w_ranges", "k3w_backtrace_resolve"))):
                    if any(launches[n] != 2 for n in names):
                        raise AssertionError(f"[9a] rank {r['rank']}: {names} launched "
                                             f"{[launches[n] for n in names]} times, not 2 each")
                for part in (load, narrow, wide):
                    for name, c in part.items():
                        stats["rank_launches"][name] = stats["rank_launches"].get(name, 0) + c
                for tag in ("narrow", "wide"):
                    for op in ("count", "resolve"):
                        got = np.load(os.path.join(td, f"{tag}_{op}_{r['rank']}.npy"))
                        if got.dtype != np.uint64 or not np.array_equal(got, want[op]):
                            raise AssertionError(f"[9a] {label}: rank {r['rank']}'s merged "
                                                 f"{tag} {op} differs from the parent's")
                log(f"[9a] {label}: rank {r['rank']} on {r['card']}: load_artifact "
                    f"{r['load_s']:.3f}s (K1X {load['k1_extend']} launches); "
                    + "; ".join(f"{tag} count_allgather {r[f'{tag}_count_s']:.3f}s -> "
                                f"{len(kmers) / r[f'{tag}_count_s']:.1f} q/s, resolve_allgather "
                                f"{r[f'{tag}_resolve_s']:.3f}s -> "
                                f"{len(kmers) / r[f'{tag}_resolve_s']:.1f} q/s"
                                for tag in ("narrow", "wide"))
                    + f"; the all-gather of {len(kmers) // world} int64 alone "
                    f"{r['allgather_ms']:.3f} ms")
            slowest = {key: max(r[key] for r in recs) for key in
                       ("narrow_count_s", "narrow_resolve_s", "wide_count_s", "wide_resolve_s",
                        "allgather_ms")}
            stats["worlds"].append({"backend": backend, "devices": devices, "wall_s": wall,
                                    **slowest})
            log(f"[9a] {label}: every rank's merged counts and hits (narrow and wide) equal to "
                f"phase 4's and the parent's at tolerance 0; K1X {main_bfs} launches a "
                f"rank; the world took {wall:.1f}s. Slowest rank: count "
                f"{len(kmers) / slowest['narrow_count_s']:.1f} q/s (phase 7e's "
                f"DistributedSearchEngine.count in one process "
                f"{len(kmers) / main['public_api']['dist_count_s']:.1f} q/s), resolve "
                f"{len(kmers) / slowest['narrow_resolve_s']:.1f} q/s, all-gather "
                f"{slowest['allgather_ms']:.3f} ms "
                f"({slowest['allgather_ms'] / 1e3 / slowest['narrow_count_s']:.1%} of the count)")
    log(f"[9a] worlds run: {[(w['backend'], w['devices']) for w in stats['worlds']]}; the ranks' "
        f"launches: { {n: c for n, c in stats['rank_launches'].items() if c} }")
    return stats


def phase_scaling_report() -> list:
    """Phase 9b: ``tools/scaling_report`` on the card at 16M bases and
    1,048,576 25-mers: rungs of 1 and 2 devices and the two-process rung;
    every rung must have its row."""
    import tempfile

    from avxwindowfmindex_tpu_torch.tools import scaling_report

    with tempfile.TemporaryDirectory() as td:
        out = os.path.join(td, "scaling.json")
        rc = scaling_report.main([
            "--platform", "cuda", "--hosts", "2", "--bases", "16777216", "--queries", "1048576",
            "--kmer-len", "25", "--seed-k", "14", "--devices", "1,2", "--repeats", "1",
            "--json", out,
        ])
        with open(out) as fh:
            rows = json.load(fh)["rows"]
    if rc != 0 or [(r["devices"], r["hosts"]) for r in rows] != [(1, 1), (2, 1), (2, 2)]:
        raise AssertionError(f"[9b] scaling_report returned {rc} with rows {rows}")
    for r in rows:
        log(f"[9b] {json.dumps(r)}")
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bases", type=int, default=64_000_000)
    ap.add_argument("--rank-of", nargs=2, metavar=("CONFIG", "RANK"),
                    help="run one rank of a phase-9a world (the script starts them itself)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a GPU")
    if args.rank_of:
        return rank_main(args.rank_of[0], int(args.rank_of[1]))
    from avxwindowfmindex_tpu_torch.ops import kernels, seed_table
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import CEILING_LANES

    device = "cuda:0"
    smi = nvidia_smi_line()
    log(f"[1] {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    build_s = kernels.build()
    log(f"[2] kernels built in {build_s:.2f}s -> {kernels.library_path()}")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")

    mark("build")
    rec = Record()
    small_index, small_text = phase_kernels(rec, device)
    mark("phase 3")
    phase_kernels(rec, device, wide=True)
    mark("phase 3w")
    phase_probes(rec, device)
    mark("phase 3b")
    phase_enumerate(rec, device)
    mark("phase 3e")

    kernels.reset_launch_counts()
    main_stats, engine, kmers, seq_arr, mh_kmers, answers = phase_main(args.bases, device)
    # the build's BFS is K1X's launches (the BFS mode's one for depths 1-9,
    # then one a depth), and nothing of the path takes K1
    launches = expect_launches("4", MAIN_PATH_KERNELS, exact={
        "k1_extend": seed_table.bfs_launches(engine.dev, MAIN_SEED_K), "k1_extend.bfs": 1,
        "k1_rank": 0})
    main_stats["main_shapes"] = phase_main_shapes(rec, engine, kmers)
    mark("phase 4")

    small_path = phase_roundtrip(small_index, small_text, device)
    bench_stats = phase_bench(rec, engine, kmers, seq_arr, device)
    for name in BENCH_KERNELS:
        launches[name] = bench_stats["launches"][name]
    main_stats["bench"] = {k: bench_stats["meta"][k] for k in BENCH_SUMMARY_KEYS}
    main_stats["bench"]["gather_rates_whole_rows"] = bench_stats["whole_row_rates"]
    main_stats["k6_single_gather"] = rec.k6
    mark("phases 5 and 6")
    main_stats["step_costs"] = phase_step_costs(
        rec, engine, kmers, bench_stats["dense"], bench_stats["meta"]["gather_rates_rows_per_sec"])
    mark("phase 4s")

    wide_stats = phase_wide_main(
        rec, engine.host_index, engine.dev, bench_stats["dense"], kmers, mh_kmers, seq_arr,
        answers, device,
    )
    wide_launches = wide_stats.pop("launches")
    for name in WIDE_PATH_KERNELS:
        launches[name] = wide_launches[name]
    main_stats["wide"] = wide_stats
    del bench_stats["dense"]
    torch.cuda.empty_cache()
    mark("phase 4w")
    main_stats["straddle"] = phase_straddle(rec, device)
    mark("phase 4x")
    main_stats["public_api"] = phase_public_api(
        engine, kmers, seq_arr, answers, small_index, small_text, small_path, main_stats, device,
    )
    main_stats["single_query"] = phase_single_query(rec, engine, kmers, device)
    launches.update(main_stats["single_query"].pop("launches"))
    mark("phase 7")
    main_stats["range_sharded"] = phase_range_sharded(rec, engine, kmers, answers, device)
    launches.update(main_stats["range_sharded"]["launches"])
    mark("phase 8")
    main_stats["pairless"] = phase_pairless(rec, engine, kmers, mh_kmers, answers, main_stats,
                                            seq_arr, device)
    launches.update(main_stats["pairless"].pop("launches"))
    del mh_kmers
    mark("phase 4p")
    main_stats["multiprocess"] = phase_multiprocess(engine, kmers, answers, main_stats, device)
    rank_launches = main_stats["multiprocess"]["rank_launches"]
    del engine, kmers, answers
    torch.cuda.empty_cache()
    mark("phase 9a")
    main_stats["scaling_report"] = phase_scaling_report()
    mark("phase 9b")
    torch.cuda.synchronize()

    # logged, not in the kernels line: each index kernel's row visits over
    # 3.35 TB/s (the stages' roofline), and every visit it makes at a rate
    # measured in this process: the row visits at the calibrated random-row
    # rate of the table (where a table sits in the L2), the seed-table
    # visit of K2, K2w and K4 and the SA visit of K3 and K3w at the time of
    # a launch that makes those visits and no step (K4: the fixed term of
    # its fit over query lengths)
    rates = dict(main_stats["bench"]["gather_rates_rows_per_sec"],
                 wide=wide_stats["gather_rate_rows_per_sec"], **main_stats["pairless"]["rates"])
    rate_of = {
        "k1_rank": ("single",), "k2_ranges": ("pair",), "k3_backtrace_resolve": ("single",),
        "k4_ngram_ranges": ("ngram_pair", "pair"), "k1w_rank": ("wide",),
        "k1_extend": ("single",), "k1w_extend": ("wide",),
        "k1_extend.bfs": ("single",), "k1w_extend.bfs": ("wide",),
        "k2w_ranges": ("wide",), "k3w_backtrace_resolve": ("wide",),
        # a view without pair rows: its steps visit the block rows, whose
        # calibrated rate is the single table's
        "k2_ranges_block": ("single",), "k4_ngram_ranges_block": ("ngram_pair", "single"),
        "k4_ngram_ranges_block n=3": ("ngram_pair3", "single"),
        # the compact amino rows at their calibrated rate (phase 4p)
        "k1w_rank_compact": ("compact",), "k1w_extend_compact": ("compact",),
        "k1w_extend_compact.bfs": ("compact",),
        "k2w_ranges_compact": ("compact",), "k3w_backtrace_resolve_compact": ("compact",),
    }
    main_stats["models"] = {}
    for name, tables in rate_of.items():
        model = rec.model[name]
        rows_ms = sum(v / rates[t] for v, t in zip(model["row_visits"], tables)) * 1e3
        all_ms = rows_ms + rec.fixed.get(name, 0.0)
        if model["other_visits"] and name not in rec.fixed:
            raise AssertionError(f"{name}: no time measured for its {model['other_visits']}")
        main_stats["models"][name] = {"ms": rec.ms[name][0], "row_visits_ms": rows_ms,
                                      "all_visits_ms": all_ms}
        log(f"[models] {name}: {rec.ms[name][0]:.4f} ms; row traffic over 3.35 TB/s "
            f"{model['row_traffic_ms']:.4f} ms; row visits at the calibrated rate {rows_ms:.4f} ms; "
            f"with {model['other_visits'] or 'no other visit'} {all_ms:.4f} ms: "
            f"ms / model {rec.ms[name][0] / all_ms:.3f}")
    # K2 over block rows against the block rows' ceiling: the same visits
    # at the rate of K5's walk with CEILING_LANES lanes a chain (phase 4p)
    model = rec.model["k2_ranges_block"]
    rate = rates["single, ceiling"]
    rows_ms = model["row_visits"][0] / rate * 1e3
    all_ms = rows_ms + rec.fixed["k2_ranges_block"]
    main_stats["models"]["k2_ranges_block, ceiling"] = {"rate": rate, "all_visits_ms": all_ms}
    log(f"[models] k2_ranges_block against the walk with {CEILING_LANES} lanes a chain "
        f"({rate / 1e9:.2f}G visits/s): row visits {rows_ms:.4f} ms, with the no-step launch "
        f"{all_ms:.4f} ms: ms / model {rec.ms['k2_ranges_block'][0] / all_ms:.3f}")

    log(f"[summary] {json.dumps(main_stats)}")
    log(smi)
    # K1's single-query modes are entries of their own: launches on their
    # path (7f, 4p), per-call host ms against the plain version's, their
    # bound beside the floor of a call and the kernel's device time; so is
    # the BFS mode of K1WX over compact rows (4p: the whole k = 5 table in
    # one launch), beside the per-depth entry k1w_extend_compact
    entries = [(k, k.name) for k in kernels.KERNELS] + [
        (k, f"{k.name}.{mode}") for k in (kernels.K1, kernels.K1W, kernels.K1W_COMPACT)
        for mode in SINGLE_MODES] + [
        (k, f"{k.name}.bfs") for k in (kernels.K1X, kernels.K1WX, kernels.K1WX_COMPACT)]
    print(json.dumps({"kernels": [
        {
            "name": name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[name] + rank_launches.get(name, 0),
            "rank_launches": rank_launches.get(name, 0), "max_abs_err": rec.err[name],
            "ms": rec.ms[name][0], "plain_ms": rec.ms[name][1],
            **rec.bound[name], "library_ms": rec.library.get(name),
        }
        for k, name in entries
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

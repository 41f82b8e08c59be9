#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

    python3 chip_smoke.py [--bases N]

Phases (any failure raises and the script exits nonzero):
  1. the card and the software; requires torch.cuda.is_available();
  2. build the CUDA kernels from avxwindowfmindex_tpu_torch/csrc/;
  3. each kernel against its plain torch version on the same CUDA
     tensors (1M-base DNA and amino indexes; K4 through n = 2 and 3
     tables, biased and unbiased; a repeat-rich corpus whose ranges
     outgrow the 512-position pair window), with kernel and plain times
     side by side;
  4. the main path at full size: create_index on 64M random bases
     (seed k = 14, SA ratio 8, native SA-IS) -> DigramSearchEngine
     (n = 2, Cn-biased table, as bench.py runs it) -> count and locate
     of 1,048,576 sampled 25-mers, the same through the single-step
     SearchEngine, the digram ranges held equal to the single-step ones
     over every query, and locate of 4,096 multi-hit 11-mers (shorter
     than k, so they fall back to the single-step kernel), all checked
     against host scans; the kernels' launch counts are reset just
     before and read just after; then a stage breakdown of one digram
     locate, and each kernel against its plain version at the shapes the
     main path gave it, timed in turns;
  3b. the gather-rate probes against their plain versions: K5 at each
     experiment's own shapes (P2/P4: 2^19 indices over 1 GiB tables of
     128 B and 512 B rows, ring depths 8 and 16; P3: (2^20, 8, 128) 1 KB
     rows, the first 128 B summed; an all-0xFF table for the int32 wrap)
     and K6 at P5's (S = 2048 and 8192, single and chained), timed in
     turns;
  5. a .awfmi round trip of the 1M-base index;
  6. the bench protocol (avxwindowfmindex_tpu_torch/tools/bench.py) on
     the phase-4 index at 1,048,576 queries and 3 runs: a ratio-4 device
     SA from densify_device_sa(4), held equal to a sa[::4] cut of the
     host suffix array; every stage, the cross-engine parity and the host
     spot checks, the calibration through K5 and K6 (their launches are
     counted here), and the meta line; locate_flat_device held equal to
     SearchEngine.locate on 4,096 queries; then K5's walk and K6's chain
     against their plain versions at the calibration shapes.

The last three lines are the card's name and power limit as nvidia-smi
prints them, one JSON object describing each kernel (its launches on the
path that runs it, its largest difference from the plain version, and
both times), and the result line {"ok": true, "device": {...}}.
--bases (default 64,000,000) is for local trials only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
MAIN_SEED_K = 14
KMER_LEN = 25
QUERIES = 1 << 20
MULTIHIT_LEN = 11
MULTIHIT_QUERIES = 4096
BENCH_MULTIHIT_QUERIES = 1 << 19  # bench.py's multi-hit stage below 1G bases
EXACT = 0  # every quantity compared is an integer: tolerance 0
# the kernels each path launches: phase 4 (the main path), phase 6 (the
# bench's calibration), whose counts the kernels line reports
MAIN_PATH_KERNELS = ("k1_rank", "k2_ranges", "k3_backtrace_resolve", "k4_ngram_ranges")
BENCH_KERNELS = ("k5_gather_reduce", "k6_slab_gather")
BENCH_SUMMARY_KEYS = (
    "count_qps", "count_ngram_qps", "locate_first_hit_qps", "locate_all_qps",
    "locate_all_dense_sa_qps", "multihit_qps", "gather_rates_rows_per_sec",
)


def log(msg: str) -> None:
    print(msg, flush=True)


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


def time_in_turns(label: str, kernel_fn, plain_fn, kernel_reps: int, plain_reps: int):
    """(kernel ms, plain ms), each the best of two runs taken in turns:
    plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain_fn, plain_reps)
    k1 = cuda_ms(kernel_fn, kernel_reps)
    k2 = cuda_ms(kernel_fn, kernel_reps)
    p2 = cuda_ms(plain_fn, plain_reps)
    log(f"  {label} time: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms")
    return min(k1, k2), min(p1, p2)


def max_abs_err(a, b) -> int:
    """Largest absolute difference of two integer tensors (0 when equal)."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape mismatch {tuple(a.shape)} vs {tuple(b.shape)}")
    if a.numel() == 0:
        return 0
    return int((a.to(torch.int64) - b.to(torch.int64)).abs().max())


class Record:
    """Per-kernel comparison results and main-shape timings."""

    def __init__(self):
        self.err = {}
        self.ms = {}

    def compare(self, kernel: str, what: str, got, want) -> None:
        err = max_abs_err(got, want)
        log(f"  {kernel} {what}: max_abs_err={err} over {got.numel()} values")
        if err > EXACT:
            raise AssertionError(f"{kernel} disagrees with its plain version ({what})")
        self.err[kernel] = max(self.err.get(kernel, 0), err)


def random_text(rng, n: int, alphabet) -> bytes:
    import numpy as np
    from avxwindowfmindex_tpu_torch import AlphabetType

    pool = b"ACDEFGHIKLMNPQRSTVWY" if alphabet == AlphabetType.AMINO else b"acgt"
    return rng.choice(np.frombuffer(pool, np.uint8), size=n).tobytes()


def phase_kernels(rec: Record, device: str):
    """Phase 3: each kernel against its plain torch version on the card."""
    import numpy as np
    import torch
    from avxwindowfmindex_tpu_torch import (
        AlphabetType, IndexConfiguration, NgramSearchEngine, SearchEngine, create_index,
    )
    from avxwindowfmindex_tpu_torch import search
    from avxwindowfmindex_tpu_torch.ops import kernels, ngram, rank, seed_table

    rng = np.random.default_rng(7)
    kept = None
    for alphabet, k, klen in ((AlphabetType.DNA, 10, 25), (AlphabetType.AMINO, 5, 12)):
        name = alphabet.name
        text = random_text(rng, 1_000_000, alphabet)
        t0 = time.time()
        index = create_index(text, IndexConfiguration(8, k, alphabet), sa_backend="native", device=device)
        torch.cuda.synchronize()
        log(f"[3] {name}: 1M-base index (k={k}, ratio 8) built in {time.time() - t0:.2f}s")
        dev = index.to_device(device)
        n = dev.bwt_length
        card = dev.cardinality

        # K1: seed table through the kernel vs through the plain occurrence
        plain_table = seed_table.build_seed_table(
            dev, card, k, index.prefix_sums, occurrence_fn=rank.occurrence_plain
        )
        rec.compare("k1_rank", f"{name} seed table k={k}", dev.seed_table, plain_table)

        # K1 occ mode: 1M random pairs, edge positions, a ragged batch size
        b = 1_000_000
        pos = rng.integers(0, n, size=b)
        lett = rng.integers(0, card + 1, size=b)
        edges = np.array([0, 7, 8, 255, n - 1])
        pos = np.concatenate([pos, np.repeat(edges, card + 1), [0xFFFFFFFF]])
        lett = np.concatenate([lett, np.tile(np.arange(card + 1), len(edges)), [0]])
        pos_t = torch.from_numpy(pos.astype(np.int64)).to(device)
        lett_t = torch.from_numpy(lett.astype(np.int32)).to(device)
        rec.compare(
            "k1_rank", f"{name} occ x{len(pos)}",
            kernels.k1_occurrence(dev, pos_t, lett_t), rank.occurrence_plain(dev, pos_t, lett_t),
        )
        lpos = torch.from_numpy(np.concatenate([rng.integers(0, n, size=b), edges])).to(device)
        kl, kf = kernels.k1_letter_and_lf(dev, lpos)
        pl, pf = rank.letter_and_lf_plain(dev, lpos)
        rec.compare("k1_rank", f"{name} letter x{len(lpos)}", kl, pl)
        rec.compare("k1_rank", f"{name} LF x{len(lpos)}", kf, pf)

        # K2: 64K seeded queries and 4K unseeded ones (short or ambiguous)
        eng = SearchEngine(index, device=device)
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
            rec.compare("k2_ranges", f"{name} {label} start x{len(qs)}", ks, ps)
            rec.compare("k2_ranges", f"{name} {label} end x{len(qs)}", ke, pe)
            k2_in[label] = args

        # K3: 256K positions, SA resident and SA on disk
        bpos = torch.from_numpy(rng.integers(0, n, size=1 << 18)).to(device)
        rec.compare(
            "k3_backtrace_resolve", f"{name} hits x{bpos.numel()}",
            kernels.k3_backtrace_resolve(dev, bpos), search.backtrace_resolve_plain(dev, bpos),
        )
        disk = dataclasses.replace(dev, sampled_sa=None)
        kp, ko = kernels.k3_backtrace_resolve(disk, bpos)
        pp, po = search.backtrace_resolve_plain(disk, bpos)
        rec.compare("k3_backtrace_resolve", f"{name} on-disk p", kp, pp)
        rec.compare("k3_backtrace_resolve", f"{name} on-disk off", ko, po)

        if alphabet == AlphabetType.DNA:
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
    dev = index.to_device(device)
    eng = SearchEngine(index, device=device)
    qs = [b"A" * L for L in range(6, 40)] + [text[s : s + 14] for s in rng.integers(0, 3990, 512)]
    mat, lengths, _ = eng.encode_kmers(qs)
    seeded = eng._seed_eligibility(mat, lengths)
    args = (
        torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
        torch.from_numpy(seeded.astype(np.uint8)).to(device),
    )
    ks, ke = kernels.k2_ranges(dev, *args)
    ps, pe = search.ranges_plain(dev, *args)
    rec.compare("k2_ranges", "overflow corpus start", ks, ps)
    rec.compare("k2_ranges", "overflow corpus end", ke, pe)
    widest = int((search.range_counts(ks, ke)).max())
    if widest <= 512:
        raise AssertionError(f"overflow corpus produced no range wider than 512 ({widest})")
    counts = eng.count(qs[:34])
    want = [count_overlapping(text, q) for q in qs[:34]]
    if list(counts) != want:
        raise AssertionError(f"overflow corpus counts {list(counts)} != {want}")
    log(f"  overflow corpus: widest range {widest}, {len(qs)} queries exact")

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
    return kept


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

    def timed(fn, runs=3):
        fn(kmers[:4096])  # warm-up
        times, out = [], None
        for _ in range(runs):
            t = time.time()
            out = fn(kmers)
            torch.cuda.synchronize()
            times.append(time.time() - t)
        return out, float(np.median(times)), times

    stats = {"build_s": build_s, "ngram_build_s": ngram_build_s}
    for label, eng in (("digram", engine), ("single", single)):
        counts, count_s, count_times = timed(eng.count)
        hits, locate_s, locate_times = timed(eng.locate)
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
    return stats, engine, kmers, seq_arr


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
    prefix_sums = engine.host_index.prefix_sums
    for label, occ_fn in (("kernel", None), ("plain", rank.occurrence_plain)):
        t = time.time()
        table = seed_table.build_seed_table(
            dev, dev.cardinality, k, prefix_sums, occurrence_fn=occ_fn
        )
        torch.cuda.synchronize()
        out[f"seed_table_{label}_s"] = time.time() - t
        if occ_fn is not None:
            rec.compare("k1_rank", f"main seed table k={k}", dev.seed_table, table)
        del table
    log(
        f"[4] seed table k={k}: through K1 {out['seed_table_kernel_s']:.4f}s, "
        f"plain {out['seed_table_plain_s']:.4f}s"
    )

    # one K1 launch of the BFS's deepest levels: 2 * CHUNK (pos, letter) pairs
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
    ps, pe = search.ranges_plain(dev, *args)
    rec.compare("k2_ranges", f"main start x{n}", k2_s, ps)
    rec.compare("k2_ranges", f"main end x{n}", k2_e, pe)
    ps, pe = search.ngram_ranges_plain(dev, ng, mat_d, KMER_LEN)
    rec.compare("k4_ngram_ranges", f"main n={ng.n} start x{n}", start, ps)
    rec.compare("k4_ngram_ranges", f"main n={ng.n} end x{n}", end, pe)
    del ps, pe
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
            time_in_turns(
                f"k5_gather_reduce {what} x{batch}",
                lambda: probes.gather_reduce(table, idx, sum_bytes=sum_bytes, chunk=chunk, ring=ring),
                lambda: probes.gather_reduce_plain(table, idx, sum_bytes, chunk), 20, 3,
            )
        if r == 512:
            # every byte 0xFF: each partial and the total wrap as int32
            table.fill_(0xFF)
            got = probes.gather_reduce(table, idx, sum_bytes=512, chunk=512, ring=8)
            total = probes.wrapped_total(got)
            want = probes.wrapped_total(probes.gather_reduce_plain(table, idx, 512, 512))
            rec.compare("k5_gather_reduce", f"all-0xFF total {total} (wrapped)",
                        torch.tensor([total]), torch.tensor([want]))
        del table, idx
        torch.cuda.empty_cache()
    log("[3b] K5 equals its plain version at every P2/P3/P4 shape")
    for s_rows in (2048, 8192):
        gen = torch.Generator(device=device).manual_seed(s_rows)
        slab = torch.randint(-(2**31), 2**31, (s_rows, probes.SLAB_LANES), dtype=torch.int32,
                             device=device, generator=gen)
        idx = gp._random_idx(s_rows, s_rows, device, 11)
        rec.compare("k6_slab_gather", f"P5 S={s_rows} single", probes.slab_gather(slab, idx),
                    probes.slab_gather_plain(slab, idx))
        for seg in (2, 8):
            rec.compare("k6_slab_gather", f"P5 S={s_rows} chain seg={seg}",
                        probes.slab_chain(slab, idx, seg), probes.slab_chain_plain(slab, idx, seg))
        time_in_turns(f"k6_slab_gather P5 S={s_rows} single", lambda: probes.slab_gather(slab, idx),
                      lambda: probes.slab_gather_plain(slab, idx), 20, 3)
        time_in_turns(f"k6_slab_gather P5 S={s_rows} chain seg=8",
                      lambda: probes.slab_chain(slab, idx, 8),
                      lambda: probes.slab_chain_plain(slab, idx, 8), 20, 3)
    log("[3b] K6 equals its plain version at S = 2048 and 8192, single and chained")


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
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"[6] launches in the bench protocol: {launches}")
    missing = [k for k in ("k2_ranges", "k3_backtrace_resolve", "k4_ngram_ranges",
                           "k5_gather_reduce", "k6_slab_gather") if launches[k] <= 0]
    if missing:
        raise AssertionError(f"the bench protocol never launched {missing}")
    log(f"[6] meta: {json.dumps(meta)}")
    log(f"[6] headline: {json.dumps(headline)}")

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

    # K5's walk and K6's chain at the calibration shapes
    rng = np.random.default_rng(99)
    tables = {"single": dev.packed, "pair": dev.packed_pair, "ngram_pair": ng.packed}
    for name, table in tables.items():
        idx = torch.from_numpy(rng.integers(0, table.shape[0], size=QUERIES).astype(np.int32)).to(device)
        for seg in (4, 20):
            rec.compare("k5_gather_reduce", f"walk {name} ({table.shape[1]} B) seg={seg} x{QUERIES}",
                        probes.gather_walk(table, idx, seg), probes.gather_walk_plain(table, idx, seg))
        rec.ms["k5_gather_reduce"] = time_in_turns(
            f"k5_gather_reduce walk {name} seg=20 x{QUERIES}",
            lambda: probes.gather_walk(table, idx, 20),
            lambda: probes.gather_walk_plain(table, idx, 20), 10, 1,
        )
    from avxwindowfmindex_tpu_torch.utils.roofline import SLAB_ROWS

    gen = torch.Generator(device=device).manual_seed(SLAB_ROWS)
    slab = torch.randint(-(2**31), 2**31, (SLAB_ROWS, probes.SLAB_LANES), dtype=torch.int32,
                         device=device, generator=gen)
    sidx = torch.from_numpy(rng.integers(0, SLAB_ROWS, size=QUERIES).astype(np.int32)).to(device)
    for seg in (4, 20):
        rec.compare("k6_slab_gather", f"slab chain S={SLAB_ROWS} seg={seg} x{QUERIES}",
                    probes.slab_chain(slab, sidx, seg), probes.slab_chain_plain(slab, sidx, seg))
    rec.ms["k6_slab_gather"] = time_in_turns(
        f"k6_slab_gather chain S={SLAB_ROWS} seg=20 x{QUERIES}",
        lambda: probes.slab_chain(slab, sidx, 20),
        lambda: probes.slab_chain_plain(slab, sidx, 20), 10, 1,
    )
    return {"launches": launches, "meta": meta, "headline": headline}


def phase_roundtrip(index, text: bytes, device: str) -> None:
    """Phase 5: .awfmi write, read back, equal counts and locates."""
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
    os.remove(path)
    log(f"[5] .awfmi round trip: {len(qs)} counts and locates equal (SA in memory and on disk)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bases", type=int, default=64_000_000)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is False: this script needs a GPU")
    from avxwindowfmindex_tpu_torch.ops import kernels

    device = "cuda:0"
    smi = nvidia_smi_line()
    log(f"[1] {smi}")
    log(f"[1] torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    build_s = kernels.build()
    log(f"[2] kernels built in {build_s:.2f}s -> {kernels.library_path()}")
    for line in kernels.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"    {line.strip()}")

    rec = Record()
    small_index, small_text = phase_kernels(rec, device)
    phase_probes(rec, device)

    kernels.reset_launch_counts()
    main_stats, engine, kmers, seq_arr = phase_main(args.bases, device)
    launches = {k.name: k.launches for k in kernels.KERNELS}
    log(f"[4] launches on the main path: {launches}")
    missing = [name for name in MAIN_PATH_KERNELS if launches[name] <= 0]
    if missing:
        raise AssertionError(f"main path never launched {missing}")
    main_stats["main_shapes"] = phase_main_shapes(rec, engine, kmers)

    phase_roundtrip(small_index, small_text, device)
    bench_stats = phase_bench(rec, engine, kmers, seq_arr, device)
    for name in BENCH_KERNELS:
        launches[name] = bench_stats["launches"][name]
    main_stats["bench"] = {k: bench_stats["meta"][k] for k in BENCH_SUMMARY_KEYS}
    del engine, kmers
    torch.cuda.synchronize()

    log(f"[summary] {json.dumps(main_stats)}")
    log(smi)
    print(json.dumps({"kernels": [
        {
            "name": k.name, "route": "cuda", "source": k.source, "replaces": k.replaces,
            "launches": launches[k.name], "max_abs_err": rec.err[k.name],
            "ms": rec.ms[k.name][0], "plain_ms": rec.ms[k.name][1],
        }
        for k in kernels.KERNELS
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The bench protocol on one card: batched k-mer search throughput.

    python -m avxwindowfmindex_tpu_torch.tools.bench [--device cuda:0] [--bases N]
        [--queries N] [--runs N] [--seed-k K] [--profile DIR] ...

The protocol of the JAX package's ``bench.py``, unchanged: 64M uniformly
random bases from ``default_rng(1234)``, SA ratio 8, the seed k from the
capacity planner (14 at 64M bases), a dense device SA at ratio 4 for one
stage, a Cn-biased n = 2 table, and 4,194,304 25-mers sampled from the
text (every query hits), uploaded once as a letter matrix in 1M chunks
for count and 4M chunks for locate. Stages, each a warm-up and then the
median of ``--runs`` timed runs, every run ending in one host readback
with ``torch.cuda.synchronize()`` inside the timed window:

  count_step               K2 ranges (single steps), count
  digram_count             K4 ranges (n-gram steps), count
  locate_first_hit         K4 + K3 on each range's start
  locate_all               K4 + ``locate_flat_device`` (enumerate + K3)
  locate_all_dense_sa_r4   the same over the ratio-4 device SA
  locate_multihit          512K 11-mers: unseeded K2 + ``locate_flat_device``

Before the stages, the K2 and K4 ranges must agree on every chunk; after
them, 32 counts and 64 multi-hit locates are checked against a host scan
of the text. Then each table's random-row rate is measured in-process
(``utils/roofline.calibrate_gather_rates``: K5's walk over the sectors a
first-block step reads of a row, and K6's slab rate) and every stage is
set against its gather ceiling and, at the bytes a visit reads (192 B of
an n-gram row, 128 B of a pair row or a block row), against the card's
HBM rate; a table the card's L2 holds (the 32 MB of block rows at 64M
bases) is charged the rows a launch's batch touches, not every visit.
On a card each stage then runs 3 s more while the card's DRAM-busy share
is read (``utils/dram.memory_busy``, through pynvml), and its roofline
gets the most DRAM bytes a query can have moved, beside the model's.

Prints one ``{"meta": ...}`` line (the keys of ``bench.py``'s, with the
``nvidia-smi`` name and power limit under ``device``) and then the
headline ``{"metric": "nt25_locate_all_queries_per_sec", ...}``. Its
``vs_baseline`` divides by the same 2.5M q/s cost-model estimate of the
reference CPU library that ``bench.py`` uses (a 64-thread AVX2 server,
not a measurement), and the line says so. Progress goes to stderr.

Runs on ``--device cuda:0`` by default and raises when CUDA is absent;
``--device cpu`` runs every kernel's plain version, at a small size,
for tests. ``--cache DIR`` warm-starts later runs from the index saved
as an ``.awfmx`` artifact and the finished n-gram rows (the build is
the step it skips; the seed table is rebuilt on the card).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from typing import Optional

import numpy as np

BASELINE_LOCATE_QPS = 2.5e6
BASELINE_NOTE = (
    "reference CPU library, 2.5M locate q/s: bench.py's cost-model estimate "
    "for a 64-thread AVX2 server, not a measurement"
)


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


@dataclasses.dataclass
class Protocol:
    """The resolved protocol parameters (``bench.py``'s module constants)."""

    num_bases: int = 64_000_000
    num_queries: int = 4_194_304
    kmer_len: int = 25
    seed_k: int = 14
    runs: int = 5
    multihit_kmer_len: int = 11
    multihit_queries: int = 1 << 19
    device_sa_ratio: int = 4
    ngram_n: int = 2
    chunk_q: int = 1_048_576
    locate_chunk_q: int = 4_194_304
    calib_batch: int = 1 << 20
    profile: Optional[str] = None


def parse_args(argv=None) -> argparse.Namespace:
    d = Protocol()
    ap = argparse.ArgumentParser(description="The bench protocol on one card")
    ap.add_argument("--device", default="cuda:0",
                    help="torch device (default cuda:0; cpu runs the plain versions)")
    ap.add_argument("--bases", type=int, default=d.num_bases)
    ap.add_argument("--queries", type=int, default=d.num_queries)
    ap.add_argument("--kmer-len", type=int, default=d.kmer_len)
    ap.add_argument("--seed-k", type=int, default=0,
                    help="seed-table k (0: the capacity planner's pick)")
    ap.add_argument("--runs", type=int, default=d.runs)
    ap.add_argument("--multihit-kmer-len", type=int, default=0,
                    help="0: scaled to the corpus, about 16 hits per query, at least 11")
    ap.add_argument("--multihit-queries", type=int, default=0,
                    help="0: 512K below 1G bases, 128K above")
    ap.add_argument("--device-sa-ratio", type=int, default=d.device_sa_ratio,
                    help="dense device SA of the dense stage (0: no dense stage)")
    ap.add_argument("--ngram", type=int, default=d.ngram_n)
    ap.add_argument("--chunk-q", type=int, default=d.chunk_q)
    ap.add_argument("--locate-chunk-q", type=int, default=d.locate_chunk_q)
    ap.add_argument("--calib-batch", type=int, default=d.calib_batch,
                    help="lanes of the gather-rate calibration walk")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="write a torch.profiler trace of one locate_all pass to DIR")
    ap.add_argument("--cache", default=None, metavar="DIR",
                    help="warm-start from DIR: the index as an .awfmx artifact and the "
                         "n-gram rows as an .npz, written on the first run (bench.py's "
                         "AWFM_BENCH_CACHE, same file names)")
    return ap.parse_args(argv)


def resolve_device(name: str):
    """The torch device of ``name``; a CUDA device without CUDA raises."""
    import torch

    from ..models.index import as_device

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "torch.cuda.is_available() is False; pass --device cpu explicitly "
            "to run the plain versions"
        )
    return as_device(device)


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi prints them
    (``str(device)`` off the card)."""
    if device.type != "cuda":
        return str(device)
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         f"--id={device.index}"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def default_multihit_kmer_len(num_bases: int) -> int:
    """About 16 expected hits per query (bases / 4^len ~ 16), at least 11."""
    return max(11, math.ceil(math.log(num_bases / 16, 4)))


def resolve_protocol(args, device) -> Protocol:
    from ..utils.capacity import plan_capacity

    seed_k = args.seed_k or plan_capacity(
        args.bases, device=device, batch=args.queries, kmer_len=args.kmer_len
    ).seed_k
    return Protocol(
        num_bases=args.bases, num_queries=args.queries, kmer_len=args.kmer_len,
        seed_k=seed_k, runs=args.runs,
        multihit_kmer_len=args.multihit_kmer_len or default_multihit_kmer_len(args.bases),
        multihit_queries=args.multihit_queries or (
            1 << 17 if args.bases >= 1_000_000_000 else 1 << 19
        ),
        device_sa_ratio=args.device_sa_ratio, ngram_n=args.ngram,
        chunk_q=args.chunk_q, locate_chunk_q=args.locate_chunk_q,
        calib_batch=args.calib_batch, profile=args.profile,
    )


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _count_overlapping(hay: bytes, needle: bytes) -> int:
    """Exact overlapping occurrence count (host oracle for spot checks)."""
    n = 0
    i = hay.find(needle)
    while i != -1:
        n += 1
        i = hay.find(needle, i + 1)
    return n


def run_protocol(p: Protocol, index, seq_arr: np.ndarray, rng, *, dev, dev_dense, ng,
                 device, build_s: Optional[float], digram_build_s: Optional[float],
                 t_start: float):
    """Every stage, the checks and the rooflines on a built index.

    ``dev`` is the device view at the config ratio, ``dev_dense`` the one
    over the dense device SA (None: no dense stage), ``ng`` the n-gram
    table; the build times go into the meta line as given (None when
    the caller did not build). Returns (meta, headline), the two JSON
    lines' objects.
    """
    import torch

    from .. import SearchEngine
    from ..models import alphabet as alpha
    from ..search import (
        locate_first_hit, locate_flat_device, ngram_ranges, range_counts,
        search_ranges, total_hits_host,
    )
    from ..utils import dram, roofline

    cuda = device.type == "cuda"
    chip = roofline.detect_chip(device)
    busy = {}  # stage -> utils.dram.memory_busy's reading

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    def time_stage(name, fn):
        """Warm-up (discarded) + median of ``p.runs`` timed runs."""
        t0 = time.perf_counter()
        fn()
        _log(f"{name} warm-up (discarded): {time.perf_counter() - t0:.4f}s")
        times = []
        for _ in range(p.runs):
            t0 = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t0)
        med = float(np.median(times))
        _log(f"{name}: median {med:.4f}s of {times}")
        if cuda:
            busy[name] = dram.memory_busy(fn, device, chip.hbm_gbps)
            _log(f"{name}: DRAM busy {busy[name]['memory_busy_pct']:.1f}% "
                 f"({busy[name]['samples']} samples)")
        return med, times

    num_bases, kmer_len = p.num_bases, p.kmer_len
    starts = rng.integers(0, num_bases - kmer_len, size=p.num_queries)
    windows = np.lib.stride_tricks.sliding_window_view(seq_arr, kmer_len)
    kmer_mat_ascii = windows[starts]
    mat = alpha.NT_ASCII_TO_INDEX[kmer_mat_ascii]

    chunk_q = min(p.num_queries, p.chunk_q)
    num_queries = (p.num_queries // chunk_q) * chunk_q  # whole chunks
    t0 = time.perf_counter()
    chunks = [torch.from_numpy(mat[lo : lo + chunk_q]).to(device) for lo in range(0, num_queries, chunk_q)]
    sync()
    upload_s = time.perf_counter() - t0
    _log(f"query upload: {upload_s:.4f}s for {num_queries} kmers")
    lchunk_q = min(num_queries, p.locate_chunk_q)
    if num_queries % lchunk_q != 0:
        lchunk_q = chunk_q
    lchunks = chunks if lchunk_q == chunk_q else [
        torch.from_numpy(mat[lo : lo + lchunk_q]).to(device) for lo in range(0, num_queries, lchunk_q)
    ]
    chunk_len = torch.full((chunk_q,), kmer_len, dtype=torch.int32, device=device)
    chunk_seeded = torch.ones(chunk_q, dtype=torch.uint8, device=device)

    # cross-engine parity: the single-step (K2) and n-gram (K4) ranges
    # must agree on every query; one scalar read back per chunk
    mismatches = 0
    for cm in chunks:
        s1, e1 = search_ranges(dev, cm, chunk_len, chunk_seeded)
        s2, e2 = ngram_ranges(dev, ng, cm, kmer_len)
        mismatches += int(((s1 != s2) | (e1 != e2)).sum())
    if mismatches:
        raise AssertionError(f"single-step vs n-gram range mismatch on {mismatches} queries")
    _log("cross-engine parity: single-step == n-gram on all chunks")

    def finish(total):
        int(total)  # the one readback
        sync()

    def run_count():
        total = torch.zeros((), dtype=torch.int64, device=device)
        for cm in chunks:
            s, e = search_ranges(dev, cm, chunk_len, chunk_seeded)
            total = total + range_counts(s, e)[0]
        finish(total)

    med, count_times = time_stage("count_step", run_count)
    count_qps = num_queries / med

    def run_count2():
        total = torch.zeros((), dtype=torch.int64, device=device)
        for cm in chunks:
            s, e = ngram_ranges(dev, ng, cm, kmer_len)
            total = total + range_counts(s, e)[0]
        finish(total)

    med, count2_times = time_stage("digram_count", run_count2)
    count2_qps = num_queries / med

    def run_locate():
        total = torch.zeros((), dtype=torch.int64, device=device)
        for cm in lchunks:
            s, e = ngram_ranges(dev, ng, cm, kmer_len)
            total = total + locate_first_hit(dev, s, e)[0]
        finish(total)

    med, locate_times = time_stage("locate_first_hit", run_locate)
    locate_qps = num_queries / med

    # full hit list: capacity from the true per-chunk totals, rounded
    # coarsely as bench.py does
    chunk_totals = [total_hits_host(*ngram_ranges(dev, ng, cm, kmer_len)) for cm in lchunks]
    total_hits = sum(chunk_totals)
    cap = _round_up(max(chunk_totals), 65536)
    _log(f"total hits {total_hits} over {num_queries} queries; capacity {cap}")

    def locate_all_on(d):
        def run():
            total = torch.zeros((), dtype=torch.int64, device=device)
            for cm in lchunks:
                s, e = ngram_ranges(d, ng, cm, kmer_len)
                hits, _qid, _mask = locate_flat_device(d, s, e, capacity=cap)
                total = total + hits[0]
            finish(total)
        return run

    run_locate_all = locate_all_on(dev)
    med, locate_all_times = time_stage("locate_all", run_locate_all)
    locate_all_qps = num_queries / med
    locate_all_hps = total_hits / med

    dense_qps = dense_times = None
    if dev_dense is not None:
        med, dense_times = time_stage(
            f"locate_all_dense_sa_r{dev_dense.ratio}", locate_all_on(dev_dense)
        )
        dense_qps = num_queries / med

    # multi-hit: short kmers, many hits per query
    mh_len, mh_q = p.multihit_kmer_len, p.multihit_queries
    mh_starts = rng.integers(0, num_bases - mh_len, size=mh_q)
    windows_mh = np.lib.stride_tricks.sliding_window_view(seq_arr, mh_len)
    mh_ascii = windows_mh[mh_starts]
    mh_mat = torch.from_numpy(alpha.NT_ASCII_TO_INDEX[mh_ascii]).to(device)
    mh_lengths = torch.full((mh_q,), mh_len, dtype=torch.int32, device=device)
    mh_seeded_flag = mh_len >= p.seed_k
    mh_seeded = torch.full((mh_q,), int(mh_seeded_flag), dtype=torch.uint8, device=device)
    mh_total = total_hits_host(*search_ranges(dev, mh_mat, mh_lengths, mh_seeded))
    mh_cap = _round_up(mh_total, 65536)
    _log(f"multihit: {mh_total} hits over {mh_q} {mh_len}-mers "
         f"({mh_total / mh_q:.1f} hits/query); capacity {mh_cap}")

    def run_multihit():
        s, e = search_ranges(dev, mh_mat, mh_lengths, mh_seeded)
        hits, _qid, _mask = locate_flat_device(dev, s, e, capacity=mh_cap)
        finish(hits[0])

    med, mh_times = time_stage("locate_multihit", run_multihit)
    mh_qps = mh_q / med
    mh_hps = mh_total / med

    if p.profile:
        profile_locate_all(run_locate_all, p.profile, cuda)

    # exact spot checks against a host scan of the text
    seq_bytes = seq_arr.tobytes()
    engine = SearchEngine(index, device=device)
    sample = rng.integers(0, num_queries, size=32)
    sample_kmers = [kmer_mat_ascii[i].tobytes() for i in sample]
    want = np.array([_count_overlapping(seq_bytes, k) for k in sample_kmers])
    got = engine.count(sample_kmers)
    if not (got == want).all():
        raise AssertionError(f"count mismatch vs host oracle: {got[got != want]} != {want[got != want]}")
    _log("count spot check: 32/32 exact vs host-scan oracle")
    mh_sample = rng.integers(0, mh_q, size=64)
    mh_sample_kmers = [mh_ascii[i].tobytes() for i in mh_sample]
    mh_hits = engine.locate(mh_sample_kmers)
    max_pos = num_bases - mh_len
    for kb, hits_i in zip(mh_sample_kmers, mh_hits):
        if not (hits_i <= max_pos).all():
            raise AssertionError("hit beyond the last valid window")
        pat = np.frombuffer(kb, dtype=np.uint8)
        if not (windows_mh[hits_i.astype(np.int64)] == pat[None, :]).all():
            raise AssertionError(f"locate returned a non-matching position for {kb!r}")
    freq_i = int(np.argmax([len(h) for h in mh_hits]))
    freq_want = _count_overlapping(seq_bytes, mh_sample_kmers[freq_i])
    if len(mh_hits[freq_i]) != freq_want:
        raise AssertionError(f"multi-hit completeness: {len(mh_hits[freq_i])} != {freq_want}")
    _log(f"multihit spot check: 64/64 sound, most-frequent kmer complete ({freq_want} hits)")

    if cuda:
        peak = torch.cuda.max_memory_allocated(device)
        tables = (dev.packed, dev.packed_pair, dev.prefix_sums, dev.seed_table, dev.sampled_sa,
                  dev.code_masks, dev.vec_to_index, ng.packed, ng.k4, ng.cn,
                  None if dev_dense is None else dev_dense.sampled_sa)
        resident = sum(t.numel() * t.element_size() for t in tables if t is not None)
        _log(f"device memory: peak {peak} B, index tables {resident} B, "
             f"workspace peak {peak - resident} B")

    # roofline against the rates measured here, on these tables
    # and at the bytes a visit reads: the calibration walks the sectors of
    # a first-block step, the byte model charges them. The range phase's
    # one-row step ("pair") takes its first-block sectors from the block
    # row, as K2 and K4's tail do in a narrow view (nearly every step at
    # this seed k), so that entry is a block-row visit
    calib_tables = {"single": dev.packed, "pair": dev.packed, "ngram_pair": ng.packed}
    visits = roofline.first_block_visits(ngram_n=p.ngram_n)
    visits["pair"] = visits["single"]
    rates = roofline.calibrate_gather_rates(
        calib_tables, batch=p.calib_batch, device=device, log=_log,
        sector_masks={t: mask for t, (mask, _) in visits.items()},
    )
    rb = {**roofline.table_row_bytes(ngram_n=p.ngram_n), "pair": int(dev.packed.shape[1])}
    # a table the L2 holds is charged the rows a launch's batch touches
    table_rows = {t: int(tab.shape[0]) for t, tab in calib_tables.items() if tab is not None}
    roof_kw = dict(kmer_len=kmer_len, seed_k=p.seed_k, ratio=dev.ratio, rates=rates,
                   row_bytes=rb, visit_bytes={t: b for t, (_, b) in visits.items()},
                   chip=chip, table_rows=table_rows)

    def read_busy(roof, stage, queries):
        # the card's bound beside the model: the most DRAM bytes a query moved
        if stage in busy and roof is not None and busy[stage]["dram_bytes_per_call_at_most"]:
            roof["dram_bytes_per_query_at_most"] = round(
                busy[stage]["dram_bytes_per_call_at_most"] / queries, 1)
            roof["memory_busy_pct"] = round(busy[stage]["memory_busy_pct"], 2)
        return roof

    count_roof = read_busy(roofline.report(count_qps, ngram_n=1, batch_queries=chunk_q,
                                           **roof_kw), "count_step", num_queries)
    count2_roof = read_busy(roofline.report(count2_qps, ngram_n=p.ngram_n, batch_queries=chunk_q,
                                            **roof_kw), "digram_count", num_queries)
    locate_roof = read_busy(roofline.report(locate_qps, ngram_n=p.ngram_n, batch_queries=lchunk_q,
                                            locate_positions_per_query=1.0, **roof_kw),
                            "locate_first_hit", num_queries)
    locate_all_roof = read_busy(roofline.report(locate_all_qps, ngram_n=p.ngram_n,
                                                batch_queries=lchunk_q,
                                                locate_positions_per_query=cap / lchunk_q,
                                                **roof_kw), "locate_all", num_queries)
    dense_roof = None
    if dev_dense is not None:
        dense_roof = read_busy(roofline.report(
            dense_qps, ngram_n=p.ngram_n, batch_queries=lchunk_q,
            locate_positions_per_query=cap / lchunk_q, **{**roof_kw, "ratio": dev_dense.ratio},
        ), f"locate_all_dense_sa_r{dev_dense.ratio}", num_queries)
    # the unseeded multi-hit range phase, (L - 1) single steps of two
    # block rows each, is modelled as seed_k = 1 without pair rows
    multihit_roof = read_busy(roofline.report(
        mh_qps, ngram_n=1, pair_rows=mh_seeded_flag, locate_positions_per_query=mh_cap / mh_q,
        batch_queries=mh_q,
        **{**roof_kw, "kmer_len": mh_len, "seed_k": p.seed_k if mh_seeded_flag else 1},
    ), "locate_multihit", mh_q)
    meta = {
        "device": device_line(device),
        "num_bases": num_bases,
        "num_queries": num_queries,
        "kmer_len": kmer_len,
        "seed_k": p.seed_k,
        "runs": p.runs,
        "build_seconds": build_s,
        "digram_build_seconds": digram_build_s,
        "query_upload_seconds": upload_s,
        "count_qps": round(count_qps),
        "count_times": count_times,
        "count_ngram_qps": round(count2_qps),
        "count_ngram_times": count2_times,
        "ngram_n": p.ngram_n,
        "locate_first_hit_qps": round(locate_qps),
        "locate_first_hit_times": locate_times,
        "locate_all_qps": round(locate_all_qps),
        "locate_all_hits_per_sec": round(locate_all_hps),
        "locate_all_times": locate_all_times,
        "total_hits": total_hits,
        "device_sa_ratio": dev_dense.ratio if dev_dense is not None else None,
        "locate_all_dense_sa_qps": round(dense_qps) if dense_qps else None,
        "locate_all_dense_sa_times": dense_times,
        "multihit_kmer_len": mh_len,
        "multihit_queries": mh_q,
        "multihit_total_hits": mh_total,
        "multihit_hits_per_query": mh_total / mh_q,
        "multihit_qps": round(mh_qps),
        "multihit_hits_per_sec": round(mh_hps),
        "multihit_times": mh_times,
        "total_seconds": time.time() - t_start,
        "gather_rates_rows_per_sec": {t: round(r) for t, r in rates.items()},
        "count_roofline": count_roof,
        "count_ngram_roofline": count2_roof,
        "locate_roofline": locate_roof,
        "locate_all_roofline": locate_all_roof,
        "locate_all_dense_sa_roofline": dense_roof,
        "multihit_roofline": multihit_roof,
    }
    scale_tag = "_hg38" if num_bases >= 3_000_000_000 else ""
    headline = {
        "metric": f"nt{kmer_len}{scale_tag}_locate_all_queries_per_sec",
        "value": round(locate_all_qps),
        "unit": "queries/s",
        "vs_baseline": round(locate_all_qps / BASELINE_LOCATE_QPS, 3),
        "baseline": BASELINE_NOTE,
    }
    return meta, headline


def profile_locate_all(run, out_dir: str, cuda: bool) -> None:
    """A torch.profiler trace of one locate_all pass, written to
    ``out_dir/locate_all_trace.json``; the busiest kernels to the log."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(out_dir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        run()
    path = os.path.join(out_dir, "locate_all_trace.json")
    prof.export_chrome_trace(path)
    key = "cuda_time_total" if cuda else "cpu_time_total"
    _log(f"profiler trace of one locate_all pass -> {path}")
    for line in prof.key_averages().table(sort_by=key, row_limit=12).splitlines():
        _log(f"  {line}")


def main(argv=None) -> int:
    args = parse_args(argv)
    device = resolve_device(args.device)
    import torch

    from .. import IndexConfiguration, AlphabetType, create_index
    from ..ops.ngram import build_ngram_device

    t_start = time.time()
    p = resolve_protocol(args, device)
    rng = np.random.default_rng(1234)
    seq_arr = rng.choice(np.frombuffer(b"acgt", np.uint8), size=p.num_bases)
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=8,
        kmer_length_in_seed_table=p.seed_k,
        alphabet_type=AlphabetType.DNA,
    )
    art_path = ng_cache_path = None
    if args.cache:
        # keyed as bench.py keys them: the artifact on every build input,
        # the n-gram rows on what shapes them (corpus size, n, Cn bias)
        os.makedirs(args.cache, exist_ok=True)
        art_path = os.path.join(
            args.cache,
            f"b{p.num_bases}_k{p.seed_k}_r{cfg.suffix_array_compression_ratio}"
            f"_d{p.device_sa_ratio}.awfmx",
        )
        ng_cache_path = os.path.join(args.cache, f"b{p.num_bases}_ng{p.ngram_n}_pb1.npz")
    cached = bool(art_path) and os.path.exists(art_path)
    t0 = time.perf_counter()
    if cached:
        from ..io.artifact import load_artifact

        index = load_artifact(art_path, device=device)
    else:
        _log(f"building index: {p.num_bases} bases, seed k={p.seed_k}, on {device}")
        index = create_index(
            seq_arr.tobytes(), cfg, device_sa_ratio=p.device_sa_ratio or None, device=device
        )
    dev = index.to_device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    build_s = time.perf_counter() - t0
    _log(f"index loaded from cache in {build_s:.2f}s ({art_path})" if cached
         else f"index built in {build_s:.2f}s")
    if art_path and not cached:
        from ..io.artifact import save_artifact

        t0 = time.perf_counter()
        save_artifact(index, art_path, compress=False)
        _log(f"index cached in {time.perf_counter() - t0:.2f}s ({art_path})")
    dev_dense = None
    if index.device_sa is not None:
        # to_device prefers the dense SA; the protocol's view swaps the
        # config-ratio samples back in
        from ..models.index import u32_tensor

        dev_dense = dev
        dev = dataclasses.replace(
            dev, sampled_sa=u32_tensor(index.sampled_sa, device),
            ratio=int(cfg.suffix_array_compression_ratio),
        )
    t0 = time.perf_counter()
    ng = build_ngram_device(index, p.ngram_n, device=device, cache_path=ng_cache_path)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    digram_build_s = time.perf_counter() - t0
    _log(f"{p.ngram_n}-gram table built in {digram_build_s:.2f}s")
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    meta, headline = run_protocol(
        p, index, seq_arr, rng, dev=dev, dev_dense=dev_dense, ng=ng, device=device,
        build_s=build_s, digram_build_s=digram_build_s, t_start=t_start,
    )
    print(json.dumps({"meta": meta}))
    print(json.dumps(headline), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The index kernels of two or more checkouts, timed in turns on one card.

    python -m avxwindowfmindex_tpu_torch.tools.kernel_ab --other parent=DIR
        [--other NAME=DIR ...] [--bases N] [--queries N] [--reps N]
        [--cases all|bfs|rs]

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

``--cases rs``: the range-sharded step alone, each checkout's on the
same shards and positions: the 64M index split into 2 and 4 shards of
narrow block rows and 2 of compact wide rows, and a compact wide table
tiled to 2^32 + 2^28 positions (4.56 GB, ``straddle_compact_table``) split
into two 2.28 GB shards, beyond the L2. An occ step over 2,097,152 random
positions (a backward step of 1M queries) and an LF step, with the done
rule, over 1,048,576 lanes. A checkout with the route (``k1r_route``)
runs route + one launch a shard over its slice, each value stored at its
lane; one without it runs its every-lane ``k1r_occurrence`` /
``k1r_letter_occ`` on every shard, then this checkout's torch ops: the
sum over the shards and, in LF mode, ``lf_from_letter_occ`` and the done
rule's two ``where``s. All on the current stream. The LF step is in
place in the routed form, so both forms start from copies of the lanes.
Each is timed by the wall clock (``ms``: the host's work included, what
a caller waits) and as device time with the queue kept full
(``device_ms``).

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


def device_ms(fn, reps: int, cycles_per_call: int = 1_000_000) -> float:
    """Mean device milliseconds per call: the card is kept busy by
    ``torch.cuda._sleep`` while the host enqueues the calls, so no host
    time lies between two of them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(reps * cycles_per_call)
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


def run_case(case: str, shape: str, call, libs: dict, reps: int, device: bool = False) -> None:
    """``call(kernels_module)`` through every checkout: equal results, then
    times in turns (``device``: the device time of a primed queue too,
    ``"device_ms"``, beside the wall time ``"ms"``)."""
    names = list(libs)
    want = call(libs[names[0]])
    for name in names[1:]:
        if not _same(call(libs[name]), want):
            raise AssertionError(f"{case}: {name} differs from {names[0]}")
    ms = {name: [] for name in names}
    dev_ms = {name: [] for name in names}
    for name in names + names[::-1]:
        ms[name].append(cuda_ms(lambda: call(libs[name]), reps))
        if device:
            dev_ms[name].append(device_ms(lambda: call(libs[name]), reps))
    line = {"case": case, "shape": shape, "ms": ms}
    if device:
        line["device_ms"] = dev_ms
    print(json.dumps(line), flush=True)


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


def straddle_compact_table(device, boundary: int = 2**32, seed: int = 4097,
                           pat_blocks: int = 4096) -> dict:
    """A compact wide-row DNA table (``pack_device_blocks64(pair=False)``,
    256 B rows) of ``boundary + boundary / 16`` positions, 4.56 GB at
    2^32: a random pattern of ``pat_blocks`` blocks tiled on the card, its
    u64 milestones shifted so that they start 2^28 below 2^32 and pass it.
    Returns ``table`` ((nb, 256) uint8 on ``device``), ``n`` (positions),
    ``nb``, ``rng`` (for more draws), and what the closed form
    ``closed_form_occ`` needs."""
    import torch
    from .. import AlphabetType
    from ..models import index as index_mod

    rng = np.random.default_rng(seed)
    card, n_planes = 4, 3
    pattern = rng.choice(np.arange(5, dtype=np.uint8), size=(pat_blocks, 256),
                         p=[0.24, 0.24, 0.24, 0.24, 0.04])
    reps = boundary // (pat_blocks * 256) + boundary // (16 * pat_blocks * 256)
    nb = pat_blocks * reps
    counts = np.stack([(pattern == j).sum(axis=1) for j in range(card + 2)],
                      axis=1).astype(np.uint64)
    pat_total = counts.sum(axis=0)
    cum = np.cumsum(counts, axis=0)
    pat_ms = np.zeros_like(cum)
    pat_ms[1:] = cum[:-1]
    offset = 2**32 - (boundary >> 4)  # milestones from below 2^32 to past it
    rows = index_mod.pack_device_blocks64(pattern.reshape(-1), pat_ms, AlphabetType.DNA,
                                          pair=False)
    table = torch.from_numpy(rows).to(device).repeat(reps, 1)
    t64 = table.view(torch.int64)
    tile = torch.arange(nb, dtype=torch.int64, device=device) // pat_blocks
    total_d = torch.from_numpy(pat_total[: card + 1].astype(np.int64)).to(device)
    ms_d = torch.from_numpy(pat_ms[:, : card + 1].astype(np.int64)).to(device)
    col = n_planes * 32 // 8
    t64[:, col : col + card + 1] = ms_d.repeat(reps, 1) + tile[:, None] * total_d[None, :] + offset
    del tile, t64
    flat = pattern.reshape(-1)
    pat_cum = np.stack([np.concatenate([[0], np.cumsum(flat == l)]) for l in range(card + 1)])
    return {"table": table, "n": nb * 256, "nb": nb, "rng": rng, "offset": offset,
            "pat_cum": pat_cum, "pat_len": len(flat), "ms_max": offset + int(pat_total.max()) * reps}


def closed_form_occ(info: dict, pos: np.ndarray, lett: np.ndarray) -> np.ndarray:
    """occ(lett, pos) of ``straddle_compact_table``'s text, from its pattern."""
    full, rem = np.divmod(pos + 1, info["pat_len"])
    return info["offset"] + full * info["pat_cum"][lett, -1] + info["pat_cum"][lett, rem]


def straddle_shard(part, n: int, device):
    """A range-sharded shard view over ``part``, rows of the straddle table
    (its C[] all 0)."""
    import torch
    from .. import AlphabetType, DeviceIndex
    from ..models import alphabet as alpha
    from ..models import index as index_mod

    z = torch.zeros(6, dtype=torch.int64, device=device)
    return DeviceIndex(
        packed=part, packed_pair=None, prefix_sums=z, seed_table=z[:2].view(1, 2),
        sampled_sa=None,
        code_masks=torch.from_numpy(index_mod.device_code_masks(AlphabetType.DNA)).to(device),
        vec_to_index=torch.from_numpy(
            alpha.vector_to_index_lut(AlphabetType.DNA).astype(np.int32)).to(device),
        bwt_length=n, ratio=8, kmer_length_in_seed_table=1, alphabet=AlphabetType.DNA,
        wide=True, pair_fused=False,
    )


def rs_occ_step(km, shards, first_blocks, bps: int, wide: bool, pos, lett):
    """One occ step of a range-sharded engine through the kernels of the
    checkout whose ``ops.kernels`` is ``km`` (module note)."""
    import torch

    n = len(shards)
    if hasattr(km, "k1r_route"):
        out = torch.empty_like(pos)
        counts = torch.empty(n + 1, dtype=torch.int32, device=pos.device)
        slot_pos, slot_lane = km.k1r_route(pos, out, n, bps, wide, 0, counts)
        for i, (shard, fb) in enumerate(zip(shards, first_blocks)):
            km.k1r_occurrence(shard, fb, slot_pos, slot_lane, counts, i, lett, out)
        return out
    total = None
    for shard, fb in zip(shards, first_blocks):
        got = km.k1r_occurrence(shard, pos, lett, fb)
        total = got if total is None else total + got
    return total


def rs_lf_step(km, shards, first_blocks, bps: int, wide: bool, p, off, unowned: int):
    """One LF step of the backtrace, with the done rule, through ``km``'s
    kernels (module note): the new (p, off)."""
    import torch
    from ..ops import rank

    n, ratio = len(shards), shards[0].ratio
    if hasattr(km, "k1r_route"):
        p, off = p.clone(), off.clone()
        counts = torch.empty(n + 1, dtype=torch.int32, device=p.device)
        slot_pos, slot_lane = km.k1r_route(p, p, n, bps, wide, unowned, counts, ratio, off)
        for i, (shard, fb) in enumerate(zip(shards, first_blocks)):
            km.k1r_lf(shard, fb, slot_pos, slot_lane, counts, i, p)
        return p, off
    lett = occ = None
    for shard, fb in zip(shards, first_blocks):
        got_l, got_o = km.k1r_letter_occ(shard, p, fb)
        lett = got_l.to(torch.int64) if lett is None else lett + got_l.to(torch.int64)
        occ = got_o if occ is None else occ + got_o
    lf = rank.lf_from_letter_occ(shards[0], lett, occ)
    done = p % ratio == 0
    return torch.where(done, p, lf), torch.where(done, off, off + 1)


def rs_cases(index, libs: dict, reps: int, device) -> None:
    """The range-sharded step through every checkout (module note)."""
    import torch
    from ..ops import rank
    from ..parallel.range_sharded import RangeShardedSearchEngine

    rng = np.random.default_rng(10)
    setups = []
    for n, wide in ((2, False), (4, False), (2, True)):
        eng = RangeShardedSearchEngine(index, [device] * n, wide=wide)
        setups.append((f"rs{'w' if wide else ''} n={n} at {index.bwt_length} positions",
                       eng.shards, eng.first_blocks, eng.blocks_per_shard, wide,
                       index.bwt_length, eng.lf_unowned))
    info = straddle_compact_table(device)
    half = info["nb"] // 2
    shards = [straddle_shard(info["table"][i * half : (i + 1) * half], info["n"], device)
              for i in range(2)]
    zero = torch.zeros(1, dtype=torch.int64, device=device)
    setups.append((f"rsw n=2 at {info['n']} positions (2 x {half * 256 / 1e9:.2f} GB shards)",
                   shards, [0, half], half, True, info["n"],
                   int(rank.lf_from_letter_occ(shards[0], zero, zero)[0])))
    for tag, shards, fbs, bps, wide, n_pos, unowned in setups:
        pos = torch.from_numpy(rng.integers(0, n_pos, 1 << 21)).to(device)
        lett = torch.from_numpy(rng.integers(0, 5, 1 << 21).astype(np.int32)).to(device)
        run_case(f"{tag}: occ step", f"{pos.numel()} positions",
                 lambda km: rs_occ_step(km, shards, fbs, bps, wide, pos, lett), libs, reps,
                 device=True)
        p = pos[: 1 << 20].contiguous()
        off = torch.from_numpy(rng.integers(0, 8, p.numel())).to(device)
        run_case(f"{tag}: LF step", f"{p.numel()} lanes, ratio {shards[0].ratio}",
                 lambda km: rs_lf_step(km, shards, fbs, bps, wide, p, off, unowned), libs, reps,
                 device=True)
    del setups, shards, info
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
    ap.add_argument("--cases", choices=("all", "bfs", "rs"), default="all")
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
    if args.cases == "rs":
        rs_cases(index, libs, args.reps, device)
        return 0
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

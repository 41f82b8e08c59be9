"""The index kernels of two or more checkouts, timed in turns on one card.

    python -m avxwindowfmindex_tpu_torch.tools.kernel_ab --other parent=DIR
        [--other NAME=DIR ...] [--bases N] [--queries N] [--reps N]
        [--cases all|bfs|rs|k3w|k5|pairless|k1|k4rows|enumerate] [--cache DIR]
        [--bfs-max-parents N ...]

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
depth through the checkout's ``extend_level``, and the same over the
wide view at k = 13; at each depth, the K1 launches of the
per-letter route are also timed alone, apart from the torch work around
them (``"k1_launches_ms"``); then the amino k = 5 and k = 6 tables over
the compact rows of a ``K1_AMINO_RESIDUES``-residue index (chip_smoke.py
phase 4p's), the whole table through each checkout's
``build_seed_table``. ``--bfs-max-parents N ...`` adds to every whole
table this checkout split at each N (``split_seed_table`` at the
``seed_table.bfs_depths`` of N: the depths whose parents number at most
N in one launch of the BFS mode, ``kernels.k1_seed_table``, then one
``k1_extend`` launch a depth; 0 one launch a depth from the depth-1
ranges), timed in the same turns: how the thresholds of
``seed_table.BFS_MAX_PARENTS`` are set.

``--cases rs``: the range-sharded step alone, each checkout's on the
same shards and positions: the 64M index split into 2 and 4 shards of
narrow block rows and 2 of compact wide rows, and a compact wide table
tiled to 2^32 + 2^28 positions (4.56 GB, ``straddle_table``) split
into two 2.28 GB shards, beyond the L2. An occ step over 2,097,152 random
positions (a backward step of 1M queries) and an LF step, with the done
rule, over 1,048,576 lanes. Each checkout runs its route
(``k1r_route``) and one launch a shard over its slice, each value stored
at its lane, all on the current stream. The LF step is in place, so it
starts from copies of the lanes.
Each is timed by the wall clock (``ms``: the host's work included, what
a caller waits) and as device time with the queue kept full
(``device_ms``).

``--cases k3w``: the wide backtrace (K3w) alone, in both outputs (hits
resolved through the sampled SA, and the on-disk form's (position,
offset) pairs), over three wide tables: the 64M index forced wide (the
hits of the ``--queries`` sampled 25-mers, as phase 4w walks them, and
as many random positions), an amino index of ``AMINO_RESIDUES`` random
residues forced wide (512 B rows, 128 MB), and the wide view of a DNA
text of ``BIG_BASES`` = 2^28 random bases (1,048,576 rows x 256 B =
268 MB, five times the L2). The last is built once by the host
SA-IS and cached as an ``.awfmx`` under ``--cache`` (default
``avxwindowfmindex_tpu_torch/build/kernel_ab/``, ignored by git), so a
second run in the same checkout loads it; then phase 4x's table above
2^32 (pair-fused rows tiled to 2^32 + 2^28 positions, 4.56 GB, no
sampled SA: the on-disk form only), from ``--queries`` random starts
whose walks end within 16 steps (``short_walks``). Each case also prints its
models (``"model"``): the LF steps the hits walk, the bound (distinct
rows x the bytes a visit needs, plus inputs and outputs, over 3.35 TB/s)
and the piece model (steps x the 64 B pieces a visit touches: the
first-block sector of each plane and the milestone's, over 3.35 TB/s).
On every table but the 64M random positions, this checkout's K3w is also
timed against its kernel over the same text in compact rows
(``compact_view``: planes 32 B apart), the layout's ceiling.

``--cases pairless``: the forms for a view without pair rows, every
checkout on the same views and inputs, in turns in one process. First
each checkout's registers and spills of K4, K2w over compact rows, narrow
K2 (over block rows and over pair rows, each also in its counting
instantiation) and K3w over compact rows, from its build's ``-Xptxas -v``
report (``"registers"`` lines). Then, on the ``--queries`` sampled
25-mers: K2 over the view without pair rows (``to_device(pair_rows=False)``:
block rows only) and over the pair rows, and K3 on their hits, every
checkout; the calibration of K5's masked walk
(``utils/roofline.calibrate_gather_rates`` with ``first_block_visits``'
sector masks) over the 32 MB block rows, the 64 MB pair rows and the n = 2
and n = 3 n-gram rows (96 MB and 192 MB, beyond the 50 MB L2), and over
the block rows again with ``CEILING_LANES`` lanes a chain (each lane a
share of a row's pieces: the block rows' ceiling, which K2 over them does
not beat); K2 over block rows' model; K4 at n = 2 and 3 with its tail over
block rows and over pair rows, every checkout. Then an amino index of
``K1_AMINO_RESIDUES`` residues (phase 4p's, 262,145 compact rows of
384 B): K2w (12-mers) over its compact rows and over its pair-fused rows,
and K3w on random positions over the compact rows (resolved and on-disk)
and the pair-fused rows, every checkout; the walk over the compact rows.
After K2 over block rows and each K4 and K2w compact case, its model
(``": model"`` lines): the row visits its steps make, by window class
from the plain version's counts, at the calibrated rate of each table,
plus a launch that makes the seed-table visit and the stores and no step
(K2 over the same view on the queries' last k letters), each checkout's
better time over it, the bytes bound (distinct rows x the bytes a visit
needs, plus inputs and outputs, over 3.35 TB/s) and, for K2 over block
rows, the same against the ceiling, for K2w the piece model (visits x
3.8 pieces of 64 B over 3.35 TB/s). K3w compact's model charges its LF
steps at the compact rows' rate plus a launch whose walks take no step,
and gives the lane-occupancy ratio of its one lane a hit
(``lane_occupancy``: mean steps over the steps of the walk a lane's warp
waits on, 1 when every lane walks all the time).

``--cases k5``: K5's reduce alone at phase 3b's shapes (``gather_probe``'s
P2 and P3 configurations: 2^19 random rows of 128 B and 512 B rows summed
whole, of 1 KB rows their first 128 B), over a 1 GiB table (device
memory) and a 64 MiB one (mostly the L2).

``--cases k4rows``: K5's masked walk alone (no index, no other
checkout), the ceiling of K4's n-gram row layouts: a random table of
``CHR1_NGRAM_ROWS`` rows (the n-gram rows of a 248,956,422-base index,
beyond the L2) of 384 B (n = 2) and 768 B (n = 3), walked by
``--queries`` lanes with the pair layout's first-block mask (the first
32 B of each 64 B plane and the milestones' sector) and with each mask
of K4's layout (``roofline.k4_word_masks``: the planes' first 32 B back
to back and the word's milestone sector), twice in turn. One line a
table and round: visits a second by mask, K4's by the words' shares
(the harmonic mix), 64 B pieces a visit, pieces' TB/s, and K4's rate
over the pair layout's.

``--cases k1``: K1, parent against change in turns in one process. Its
occ mode at 8,388,608 random pairs over the 64M index (narrow, forced
wide) and a 2^26-residue amino index on compact wide rows (phase 4p's),
and its LF mode at 1,048,576 positions; then the single-query
API a call: 16 sampled 25-mers walked letter by letter by
``iterative_step_backward_search`` (384 steps) and 64
``backtrace_return_previous_letter_index`` calls through each checkout's
own ``search`` module, on the narrow view with and without pair rows, the
forced-wide view and the compact amino view (16 12-mers): the median host
us of a call in turns, the floor of a call beside each turn (an empty
launch and a 16 B readback, ``kernels.empty_call``), equal answers; then
one ``torch.profiler`` run a checkout gives the device us, launches and
copies a call (``"device"``; traces under ``--cache``/traces).

``--cases enumerate``: K7 (``search.enumerate_flat`` on the card) against
the torch chain it replaced (``search.enumerate_flat_plain`` on the same
CUDA tensors) and each other checkout's ``search.enumerate_flat`` (no
index), at the benchmark's locate shapes (``ENUMERATE_SHAPES``): locate11's 524,288
ranges of 1 + Poisson(59.4) hits (~31.7M slots) and locate25's
4,194,304 ranges of one hit, at random u32 starts, the capacity the
total rounded up to 2^16 as the benchmark rounds it. Equal outputs
first, then ``ENUMERATE_ROUNDS`` rounds in turns (the order reversed
every other round), each form by CUDA events over ``--reps`` calls
back to back (``ms``) and with the queue kept full (``device_ms``);
one line a shape with the best of each, every round, K7's launches a
call, its two kernels' device time from a ``torch.profiler`` run of
``--reps`` calls, and its bound: 13 B written a slot and 16 B read a
range, once, over 3.35 TB/s.

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
import math
import os
import re
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np

CASES = ("all", "bfs", "rs", "k3w", "k5", "pairless", "k1", "k4rows", "enumerate")
BIG_BASES = 1 << 28  # k3w: the DNA text whose wide view outgrows the L2
AMINO_RESIDUES = 64_000_000  # k3w: the amino index forced wide (about a minute to build)
K1_AMINO_RESIDUES = 1 << 26  # k1: chip_smoke.py phase 4p's compact amino index
COMPACT_BFS_K = (5, 6)  # bfs: the amino seed k of phase 4p and of an index of 2^32 positions
CEILING_LANES = 4  # pairless: lanes a chain of the block rows' ceiling walk
CHR1_NGRAM_ROWS = 972_487  # k4rows: the n-gram rows of a 248,956,422-base index
# enumerate: (ranges, mean hits a range beyond its first) of the locate cells
ENUMERATE_SHAPES = {"locate11": (524_288, 59.4), "locate25": (4_194_304, 0.0)}
ENUMERATE_ROUNDS = 7
CAPACITY_GRAIN = 1 << 16  # the benchmark's capacity: the total rounded up to this
HBM_BYTES_PER_S = 3.35e12  # published, H100 SXM
OPS_PER_S = 67e12  # published float32 rate outside the tensor cores
DEFAULT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build", "kernel_ab")


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


def run_case(case: str, shape: str, call, libs: dict, reps: int, device: bool = False,
             variants=None) -> dict:
    """``call(kernels_module)`` through every checkout, and each of
    ``variants`` ({name: fn}, a setting of this checkout, timed as one
    more column): equal results, then times in turns (``device``: the
    device time of a primed queue too, ``"device_ms"``, beside the wall
    time ``"ms"``); returns the times, ``{name: [first, second]}``."""
    fns = {name: (lambda lib=lib: call(lib)) for name, lib in libs.items()}
    fns.update(variants or {})
    names = list(fns)
    want = fns[names[0]]()
    for name in names[1:]:
        if not _same(fns[name](), want):
            raise AssertionError(f"{case}: {name} differs from {names[0]}")
    ms = {name: [] for name in names}
    dev_ms = {name: [] for name in names}
    for name in names + names[::-1]:
        ms[name].append(cuda_ms(fns[name], reps))
        if device:
            dev_ms[name].append(device_ms(fns[name], reps))
    line = {"case": case, "shape": shape, "ms": ms}
    if device:
        line["device_ms"] = dev_ms
    print(json.dumps(line), flush=True)
    return ms


def _sibling(kernels_module, name: str):
    """The module ``ops.<name>`` of the checkout whose ``ops.kernels`` is
    ``kernels_module``."""
    return importlib.import_module(kernels_module.__name__.rsplit(".", 1)[0] + "." + name)


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


def split_seed_table(dev, k: int, steps: int, prefix_sums):
    """The k-mer seed table of ``dev`` with depths 1 .. ``steps`` in one
    launch of the BFS mode (``kernels.k1_seed_table``) and one
    ``extend_level`` (a ``k1_extend`` launch) a depth past them; steps = 0
    is one launch a depth from the depth-1 ranges. On a CPU view the plain
    loop throughout."""
    from ..ops import kernels, rank, seed_table

    if rank.device_kind(dev.packed) == "cuda":
        table = kernels.k1_seed_table(dev, steps + 1)
    else:
        table = seed_table.build_seed_table(dev, dev.cardinality, steps + 1, prefix_sums)
    for _depth in range(steps + 1, k):
        table = seed_table.extend_level(dev, table)
    return table


def bfs_cases(index, views, libs: dict, reps: int, max_parents=(), depths: bool = True) -> None:
    """The seed-table BFS of ``index`` through every checkout: ``views``
    maps a case tag to (device view, k). Each whole table also through
    this checkout split at each threshold of ``max_parents``
    (``"this, max_parents=N"``: ``split_seed_table`` at the depths N
    takes, 0 one launch a depth); with ``depths``, then each depth alone."""
    import torch
    from ..ops import seed_table

    ps = index.prefix_sums
    for tag, (dev, k) in views.items():
        card = dev.cardinality
        variants = {
            f"this, max_parents={m}":
                (lambda s=seed_table.bfs_depths(card, k, m): split_seed_table(dev, k, s, ps))
            for m in max_parents}
        run_case(f"bfs{tag} k={k}", f"{card}^{k} ranges",
                 lambda km: _sibling(km, "seed_table").build_seed_table(dev, card, k, ps),
                 libs, max(1, reps // 5), variants=variants)
        torch.cuda.empty_cache()
        if not depths:
            continue
        table = seed_table.build_seed_table(dev, card, 1, ps)
        for depth in range(1, k):
            parents = table
            run_case(f"bfs{tag} depth {depth}", f"{parents.shape[0]} parents",
                     lambda km: _sibling(km, "seed_table").extend_level(dev, parents), libs, reps)
            ms, launches = k1_launch_ms(dev, parents)
            print(json.dumps({"case": f"bfs{tag} depth {depth}", "k1_launches_ms": ms,
                              "k1_launches": launches}), flush=True)
            table = seed_table.extend_level(dev, parents)
        del table, parents
        torch.cuda.empty_cache()


def compact_bfs_cases(libs: dict, reps: int, max_parents, rng, device, ks=COMPACT_BFS_K) -> None:
    """The amino BFS at each k of ``ks`` (k = 5 and 6) over the compact wide
    rows of a ``K1_AMINO_RESIDUES``-residue index (chip_smoke.py phase 4p's,
    ``to_device(wide=True, pair_rows=False)``), through every checkout's
    ``build_seed_table`` and this checkout split at each threshold of
    ``max_parents``, in turns; the whole tables only (``bfs_cases``
    without depths)."""
    from .. import AlphabetType, IndexConfiguration, create_index

    aa = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8), size=K1_AMINO_RESIDUES)
    aa_index = create_index(aa.tobytes(), IndexConfiguration(8, 5, AlphabetType.AMINO),
                            sa_backend="native", device=device)
    view = aa_index.to_device(device, wide=True, pair_rows=False)
    _log(f"amino index of {K1_AMINO_RESIDUES} residues on {view.packed.shape[1]} B compact rows")
    for k in ks:
        # a k = 5 table takes tens of microseconds: 5x the launches of a case
        bfs_cases(aa_index, {" amino compact": (view, k)}, libs, reps * (5 if k < 6 else 1),
                  max_parents, depths=False)


def straddle_table(device, boundary: int = 2**32, seed: int = 4097, pat_blocks: int = 4096,
                   pair: bool = False, offset=None) -> dict:
    """A wide-row DNA table of ``boundary + boundary / 16`` positions,
    4.56 GB at 2^32: a random pattern of ``pat_blocks`` blocks tiled on
    the card. ``pair``: the pair-fused rows of a single-device wide view
    (each tile's last block paired with the next tile's first, the table's
    last row with none); else the compact rows a range-sharded engine
    shards (``pack_device_blocks64(pair=False)``). The u64 milestones are
    shifted by ``offset``; by default compact ones start 2^28 below 2^32
    and pass it. Returns ``table`` ((nb, 256) uint8 on ``device``), ``n``
    (positions), ``nb``, ``rng`` (for more draws), ``reps`` (tiles),
    ``pat_total`` (letter counts of a tile), and what the closed form
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
    if offset is None:
        offset = 0 if pair else 2**32 - (boundary >> 4)  # from below 2^32 to past it
    if pair:
        # rows of one tile: the partner of its last block is the next tile's first
        letters = np.concatenate([pattern, pattern[:1]]).reshape(-1)
        rows = index_mod.pack_device_blocks64(
            letters, np.concatenate([pat_ms, np.zeros((1, card + 2), np.uint64)]),
            AlphabetType.DNA)[:pat_blocks]
    else:
        rows = index_mod.pack_device_blocks64(pattern.reshape(-1), pat_ms, AlphabetType.DNA,
                                              pair=False)
    table = torch.from_numpy(rows).to(device).repeat(reps, 1)
    stride = 64 if pair else 32
    if pair:
        for i in range(n_planes):  # the table's last row has no partner
            table[-1, i * 64 + 32 : (i + 1) * 64] = 0
    t64 = table.view(torch.int64)
    tile = torch.arange(nb, dtype=torch.int64, device=device) // pat_blocks
    total_d = torch.from_numpy(pat_total[: card + 1].astype(np.int64)).to(device)
    ms_d = torch.from_numpy(pat_ms[:, : card + 1].astype(np.int64)).to(device)
    col = n_planes * stride // 8
    t64[:, col : col + card + 1] = ms_d.repeat(reps, 1) + tile[:, None] * total_d[None, :] + offset
    del tile, t64
    flat = pattern.reshape(-1)
    pat_cum = np.stack([np.concatenate([[0], np.cumsum(flat == l)]) for l in range(card + 1)])
    return {"table": table, "n": nb * 256, "nb": nb, "rng": rng, "offset": offset,
            "reps": reps, "pat_total": pat_total, "pat_cum": pat_cum, "pat_len": len(flat),
            "ms_max": offset + int(pat_total.max()) * reps}


def straddle_view(info: dict, device):
    """The single-device wide view over ``straddle_table(pair=True)``'s
    table: the tiled text's C[], SA ratio 8, no sampled SA (K3w's on-disk
    form)."""
    import torch
    from .. import AlphabetType, DeviceIndex
    from ..models import alphabet as alpha
    from ..models import index as index_mod

    card = 4
    ps = np.concatenate([[1], 1 + np.cumsum(info["pat_total"][: card + 1] * np.uint64(info["reps"]))])
    return DeviceIndex(
        packed=info["table"], packed_pair=info["table"],
        prefix_sums=index_mod.u64_tensor(ps.astype(np.uint64), device),
        seed_table=torch.zeros((1, 2), dtype=torch.int64, device=device), sampled_sa=None,
        code_masks=torch.from_numpy(index_mod.device_code_masks(AlphabetType.DNA)).to(device),
        vec_to_index=torch.from_numpy(
            alpha.vector_to_index_lut(AlphabetType.DNA).astype(np.int32)).to(device),
        bwt_length=info["n"], ratio=8, kmer_length_in_seed_table=1, alphabet=AlphabetType.DNA,
        wide=True,
    )


def short_walks(dev, pos, steps: int = 16):
    """The positions of ``pos`` whose LF walk reaches a sampled position
    within ``steps`` steps, by the plain LF on ``pos``'s device: a tiled
    table's LF can cycle without reaching one."""
    import torch
    from ..ops import rank

    p = pos.clone()
    done = p % dev.ratio == 0
    for _ in range(steps):
        _, lf = rank.letter_and_lf_plain(dev, p)
        p = torch.where(done, p, lf)
        done |= p % dev.ratio == 0
    return pos[done]


def closed_form_occ(info: dict, pos: np.ndarray, lett: np.ndarray) -> np.ndarray:
    """occ(lett, pos) of ``straddle_table``'s text, from its pattern."""
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
        wide=True, pair_fused=False, shard=True,
    )


def rs_occ_step(km, shards, first_blocks, bps: int, wide: bool, pos, lett):
    """One occ step of a range-sharded engine through the kernels of the
    checkout whose ``ops.kernels`` is ``km`` (module note)."""
    import torch

    n = len(shards)
    out = torch.empty_like(pos)
    counts = torch.empty(n + 1, dtype=torch.int32, device=pos.device)
    slot_pos, slot_lane = km.k1r_route(pos, out, n, bps, wide, 0, counts)
    for i, (shard, fb) in enumerate(zip(shards, first_blocks)):
        km.k1r_occurrence(shard, fb, slot_pos, slot_lane, counts, i, lett, out)
    return out


def rs_lf_step(km, shards, first_blocks, bps: int, wide: bool, p, off, unowned: int):
    """One LF step of the backtrace, with the done rule, through ``km``'s
    kernels (module note): the new (p, off)."""
    import torch

    n, ratio = len(shards), shards[0].ratio
    p, off = p.clone(), off.clone()
    counts = torch.empty(n + 1, dtype=torch.int32, device=p.device)
    slot_pos, slot_lane = km.k1r_route(p, p, n, bps, wide, unowned, counts, ratio, off)
    for i, (shard, fb) in enumerate(zip(shards, first_blocks)):
        km.k1r_lf(shard, fb, slot_pos, slot_lane, counts, i, p)
    return p, off


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
    info = straddle_table(device)
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


def k3w_model(view, positions) -> dict:
    """The LF steps K3w walks from ``positions`` over the wide ``view``,
    its bound and its piece model (module note)."""
    import dataclasses as dc

    from .. import search

    _, off = search.backtrace_resolve(dc.replace(view, sampled_sa=None), positions)
    steps, hits = int(off.sum()), positions.numel()
    nb, n_planes = view.packed.shape[0], view.n_planes
    need = n_planes * 32 + view.milestone_bytes  # a visit: each plane's first sector, milestones
    ops = steps * (8 * (2 * n_planes + 1) + 4 * 8)  # a match and a count over 8 words
    pieces = n_planes + 1  # each plane's first-block sector and the milestone lie in 64 B pieces of their own
    return {"hits": hits, "lf_steps": steps, "table_bytes": nb * view.packed.shape[1],
            "bound_ms": max(bytes_bound_ms([(nb, need, steps)], hits * (8 + 8 + 8)),
                            ops / OPS_PER_S * 1e3),
            "pieces_per_visit": pieces,
            "piece_model_ms": steps * pieces * 64 / HBM_BYTES_PER_S * 1e3}


def compact_view(index, view):
    """``view`` over the compact wide rows of ``index`` (planes 32 B apart,
    ``pack_device_blocks64(pair=False)``) in place of its pair-fused ones."""
    import dataclasses as dc

    import torch

    from ..models.index import pack_device_blocks64

    rows = pack_device_blocks64(index.bwt_letters, index.milestones(), index.alphabet, pair=False)
    return dc.replace(view, packed=torch.from_numpy(rows).to(view.packed.device),
                      packed_pair=None, pair_fused=False)


def compact_pieces(n_planes: int, card: int) -> float:
    """64 B pieces a visit to a compact row touches: its planes' pieces and
    the milestone's, which shares the last plane piece for some letters
    (letters taken as equally likely)."""
    plane_pieces = -(-n_planes * 32 // 64)
    shared = sum(n_planes * 32 + 8 * l < plane_pieces * 64 for l in range(card)) / card
    return plane_pieces + 1 - shared


def k3w_runs(tag: str, view, positions, libs: dict, reps: int, compact=None) -> None:
    """K3w through every checkout on ``positions``: both outputs, then the
    models of the walk; with ``compact`` (``compact_view``), also this
    checkout's K3w against its kernel over the compact rows, in turns."""
    import dataclasses as dc

    from ..ops import kernels

    disk = dc.replace(view, sampled_sa=None)
    shape = f"{positions.numel()} hits, ratio {view.ratio}, {view.packed.shape[1]} B rows"
    if view.sampled_sa is not None:
        run_case(f"k3w {tag}", shape, lambda k: k.k3_backtrace_resolve(view, positions), libs, reps)
    run_case(f"k3w {tag}, on-disk form", shape,
             lambda k: k.k3_backtrace_resolve(disk, positions), libs, reps)
    model = k3w_model(view, positions)
    if compact is not None:
        run_case(f"k3w {tag}, pair-fused rows against compact rows", shape,
                 lambda fv: fv[0](fv[1], positions),
                 {"pair-fused": (kernels.k3_backtrace_resolve, view),
                  "compact": (kernels.k3_backtrace_resolve, compact)}, reps)
        pieces = compact_pieces(view.n_planes, view.cardinality)
        model.update(compact_pieces_per_visit=pieces,
                     compact_piece_model_ms=model["lf_steps"] * pieces * 64 / HBM_BYTES_PER_S * 1e3)
    print(json.dumps({"case": f"k3w {tag}", "model": model}), flush=True)


def big_wide_index(bases: int, cache: str, device):
    """The DNA index of ``bases`` random bases (``default_rng(bases)``, as
    the main text is drawn), seed k = 12, SA ratio 8: loaded from
    ``cache`` when a run has saved it there, else built by the host SA-IS
    and saved."""
    import time

    from .. import AlphabetType, IndexConfiguration, create_index
    from ..io.artifact import load_artifact, save_artifact

    path = os.path.join(cache, f"dna_b{bases}_k12_r8.awfmx")
    t0 = time.perf_counter()
    if os.path.exists(path):
        index = load_artifact(path, device=device)
        _log(f"{bases}-base index loaded from {path} in {time.perf_counter() - t0:.1f}s")
        return index
    rng = np.random.default_rng(bases)
    text = rng.choice(np.frombuffer(b"acgt", np.uint8), size=bases).tobytes()
    index = create_index(text, IndexConfiguration(8, 12, AlphabetType.DNA), sa_backend="native",
                         device=device)
    _log(f"{bases}-base index built in {time.perf_counter() - t0:.1f}s")
    os.makedirs(cache, exist_ok=True)
    save_artifact(index, path, compress=False)
    return index


def k3w_cases(index, seq_arr, args, libs: dict, device) -> None:
    """K3w through every checkout (module note): the index of ``seq_arr``
    forced wide, an amino index forced wide, the wide view beyond the L2,
    and phase 4x's table above 2^32."""
    import dataclasses as dc

    import torch

    from .. import AlphabetType, IndexConfiguration, SearchEngine, create_index, search

    rng = np.random.default_rng(11)
    reps = args.reps
    wide = index.to_device(device, wide=True)
    eng = SearchEngine(index, device=device)
    rows = _sampled(rng, seq_arr, 25, args.queries)
    mat, lengths, _ = eng.encode_kmers([r.tobytes() for r in rows])
    seeded = eng._seed_eligibility(mat, lengths)
    s, e = search.search_ranges(wide, torch.from_numpy(mat).to(device),
                                torch.from_numpy(lengths).to(device),
                                torch.from_numpy(seeded.astype(np.uint8)).to(device))
    s, e = s[: len(rows)], e[: len(rows)]
    hits = search.enumerate_range_positions(s, search.range_counts(s, e, wide=True))
    compact = compact_view(index, wide)
    k3w_runs(f"{args.bases // 1_000_000}M forced wide, hits of {args.queries} 25-mers", wide, hits,
             libs, reps, compact)
    rand = torch.from_numpy(rng.integers(0, wide.bwt_length, size=args.queries)).to(device)
    k3w_runs(f"{args.bases // 1_000_000}M forced wide, random positions", wide, rand, libs, reps)
    del wide, eng, hits, rand, s, e, compact
    torch.cuda.empty_cache()

    aa = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8), size=AMINO_RESIDUES)
    aa_index = create_index(aa.tobytes(), IndexConfiguration(8, 5, AlphabetType.AMINO),
                            sa_backend="native", device=device)
    aa_wide = aa_index.to_device(device, wide=True)
    rand = torch.from_numpy(rng.integers(0, aa_wide.bwt_length, size=args.queries)).to(device)
    k3w_runs(f"amino {AMINO_RESIDUES // 1_000_000}M forced wide, random positions", aa_wide,
             rand, libs, reps, compact_view(aa_index, aa_wide))
    del aa_index, aa_wide, rand
    torch.cuda.empty_cache()

    big = big_wide_index(BIG_BASES, args.cache, device)
    big_wide = big.to_device(device, wide=True)
    rand = torch.from_numpy(rng.integers(0, big_wide.bwt_length, size=args.queries)).to(device)
    k3w_runs(f"{BIG_BASES}-base wide view, random positions", big_wide, rand, libs, reps,
             compact_view(big, big_wide))
    del big, big_wide, rand
    torch.cuda.empty_cache()

    # above 2^32: phase 4x's tiled table (pair-fused rows), and the same
    # text in compact rows
    info = straddle_table(device, seed=4096, pair=True)
    view = straddle_view(info, device)
    compact = dc.replace(view, packed=straddle_table(device, seed=4096, pair=False, offset=0)["table"],
                         packed_pair=None, pair_fused=False)
    starts = short_walks(view, torch.from_numpy(info["rng"].integers(0, info["n"], args.queries)).to(device))
    k3w_runs(f"{info['n']}-position tiled table, starts whose walks end within 16 steps", view,
             starts, libs, reps, compact)
    del info, view, compact, starts
    torch.cuda.empty_cache()


def kernel_registers(build_log: str, *needles: str) -> list:
    """``{"kernel", "registers", "spill_bytes"}`` of each kernel entry in
    nvcc's ``-Xptxas -v`` report whose mangled name holds every needle;
    ``kernel`` is the needle's template with its arguments read from the
    mangled name (``k4_ngram_ranges_kernel<2, 3, 8, 0>``)."""
    out, name, spill = [], None, 0
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            name, spill = m.group(1), 0
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            spill = int(m.group(1)) + int(m.group(2))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            if all(n in name for n in needles):
                head = needles[0]
                seg = name[name.index(head) + len(head):]
                seg = seg[1:seg.index("EE") + 1] if seg.startswith("I") and "EE" in seg else ""
                targs = [a or b or c for a, b, c in
                         re.findall(r"\d+(Narrow|WideCompact|Wide)|Li(\d+)E|Lb([01])E", seg)]
                out.append({"kernel": f"{head}<{', '.join(targs)}>",
                            "registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    return out


def mask_pieces(mask: int) -> int:
    """64 B pieces of a row that a sector mask (bit s: 32 B sector s) touches."""
    return len({s // 2 for s in range(mask.bit_length()) if mask >> s & 1})


def visit_model(visits: dict, rates: dict, fixed_ms: float, ms: dict) -> dict:
    """A kernel's model (module note): its row visits by table at the
    calibrated rate of each table, plus ``fixed_ms`` (a launch that makes
    its seed-table visit and its stores and no step); each checkout's
    better time of its turns (``ms``) divided by it."""
    rows_ms = sum(v / rates[t] for t, v in visits.items()) * 1e3
    model = rows_ms + fixed_ms
    best = {name: min(times) for name, times in ms.items()}
    return {"row_visits": visits, "row_visits_ms": rows_ms, "fixed_ms": fixed_ms,
            "model_ms": model, "ms": best,
            "ms_over_model": {name: t / model for name, t in best.items()}}


def bytes_bound_ms(tables, stream_bytes: int) -> float:
    """Bytes moved once over 3.35 TB/s: ``tables`` (rows, bytes a visit
    needs, visits), distinct rows under uniformly random visits, plus the
    inputs and outputs."""
    once = float(stream_bytes)
    for nb, need, visits in tables:
        once += nb * (1.0 - math.exp(-visits / nb)) * need
    return once / HBM_BYTES_PER_S * 1e3


def pairless_cases(index, seq_arr, args, libs: dict, device) -> None:
    """The forms for a view without pair rows, every checkout in turns,
    with the calibrated models (module note)."""
    import dataclasses as dc

    import torch

    from .. import AlphabetType, IndexConfiguration, SearchEngine, create_index, search
    from ..ops import ngram
    from ..utils import roofline

    rng = np.random.default_rng(12)
    reps = args.reps
    this = libs["this"]
    for name, lib in libs.items():
        regs = (kernel_registers(lib.BUILD_LOG, "k4_ngram_ranges_kernel")
                + kernel_registers(lib.BUILD_LOG, "k4_block_ngram_ranges_kernel")
                + kernel_registers(lib.BUILD_LOG, "k2_ranges_kernel", "WideCompact")
                # narrow K2 over block rows and over pair rows (PAIR, the
                # fifth argument), each with and without its counter (COUNT)
                + kernel_registers(lib.BUILD_LOG, "k2_ranges_kernel", "Narrow")
                + kernel_registers(lib.BUILD_LOG, "k3_per_hit_kernel", "WideCompact"))
        # a library built by an earlier process of the same checkout leaves no report
        print(json.dumps({"case": "registers", "checkout": name, "built_here": bool(lib.BUILD_LOG),
                          "kernels": regs}), flush=True)

    eng = SearchEngine(index, device=device)
    pair, block = eng.dev, index.to_device(device, pair_rows=False)
    rows = _sampled(rng, seq_arr, 25, args.queries)
    mat, lengths, _ = eng.encode_kmers([r.tobytes() for r in rows])
    seeded = eng._seed_eligibility(mat, lengths)
    q25 = (torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
           torch.from_numpy(seeded.astype(np.uint8)).to(device))
    shape = f"{args.queries} 25-mers"
    k2_ms = run_case("k2 block rows", shape, lambda k: k.k2_ranges(block, *q25), libs, reps)
    run_case("k2 pair rows", shape, lambda k: k.k2_ranges(pair, *q25), libs, reps)
    s, e = search.ranges_plain(pair, *q25)
    s, e = s[: len(rows)], e[: len(rows)]
    hits = search.enumerate_range_positions(s, search.range_counts(s, e))
    run_case("k3 narrow rows", f"{hits.numel()} hits of the 25-mers, ratio {pair.ratio}",
             lambda k: k.k3_backtrace_resolve(pair, hits), libs, reps)
    seed_only = lengthwise_batch(q25[0], 25, args.seed_k)
    fixed = min(cuda_ms(lambda: this.k2_ranges(block, *seed_only), reps) for _ in range(2))
    ngs = {n: ngram.build_ngram_device(index, n, device=device) for n in (2, 3)}
    masks = {"block": roofline.first_block_visits(ngram_n=2)["single"][0],
             "pair": roofline.first_block_visits(ngram_n=2)["pair"][0]}
    tables = {"block": block.packed, "pair": pair.packed_pair}
    for n, ng in ngs.items():
        masks[f"ngram{n}"] = roofline.first_block_visits(ngram_n=n)["ngram_pair"][0]
        tables[f"ngram{n}"] = ng.packed
    rates = roofline.calibrate_gather_rates(tables, args.queries, device=device, log=_log,
                                            sector_masks=masks)
    # the block rows' ceiling: the same walk with CEILING_LANES lanes a chain
    ceiling = roofline.calibrate_gather_rates(
        {"block": block.packed}, args.queries, device=device, log=_log,
        sector_masks={"block": masks["block"]}, lanes=CEILING_LANES)["block"]
    print(json.dumps({"case": "pairless calibration", "rates_rows_per_s": rates, "tables": {
        t: {"rows": tab.shape[0], "row_bytes": tab.shape[1], "mask": masks[t],
            "pieces_per_visit": mask_pieces(masks[t]),
            "pieces_TB_per_s": rates[t] * mask_pieces(masks[t]) * 64 / 1e12}
        for t, tab in tables.items()}, "seed_only_k2_block_ms": fixed,
        "block_rows_by_lanes_a_chain": {1: rates["block"], CEILING_LANES: ceiling}}), flush=True)
    nb = block.num_blocks
    classes = torch.zeros(3, dtype=torch.int64, device=device)
    search.ranges_plain(block, *q25, classes)
    c = classes.tolist()
    visits = c[0] + 2 * (c[1] + c[2])
    line = visit_model({"block": visits}, rates, fixed, k2_ms)
    line["ceiling"] = {"lanes_a_chain": CEILING_LANES, "rate_rows_per_s": ceiling,
                       **visit_model({"block": visits}, {"block": ceiling}, fixed, k2_ms)}
    line.update(classes=c, bound_ms=bytes_bound_ms(
        [(nb, 3 * 32 + 4, visits)], args.queries * (q25[0].shape[1] + 4 + 1 + 2 * 8 + 16)))
    print(json.dumps({"case": "k2 block rows: model", **line}), flush=True)
    for n, ng in ngs.items():
        classes = search.new_step_classes(device)
        search.ngram_ranges_plain(block, ng, q25[0], 25, classes)
        ngc, tail = classes["ngram_pair"].tolist(), classes["pair"].tolist()
        ng_visits = ngc[0] + ngc[1] + 2 * ngc[2]
        ng_need = (2 * n + 1) * 32 + 4
        for tag, view in (("block", block), ("pair", pair)):
            ms = run_case(f"k4 n={n}, tail over {tag} rows", shape,
                          lambda k: k.k4_ngram_ranges(view, ng, q25[0], 25), libs, reps)
            if tag == "block":
                visits = {f"ngram{n}": ng_visits, "block": tail[0] + 2 * (tail[1] + tail[2])}
            else:
                # the first-block class reads the block row in either view
                visits = {f"ngram{n}": ng_visits, "pair": tail[1], "block": tail[0] + 2 * tail[2]}
            line = visit_model(visits, rates, fixed, ms)
            line["bound_ms"] = bytes_bound_ms(
                [(ng.packed.shape[0], ng_need, ng_visits), (nb, 3 * 32 + 4, sum(visits.values()) - ng_visits)],
                args.queries * (q25[0].shape[1] + 2 * 8 + 16))
            line.update(ngram_classes=ngc, tail_classes=tail)
            print(json.dumps({"case": f"k4 n={n}, tail over {tag} rows: model", **line}), flush=True)
    del ngs, eng, pair, block, q25, seed_only, hits, s, e
    torch.cuda.empty_cache()

    aa = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8), size=K1_AMINO_RESIDUES)
    aa_index = create_index(aa.tobytes(), IndexConfiguration(8, 5, AlphabetType.AMINO),
                            sa_backend="native", device=device)
    fused = aa_index.to_device(device, wide=True, pair_rows=True)
    compact = aa_index.to_device(device, wide=True, pair_rows=False)
    aa_eng = SearchEngine(compact, device=device)
    rows = _sampled(rng, aa, 12, args.queries)
    mat, lengths, _ = aa_eng.encode_kmers([r.tobytes() for r in rows])
    seeded = aa_eng._seed_eligibility(mat, lengths)
    q12 = (torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
           torch.from_numpy(seeded.astype(np.uint8)).to(device))
    shape = f"{args.queries} 12-mers, k=5"
    tag = f"amino {K1_AMINO_RESIDUES}"
    ms = run_case(f"k2w {tag}, compact rows", shape, lambda k: k.k2_ranges(compact, *q12), libs, reps)
    run_case(f"k2w {tag}, pair-fused rows", shape, lambda k: k.k2_ranges(fused, *q12), libs, reps)
    rand = torch.from_numpy(rng.integers(0, aa_index.bwt_length, size=args.queries)).to(device)
    pshape = f"{args.queries} random positions, ratio 8"
    k3_ms = run_case(f"k3w {tag}, compact rows", pshape,
                     lambda k: k.k3_backtrace_resolve(compact, rand), libs, reps)
    disk = dc.replace(compact, sampled_sa=None)
    run_case(f"k3w {tag}, compact rows, on-disk form", pshape,
             lambda k: k.k3_backtrace_resolve(disk, rand), libs, reps)
    run_case(f"k3w {tag}, pair-fused rows", pshape,
             lambda k: k.k3_backtrace_resolve(fused, rand), libs, reps)
    mask = roofline.first_block_visits(AlphabetType.AMINO, compact=True)["compact"][0]
    rate = roofline.calibrate_gather_rates({"compact": compact.packed}, args.queries,
                                           device=device, log=_log, sector_masks={"compact": mask})
    classes = torch.zeros(3, dtype=torch.int64, device=device)
    search.ranges_plain(compact, *q12, classes)
    c = classes.tolist()
    visits = c[0] + 2 * (c[1] + c[2])
    seed_only = lengthwise_batch(q12[0], 12, compact.kmer_length_in_seed_table)
    fixed = min(cuda_ms(lambda: this.k2_ranges(compact, *seed_only), reps) for _ in range(2))
    line = visit_model({"compact": visits}, rate, fixed, ms)
    need = compact.n_planes * 32 + 8
    pieces = compact_pieces(compact.n_planes, compact.cardinality)
    line.update(classes=c, rates_rows_per_s=rate, mask=mask, pieces_per_visit=mask_pieces(mask),
                pieces_TB_per_s=rate["compact"] * mask_pieces(mask) * 64 / 1e12,
                bound_ms=bytes_bound_ms([(compact.num_blocks, need, visits)],
                                        args.queries * (q12[0].shape[1] + 4 + 1 + 2 * 8 + 16)),
                piece_model_ms=visits * pieces * 64 / HBM_BYTES_PER_S * 1e3,
                compact_pieces_per_visit=pieces)
    print(json.dumps({"case": f"k2w {tag}, compact rows: model", **line}), flush=True)
    # K3w over compact rows: its LF steps at the compact rows' rate plus a
    # launch whose walks take no step (the SA visits and stores), the
    # lane occupancy of one lane a hit, the bound
    _, off = search.backtrace_resolve_plain(disk, rand)
    steps = int(off.sum())
    sampled = (rand // compact.ratio) * compact.ratio
    fixed = min(cuda_ms(lambda: this.k3_backtrace_resolve(compact, sampled), reps) for _ in range(2))
    line = visit_model({"compact": steps}, rate, fixed, k3_ms)
    line.update(lf_steps=steps, hits=rand.numel(),
                lane_occupancy=1.0 / roofline.warp_lane_occupancy(off),
                bound_ms=max(bytes_bound_ms([(compact.num_blocks, need, steps)], rand.numel() * 24),
                             steps * (8 * (2 * compact.n_planes + 1) + 4 * 8) / OPS_PER_S * 1e3),
                piece_model_ms=steps * pieces * 64 / HBM_BYTES_PER_S * 1e3)
    print(json.dumps({"case": f"k3w {tag}, compact rows: model", **line}), flush=True)
    del fused, compact, disk, aa_eng, aa_index, q12, rand, seed_only, sampled, off
    torch.cuda.empty_cache()


def _package_module(kernels_module, name: str):
    """The module ``<package>.<name>`` of the checkout whose ``ops.kernels``
    is ``kernels_module`` (``search``)."""
    return importlib.import_module(kernels_module.__name__.rsplit(".", 2)[0] + "." + name)


def occ_route_step(index, start: int, end: int, letter: int, *, device, wide=None,
                   pair_rows=None):
    """``iterative_step_backward_search`` as it ran before K1's step mode:
    the batched ``rank.backward_step`` over K1's occ mode on a one-element
    batch, its range and letter uploaded, its answer read back word by
    word. Kept to time the two routes in turns in one process."""
    import torch
    from ..ops import rank

    dev = index.to_device(device, wide=wide, pair_rows=pair_rows)

    def one(v):
        return torch.tensor([rank.int64_of(int(v) & 2**64 - 1)], dtype=torch.int64,
                            device=dev.device)

    s, e = rank.backward_step(dev, one(start), one(end),
                              torch.tensor([letter], dtype=torch.int64, device=dev.device),
                              check_valid=False)
    return int(s[0]) & 2**64 - 1, int(e[0]) & 2**64 - 1


def occ_route_lf(index, position: int, *, device, wide=None, pair_rows=None):
    """``backtrace_return_previous_letter_index`` as it ran before K1's LF
    mode by value: the batched ``rank.letter_and_lf_at`` on an uploaded
    one-element batch, letter and LF read back one after the other."""
    import torch
    from ..ops import rank

    dev = index.to_device(device, wide=wide, pair_rows=pair_rows)
    lett, lf = rank.letter_and_lf_at(dev, torch.tensor(
        [rank.int64_of(int(position) & 2**64 - 1)], dtype=torch.int64, device=dev.device))
    lett_v = int(lett[0])
    if lett_v == dev.sentinel:
        return 0, position
    return lett_v, int(lf[0]) & 2**64 - 1


def trace_calls(fn, out_dir: str, tag: str) -> dict:
    """A torch.profiler trace of ``fn()`` on the card, read from its chrome
    trace (written to ``out_dir/<tag>.json``): ``{"kernels": {name: [launches,
    device us]}, "dtoh": n, "htod": n, "other_copies": n, "memsets": n,
    "device_us": total}``, the copies being its ``gpu_memcpy`` events by
    direction, the memsets its ``gpu_memset`` events.
    ``fn`` runs twice, once in the profiler's warm-up cycle, whose events
    are dropped (the first of a cold trace can be lost), then traced."""
    import torch
    from torch.profiler import ProfilerActivity, profile, schedule

    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{tag}.json")
    if os.path.exists(path):
        os.remove(path)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda p: p.export_chrome_trace(path)) as prof:
        for _ in range(2):
            fn()
            torch.cuda.synchronize()
            prof.step()
    with open(path) as fh:
        events = json.load(fh).get("traceEvents", [])
    out = {"kernels": {}, "dtoh": 0, "htod": 0, "other_copies": 0, "memsets": 0, "device_us": 0.0}
    for ev in events:
        cat, name, dur = ev.get("cat", ""), ev.get("name", ""), float(ev.get("dur", 0.0))
        if cat == "kernel":
            k = out["kernels"].setdefault(name, [0, 0.0])
            k[0] += 1
            k[1] += dur
        elif cat == "gpu_memcpy":
            key = "dtoh" if "DtoH" in name else ("htod" if "HtoD" in name else "other_copies")
            out[key] += 1
        elif cat == "gpu_memset":
            out["memsets"] += 1
        else:
            continue
        out["device_us"] += dur
    return out


def walk_calls(index, walks, lf_pos, kw: dict, step, lf):
    """Each query of ``walks`` walked letter by letter by ``step`` (an
    ``iterative_step_backward_search``) from its last letter's range, and
    ``lf`` (a ``backtrace_return_previous_letter_index``) at each position
    of ``lf_pos``, every call timed on the host clock: (step us, LF us,
    the walks' ranges and the LF answers)."""
    import time

    from ..models import alphabet as alpha

    ps = [int(c) for c in index.prefix_sums]
    step_us, lf_us, answers = [], [], []
    for q in walks:
        letters = alpha.ascii_to_index(np.frombuffer(q, np.uint8), index.alphabet).tolist()
        s, e = ps[letters[-1]], ps[letters[-1] + 1] - 1
        for lett in reversed(letters[:-1]):
            t0 = time.perf_counter_ns()
            s, e = step(index, s, e, lett, **kw)
            step_us.append((time.perf_counter_ns() - t0) / 1e3)
        answers.append((s, e))
    for p in lf_pos:
        t0 = time.perf_counter_ns()
        answers.append(lf(index, p, **kw))
        lf_us.append((time.perf_counter_ns() - t0) / 1e3)
    return step_us, lf_us, answers


def floor_us(dev, calls: int) -> float:
    """Median host us of ``kernels.empty_call`` (an empty launch and the
    16 B readback) over ``calls`` calls."""
    import time

    from ..ops import kernels

    kernels.empty_call(dev)
    times = []
    for _ in range(calls):
        t0 = time.perf_counter_ns()
        kernels.empty_call(dev)
        times.append((time.perf_counter_ns() - t0) / 1e3)
    return float(np.median(times))


def single_query_case(tag: str, index, kw: dict, walks, lf_pos, libs: dict, device,
                      trace_dir: str) -> None:
    """The single-query API through every checkout on the view ``kw`` names
    (installed on ``index``), in turns: the median host us of a step call
    and of an LF call, the floor beside each turn, equal answers; then one
    traced run a checkout: device us and copies a call."""
    names = list(libs)
    kw = dict(device=device, **kw)
    dev = index.to_device(**kw)
    api = {name: _package_module(km, "search") for name, km in libs.items()}
    for name in names:  # warm-up: builds, views' tables, buffers
        walk_calls(index, walks[:1], lf_pos[:1], kw, api[name].iterative_step_backward_search,
                   api[name].backtrace_return_previous_letter_index)
    want = None
    step_us = {name: [] for name in names}
    lf_us = {name: [] for name in names}
    floors = []
    for name in names + names[::-1]:
        st, lt, got = walk_calls(index, walks, lf_pos, kw, api[name].iterative_step_backward_search,
                                 api[name].backtrace_return_previous_letter_index)
        if want is None:
            want = got
        elif got != want:
            raise AssertionError(f"{tag}: {name}'s single-query answers differ")
        step_us[name].append(float(np.median(st)))
        lf_us[name].append(float(np.median(lt)))
        floors.append(floor_us(dev, len(st) + len(lt)))
    steps = len(walks) * (len(walks[0]) - 1)
    device_per_call = {}
    for name in names:
        step_trace = trace_calls(lambda: walk_calls(
            index, walks, [], kw, api[name].iterative_step_backward_search,
            api[name].backtrace_return_previous_letter_index), trace_dir, f"{tag}-{name}-step")
        lf_trace = trace_calls(lambda: walk_calls(
            index, [], lf_pos, kw, api[name].iterative_step_backward_search,
            api[name].backtrace_return_previous_letter_index), trace_dir, f"{tag}-{name}-lf")
        device_per_call[name] = {}
        for mode, tr, calls in (("step", step_trace, steps), ("lf", lf_trace, len(lf_pos))):
            k1_us = sum(us for k, (_, us) in tr["kernels"].items() if "k1_" in k)
            device_per_call[name][mode] = {
                "k1_us": k1_us / calls, "device_us": tr["device_us"] / calls,
                "kernels": sum(c for c, _ in tr["kernels"].values()) / calls,
                "dtoh": tr["dtoh"] / calls, "htod": tr["htod"] / calls}
    print(json.dumps({"case": f"k1{tag} single-query calls",
                      "shape": f"{len(walks)} walks ({steps} steps), {len(lf_pos)} LF calls",
                      "step_us": step_us, "lf_us": lf_us, "floor_us": floors,
                      "device": device_per_call}), flush=True)


def k1_batch_case(tag: str, dev, libs: dict, reps: int, rng, device) -> None:
    """K1's occ mode at 8,388,608 random pairs, then its LF mode at
    1,048,576 positions, through every checkout, in turns."""
    import torch

    b = 1 << 23
    pos = torch.from_numpy(rng.integers(0, dev.bwt_length, size=b)).to(device)
    lett = torch.from_numpy(rng.integers(0, dev.cardinality, size=b).astype(np.int32)).to(device)
    run_case(f"k1{tag} occ", f"{b} pairs", lambda k: k.k1_occurrence(dev, pos, lett), libs, reps)
    lpos = pos[: 1 << 20].contiguous()
    run_case(f"k1{tag} letter_lf", f"{lpos.numel()} positions",
             lambda k: k.k1_letter_and_lf(dev, lpos), libs, reps)
    del pos, lett, lpos
    torch.cuda.empty_cache()


def k1_cases(index, seq_arr, args, libs: dict, device) -> None:
    """K1's single-query calls and its batch modes (module note)."""
    import torch

    from .. import AlphabetType, IndexConfiguration, create_index

    rng = np.random.default_rng(15)
    trace_dir = os.path.join(args.cache, "traces")
    walks = [r.tobytes() for r in _sampled(rng, seq_arr, 25, 16)]
    lf_pos = [int(p) for p in rng.integers(0, index.bwt_length, 64)]
    k1_batch_case("", index.to_device(device), libs, args.reps, rng, device)
    for tag, kw in (("", {}), (" without pair rows", {"pair_rows": False}),
                    ("w", {"wide": True})):
        single_query_case(tag, index, kw, walks, lf_pos, libs, device, trace_dir)
    k1_batch_case("w", index.to_device(device, wide=True), libs, args.reps, rng, device)
    index._device_cache = None
    torch.cuda.empty_cache()
    aa = rng.choice(np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8), size=K1_AMINO_RESIDUES)
    aa_index = create_index(aa.tobytes(), IndexConfiguration(8, 5, AlphabetType.AMINO),
                            sa_backend="native", device=device)
    view = aa_index.to_device(device, wide=True, pair_rows=False)
    _log(f"amino index of {K1_AMINO_RESIDUES} residues on {view.packed.shape[1]} B compact rows")
    k1_batch_case("w compact", view, libs, args.reps, rng, device)
    aa_walks = [r.tobytes() for r in _sampled(rng, aa, 12, 16)]
    aa_lf = [int(p) for p in rng.integers(0, aa_index.bwt_length, 64)]
    single_query_case("w compact", aa_index, {"wide": True, "pair_rows": False}, aa_walks,
                      aa_lf, libs, device, trace_dir)


def k5_cases(libs: dict, reps: int, device) -> None:
    """K5's reduce through every checkout at phase 3b's shapes, over a
    1 GiB table and a 64 MiB one (module note)."""
    import torch

    from . import gather_probe as gp

    batch = 1 << 19
    configs = [(r, r, ring, chunk) for r, ring, chunk in gp.P2_CONFIGS]
    configs += [(1024, 128, ring, chunk) for ring, chunk in gp.P3_CONFIGS]
    for table_bytes in (1 << 30, 1 << 26):
        for r in sorted({c[0] for c in configs}):
            table = gp._random_table(table_bytes // r, r, device, 7)
            idx = gp._random_idx(batch, table.shape[0], device, 8)
            for _, sum_bytes, ring, chunk in (c for c in configs if c[0] == r):
                run_case(f"k5 u8x{r} sum {sum_bytes} K={ring} CHUNK={chunk}",
                         f"{batch} rows of a {table_bytes >> 20} MiB table",
                         lambda k: k.k5_gather_reduce(table, idx, sum_bytes, chunk, ring),
                         libs, reps, device=True)
            del table, idx
            torch.cuda.empty_cache()


def k4_rows_cases(args, device) -> None:
    """K5's walk over chr1-sized n-gram rows in the pair layout's and K4's
    layout's first-block masks (module note)."""
    import torch

    from ..ops import ngram
    from ..utils import roofline

    gen = torch.Generator(device=device).manual_seed(22)
    for n in (2, 3):
        _, _, n_planes, ms_offset, row_bytes = ngram._geometry_pair(n)
        table = torch.randint(0, 256, (CHR1_NGRAM_ROWS, row_bytes), dtype=torch.uint8,
                              device=device, generator=gen)
        words = roofline.k4_word_masks(n)
        masks = {"pair": roofline.first_block_sector_mask(n_planes, 64, ms_offset),
                 **{f"k4 {m:#x}": m for m in words}}
        for rnd in range(2):
            rates = roofline.calibrate_gather_rates({t: table for t in masks}, args.queries,
                                                    device=device, runs=5, log=_log,
                                                    sector_masks=masks)
            k4 = 1.0 / sum(share / rates[f"k4 {m:#x}"] for m, share in words.items())
            pieces = {"pair": mask_pieces(masks["pair"]),
                      "k4": sum(share * mask_pieces(m) for m, share in words.items())}
            visits = {"pair": rates["pair"], "k4": k4}
            print(json.dumps({
                "case": f"k4 rows n={n}", "round": rnd, "rows": CHR1_NGRAM_ROWS,
                "row_bytes": row_bytes, "lanes": args.queries, "visits_per_s": visits,
                "by_mask": {t: {"mask": m, "pieces": mask_pieces(m), "visits_per_s": rates[t],
                                "share": words.get(m, 1.0)} for t, m in masks.items()},
                "pieces_per_visit": pieces,
                "pieces_TB_per_s": {t: visits[t] * pieces[t] * 64 / 1e12 for t in visits},
                "k4_over_pair": k4 / rates["pair"]}), flush=True)
        del table
        torch.cuda.empty_cache()


def enumerate_batch(n: int, extra: float, rng, device):
    """(start, end, capacity): ``n`` ranges of 1 + Poisson(``extra``)
    hits at random u32 starts, on ``device``, and their total rounded up
    to ``CAPACITY_GRAIN``."""
    import torch

    counts = 1 + rng.poisson(extra, size=n)
    start = rng.integers(0, 2**32 - int(counts.max()), size=n, dtype=np.int64)
    cap = -(-int(counts.sum()) // CAPACITY_GRAIN) * CAPACITY_GRAIN
    return (torch.from_numpy(start).to(device), torch.from_numpy(start + counts - 1).to(device),
            cap)


def enumerate_cases(args, libs: dict, device) -> None:
    """K7 against the torch chain and the other checkouts' enumerate at the
    locate cells' shapes (module note)."""
    import torch

    from .. import search
    from ..ops import kernels

    rng = np.random.default_rng(24)
    others = {name: _package_module(lib, "search") for name, lib in libs.items() if name != "this"}
    for name, (n, extra) in ENUMERATE_SHAPES.items():
        start, end, cap = enumerate_batch(n, extra, rng, device)
        fns = {"k7": lambda: search.enumerate_flat(start, end, capacity=cap),
               "plain": lambda: search.enumerate_flat_plain(start, end, capacity=cap)}
        fns.update({other: (lambda m=m: m.enumerate_flat(start, end, capacity=cap))
                    for other, m in others.items()})
        before = kernels.K7.launches
        got = fns["k7"]()
        launches = kernels.K7.launches - before
        for other, fn in fns.items():
            if other != "k7" and not _same(got, fn()):
                raise AssertionError(f"enumerate {name}: K7 differs from {other}")
        slots = int(got[2].sum())
        del got
        ms = {k: [] for k in fns}
        dev_ms = {k: [] for k in fns}
        for r in range(ENUMERATE_ROUNDS):
            for k in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                ms[k].append(cuda_ms(fns[k], args.reps))
                dev_ms[k].append(device_ms(fns[k], args.reps))
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fns["k7"]()
            torch.cuda.synchronize()
        split = {e.key: e.device_time_total / 1e3 / args.reps for e in prof.key_averages()
                 if "k7_" in e.key}
        bound = (13 * cap + 16 * n) / HBM_BYTES_PER_S * 1e3
        print(json.dumps({
            "case": f"enumerate {name}", "ranges": n, "slots": slots, "capacity": cap,
            "k7_launches_a_call": launches, "bound_ms": bound, "k7_kernels_ms": split,
            "best_ms": {k: min(v) for k, v in ms.items()},
            "best_device_ms": {k: min(v) for k, v in dev_ms.items()},
            "k7_over_bound": min(dev_ms["k7"]) / bound, "ms": ms, "device_ms": dev_ms}),
            flush=True)
        del start, end
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


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--other", action="append", default=[], metavar="NAME=DIR")
    ap.add_argument("--bases", type=int, default=64_000_000)
    ap.add_argument("--queries", type=int, default=1 << 20)
    ap.add_argument("--seed-k", type=int, default=14)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--cases", choices=CASES, default="all")
    ap.add_argument("--cache", default=DEFAULT_CACHE,
                    help="k3w: where the big index is saved after its first build")
    ap.add_argument("--bfs-max-parents", type=int, nargs="*", default=[],
                    help="bfs: also time this checkout's whole BFS split at these thresholds")
    args = ap.parse_args(argv)
    for item in args.other:
        if "=" not in item:
            ap.error(f"--other takes NAME=DIR, got {item!r}")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)

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
    # each checkout's library at once: one nvcc a source, all started together
    with ThreadPoolExecutor(len(libs)) as pool:
        built = dict(zip(libs, pool.map(lambda lib: lib.build(), libs.values())))
    for name, lib in libs.items():
        _log(f"{name}: built in {built[name]:.1f}s -> {lib.library_path()}")

    if args.cases == "k5":
        k5_cases(libs, args.reps, device)
        return 0
    if args.cases == "k4rows":
        k4_rows_cases(args, device)
        return 0
    if args.cases == "enumerate":
        enumerate_cases(args, libs, device)
        return 0
    rng = np.random.default_rng(1234)
    seq_arr = rng.choice(np.frombuffer(b"acgt", np.uint8), size=args.bases)
    index = create_index(seq_arr.tobytes(), IndexConfiguration(8, args.seed_k, AlphabetType.DNA),
                         sa_backend="native", device=device)
    if args.cases == "rs":
        rs_cases(index, libs, args.reps, device)
        return 0
    if args.cases == "k3w":
        k3w_cases(index, seq_arr, args, libs, device)
        return 0
    if args.cases == "pairless":
        pairless_cases(index, seq_arr, args, libs, device)
        return 0
    if args.cases == "k1":
        k1_cases(index, seq_arr, args, libs, device)
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

    splits = args.bfs_max_parents
    bfs_cases(index, {"": (dev, args.seed_k)}, libs, reps, splits)
    if args.cases == "all":
        index_cases(dev, "", k4=True)
    wide = index.to_device(device, wide=True)
    bfs_cases(index, {"w": (wide, args.seed_k - 1)}, libs, reps, splits)
    if args.cases == "bfs":
        del dev, wide, eng, ng
        index._device_cache = None
        torch.cuda.empty_cache()
        compact_bfs_cases(libs, reps, splits, rng, device)
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

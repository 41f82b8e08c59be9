"""Roofline accounting: measured throughput against gather and HBM ceilings.

Counterpart of ``avxwindowfmindex_tpu/utils/roofline.py``. The search is
bound by dependent random row reads, so a stage's throughput is set
against two ceilings:

  - bytes: row bytes moved per query against the card's peak HBM
    bandwidth (the published figure);
  - rows:  row reads per query against a MEASURED random-row rate of
    each table touched, from :func:`calibrate_gather_rates` run in the
    same process on the same tables — so a fraction is <= 1 by
    construction, not by assumption.

Tables and their row bytes (nucleotide):

  single      dev.packed        128 B   K3's LF walk, K2's two-row step,
                                        and the first-block class of K2's
                                        and K4's tail's one-row step
  pair        dev.packed_pair   256 B   that step's pair window
  ngram_pair  NgramIndex.packed 384 B   K4's n-gram step (n = 2; K4
                                        reads NgramIndex.k4, the same
                                        rows in its byte order)

``range_phase_rows`` and ``table_row_bytes`` keep the JAX formulas: K2
and K4 visit exactly those rows per step. What a visit reads of its row
is less: a step whose range lies in the first block of the row (nearly
every step at the bench's seed k) loads the first 32 B sector of each
plane and the sector of its milestone, 192 of an n-gram row's 384 B
and 128 of a pair row's 256 B (:func:`first_block_visits`). So
:func:`report` takes per-table *visit bytes* beside the row bytes (the
default, whole rows, is the JAX package's model), and the calibration
walks each table with the visit's sector mask: bytes and rates both
describe the visits the kernels make. ``backtrace_rows_per_position``
models K3 (one block row per LF step, no compaction passes), not the JAX
compaction schedule; the routed (slab) terms do not carry over. Without
measured rates :func:`report` returns the byte model with
``calibrated: false`` and null ceilings: no TPU rate stands in.

A table the card's L2 holds whole (a 64M-base index's 32 MB of block
rows in a 50 MiB L2) is read from DRAM about once per batch, however
many times a batch visits it: given the tables' row counts and the
queries a launch takes, :func:`report` charges such a table the rows a
batch of uniform visits touches (:func:`distinct_rows`), not every
visit. The HBM fraction is then a floor of DRAM's share, never above
what DRAM moved; ``utils/dram.memory_busy`` reads the card's own
DRAM-busy share to check it against.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class ChipSpec:
    name: str
    hbm_gbps: Optional[float]  # peak HBM bandwidth, GB/s; None = unknown
    l2_bytes: Optional[int] = None  # L2 capacity; None = unknown (no table held)


#: Published figures (NVIDIA's H100 SXM data sheet), not measurements.
CHIPS = {
    "h100": ChipSpec("NVIDIA H100 80GB HBM3", 3350.0, 50 * 2**20),
}


def detect_chip(device) -> ChipSpec:
    """The spec of ``device``'s card, read from ``torch.cuda.get_device_name``.

    A card the table does not know, or a device that is not a card,
    gets its name and an unknown bandwidth (no HBM fraction)."""
    import torch

    from ..models.index import as_device

    device = as_device(device)
    if device.type != "cuda":
        return ChipSpec(str(device), None)
    name = torch.cuda.get_device_name(device)
    l2 = int(torch.cuda.get_device_properties(device).L2_cache_size)
    if "H100" in name:
        return dataclasses.replace(CHIPS["h100"], name=name, l2_bytes=l2)
    return ChipSpec(name, None, l2)


def range_phase_rows(
    kmer_len: int,
    seed_k: int,
    *,
    ngram_n: int = 1,
    pair_rows: bool = True,
) -> Dict[str, float]:
    """Row reads per query for the range (extension) phase, by table.

    ngram_n >= 2: floor(m/n) one-row n-steps over the n-gram pair table
    + (m mod n) single-letter steps; ngram_n == 1: m single steps. With
    pair rows each single step reads ONE pair row; without, two block
    rows. The two-row n-gram step reads its table twice.
    """
    m = max(0, kmer_len - seed_k)
    rows: Dict[str, float] = {}
    if ngram_n >= 2:
        steps = m // ngram_n
        tail = m % ngram_n
        if steps:
            rows["ngram_pair"] = float(steps * (1 if pair_rows else 2))
    else:
        tail = m
    if tail:
        if pair_rows:
            rows["pair"] = float(tail)
        else:
            rows["single"] = float(2 * tail)
    return rows


def backtrace_rows_per_position(ratio: int) -> float:
    """Block rows K3 reads per position entering the backtrace.

    K3 walks one thread per position, one 128 B block row per LF step,
    until it reaches a BWT position divisible by ``ratio``; each step
    lands there with chance 1/ratio, so the expected walk is ratio - 1
    steps (0 at ratio 1). No masked or padded passes are paid.
    """
    return float(max(0, ratio - 1))


def warp_lane_occupancy(off, warp: int = 32) -> float:
    """The lane-occupancy ratio of a backtrace that walks one hit per
    lane, ``warp`` neighbouring hits per warp, in the order of ``off``
    (the LF steps each hit walks, a 1-D integer tensor; K3's on-disk form
    returns it): the lane-steps the warps hold, ``warp`` x the longest
    walk of each warp, over the steps walked. A warp runs until its
    longest walk ends, so 1 means every lane works all the time and 4
    that a lane works a quarter of it. The last warp counts all its
    lanes, filled or not; a batch that walks nothing has ratio 1."""
    import torch

    off = off.to(torch.int64).reshape(-1)
    walked = int(off.sum())
    if walked == 0:
        return 1.0
    pad = -off.numel() % warp
    if pad:
        off = torch.cat([off, off.new_zeros(pad)])
    held = int(off.reshape(-1, warp).max(dim=1).values.sum()) * warp
    return held / walked


def table_row_bytes(alphabet=None, *, ngram_n: int = 2) -> Dict[str, int]:
    """Row bytes of each table of the active engine."""
    from ..models import index as index_mod
    from ..models.config import AlphabetType

    alphabet = alphabet or AlphabetType.DNA
    out = {
        "single": index_mod.device_row_bytes(alphabet),
        "pair": index_mod.device_pair_row_bytes(alphabet),
    }
    if alphabet != AlphabetType.AMINO and ngram_n >= 2:
        from ..ops import ngram as ngram_ops

        out["ngram_pair"] = ngram_ops._geometry_pair(ngram_n)[4]
    return out


def first_block_sector_mask(n_planes: int, plane_stride: int, milestone_offset: int) -> int:
    """The 32 B sectors of a row that a first-block visit reads: the one
    holding the first 32 B of each plane and the one at the milestones'
    offset (a letter's or word's milestone lies in one sector; where the
    milestones span two, the first stands for it). Bit s: sector s."""
    mask = 1 << (milestone_offset // 32)
    for i in range(n_planes):
        mask |= 1 << (i * plane_stride // 32)
    return mask


def k4_word_masks(ngram_n: int) -> Dict[int, float]:
    """{sector mask: share of the 4^n words} of K4's first-block visits to
    its n-gram rows (``ops/ngram.py:_geometry_k4``): the first 32 B of each
    plane, sectors 0 .. planes - 1, and the sector of the word's
    milestone, which depends on the word."""
    from ..ops import ngram as ngram_ops

    n_planes, ms_offset, _, _ = ngram_ops._geometry_k4(ngram_n)
    n_words = 4**ngram_n
    out: Dict[int, float] = {}
    for v in range(n_words):
        mask = first_block_sector_mask(n_planes, 32, ms_offset + 4 * v)
        out[mask] = out.get(mask, 0.0) + 1.0 / n_words
    return out


def first_block_visits(alphabet=None, *, ngram_n: int = 2,
                       compact: bool = False) -> Dict[str, tuple]:
    """(sector mask, bytes) of a first-block visit to each table of the
    narrow engine: what K1 and K3 read of a block row (all of it) and
    what a step of K2 reads of a pair row (planes 64 B apart) and K4 of
    its n-gram rows (``ngram_n`` letters a step: 5 planes at n = 2, 7 at
    n = 3, 32 B apart in K4's layout, ``ops/ngram.py:_geometry_k4``) when
    both ends of its range lie in the row's first block. The n-gram
    milestone that stands for all is word 4^n / 2's, whose sector half
    the words' visits reach (:func:`k4_word_masks` has each word's).

    ``compact``: also ``"compact"``, a visit to the compact wide rows of
    a view without pair rows (``pack_device_blocks64(pair=False)``: planes
    32 B apart, u64 milestones after them), what K1w, K2w and K3w read
    there. Those milestones span several sectors and 64 B pieces; the
    middle letter's stands for them, so the walk touches the pieces most
    visits touch (amino: four, as 16 of 20 letters' visits do)."""
    from ..models import alphabet as alpha
    from ..models.config import AlphabetType

    alphabet = alphabet or AlphabetType.DNA
    n_planes = alpha.num_bit_planes(alphabet)
    masks = {
        "single": first_block_sector_mask(n_planes, 32, n_planes * 32),
        "pair": first_block_sector_mask(n_planes, 64, n_planes * 64),
    }
    if alphabet != AlphabetType.AMINO and ngram_n >= 2:
        from ..ops import ngram as ngram_ops

        ng_planes, ms_offset, _, _ = ngram_ops._geometry_k4(ngram_n)
        masks["ngram_pair"] = first_block_sector_mask(
            ng_planes, 32, ms_offset + 4 * (4**ngram_n // 2))
    if compact:
        middle = alpha.cardinality(alphabet) // 2
        masks["compact"] = first_block_sector_mask(n_planes, 32, n_planes * 32 + 8 * middle)
    return {t: (m, 32 * bin(m).count("1")) for t, m in masks.items()}


def distinct_rows(visits: float, rows: int) -> float:
    """Expected distinct rows that ``visits`` uniform random visits touch
    in a table of ``rows`` rows: rows x (1 - (1 - 1/rows)^visits)."""
    if rows <= 0 or visits <= 0:
        return 0.0
    if rows == 1:
        return 1.0
    return rows * -math.expm1(visits * math.log1p(-1.0 / rows))


def report(
    queries_per_sec: float,
    *,
    kmer_len: int,
    seed_k: int,
    ratio: int,
    chip: ChipSpec,
    ngram_n: int = 1,
    pair_rows: bool = True,
    locate_positions_per_query: float = 0.0,
    row_bytes: Optional[Dict[str, int]] = None,
    rates: Optional[Dict[str, float]] = None,
    visit_bytes: Optional[Dict[str, int]] = None,
    table_rows: Optional[Dict[str, int]] = None,
    batch_queries: Optional[int] = None,
) -> dict:
    """Roofline summary of a measured throughput on the active engine.

    ``locate_positions_per_query``: positions entering the backtrace per
    query — 0 for count, 1 for first-hit locate, capacity / queries for
    full-hit-list locate (K3 walks every slot of the capacity batch,
    masked ones included). ``rates``: per-table measured row rates
    (rows/s) from :func:`calibrate_gather_rates`; without them the
    gather ceiling is null and ``calibrated`` is False. ``visit_bytes``:
    the bytes one visit reads of a row of each table, where that is less
    than the row (:func:`first_block_visits`); the default charges whole
    rows. ``table_rows`` (rows of each table) and ``batch_queries``
    (queries a launch takes): where both are given and ``chip`` knows its
    L2, a table whose rows fit the L2 is charged, per phase, the distinct
    rows a batch's visits touch over the batch's queries, and the phase
    names it under ``l2_held``; the gather ceiling is unchanged (the
    calibration walks the same tables).
    """
    row_bytes = row_bytes or table_row_bytes(ngram_n=ngram_n)
    visit_bytes = {**row_bytes, **(visit_bytes or {})}
    calibrated = rates is not None
    phase_rows = {"range": range_phase_rows(
        kmer_len, seed_k, ngram_n=ngram_n, pair_rows=pair_rows
    )}
    bt_rows = backtrace_rows_per_position(ratio) * locate_positions_per_query
    if bt_rows:
        phase_rows["backtrace"] = {"single": bt_rows}

    held = set()
    if table_rows and batch_queries and chip.l2_bytes:
        held = {t for t, r in table_rows.items()
                if t in row_bytes and r * row_bytes[t] <= chip.l2_bytes}

    def table_bytes(t: str, n: float) -> float:
        if t in held:
            return distinct_rows(n * batch_queries, table_rows[t]) * visit_bytes[t] / batch_queries
        return n * visit_bytes[t]

    phases = {}
    for name, rows_by_table in phase_rows.items():
        bytes_q = sum(table_bytes(t, n) for t, n in rows_by_table.items())
        if name == "backtrace":
            # the sampled-SA resolve: one 4 B element per position
            bytes_q += 4.0 * locate_positions_per_query
        phases[name] = {
            "rows_per_query": round(sum(rows_by_table.values()), 3),
            "bytes_per_query": round(bytes_q, 1),
            "l2_held": sorted(held & set(rows_by_table)),
            "gather_seconds_per_query": (
                sum(n / rates[t] for t, n in rows_by_table.items())
                if calibrated else None
            ),
        }
    total_rows = sum(p["rows_per_query"] for p in phases.values())
    total_bytes = sum(p["bytes_per_query"] for p in phases.values())
    if total_rows == 0:
        # kmer_len == seed_k count: the seed table answers everything
        return {
            "chip": chip.name,
            "calibrated": calibrated,
            "rows_per_query": 0.0,
            "bytes_per_query": 0.0,
            "gather_ceiling_qps": None,
            "hbm_speed_of_light_qps": None,
            "fraction_of_gather_ceiling": None,
            "fraction_of_hbm_sol": None,
        }
    sol_qps = chip.hbm_gbps * 1e9 / total_bytes if chip.hbm_gbps else None
    out = {
        "chip": chip.name,
        "calibrated": calibrated,
        "rates_rows_per_sec": (
            {t: round(r) for t, r in rates.items() if t in row_bytes}
            if calibrated else None
        ),
        "rows_per_query": round(total_rows, 2),
        "bytes_per_query": round(total_bytes, 1),
        "gather_ceiling_qps": None,
        "hbm_speed_of_light_qps": round(sol_qps) if sol_qps else None,
        "fraction_of_gather_ceiling": None,
        "fraction_of_hbm_sol": (
            round(queries_per_sec / sol_qps, 4) if sol_qps else None
        ),
    }
    if calibrated:
        total_secs = sum(p["gather_seconds_per_query"] for p in phases.values())
        ceiling_qps = 1.0 / total_secs
        out["gather_ceiling_qps"] = round(ceiling_qps)
        out["fraction_of_gather_ceiling"] = round(queries_per_sec / ceiling_qps, 4)
    out["phases"] = {
        name: {
            "rows_per_query": p["rows_per_query"],
            "bytes_per_query": p["bytes_per_query"],
            "l2_held": p["l2_held"],
            "share_of_gather_time": (
                round(p["gather_seconds_per_query"] / total_secs, 3)
                if calibrated else None
            ),
        }
        for name, p in phases.items()
    }
    return out


# ---------------------------------------------------------------------------
# In-process calibration of the row rates
# ---------------------------------------------------------------------------

SLAB_ROWS = 8192  # the L2-resident slab: 8192 x 512 B = 4 MiB (P5's largest)


def difference_rate(run, lanes: int, runs: int, seg_lo: int, seg_hi: int) -> float:
    """Rows/s of a dependent walk, from the median time of a seg_hi-step
    walk less that of a seg_lo-step walk (interleaved runs), so the
    fixed cost of a launch and a readback cancels."""
    run(seg_lo)  # build + warm both
    run(seg_hi)
    lo_times, hi_times = [], []
    for _ in range(runs):
        t0 = time.perf_counter()
        run(seg_lo)
        lo_times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        run(seg_hi)
        hi_times.append(time.perf_counter() - t0)
    dt = float(np.median(hi_times)) - float(np.median(lo_times))
    if dt <= 0:  # noise floor: fall back to the raw hi-walk rate
        return lanes * seg_hi / float(np.median(hi_times))
    return lanes * (seg_hi - seg_lo) / dt


def calibrate_gather_rates(
    tables, batch: int, *, device, runs: int = 3, seg_lo: int = 4, seg_hi: int = 20,
    log=None, sector_masks: Optional[Dict[str, int]] = None, lanes: int = 1,
) -> Dict[str, float]:
    """Measured random row-read rate of each table (rows/s), plus the
    L2-resident slab rate under ``"slab"``. ``sector_masks``: per table,
    the 32 B sectors of a row that a visit reads and sums (K5's masked
    walk; :func:`first_block_visits`); a table without one is walked over
    whole rows, as ``bench.py`` walks it. ``lanes``: lanes a chain of the
    walk (1, as ``bench.py``; 4 for the ceiling of an L2-resident table,
    whose rate the rows a warp's load instruction touches set).

    The walk is ``bench.py``'s: each of ``batch`` lanes reads the row at
    its index and moves to ``(idx * 1103515245 + sum of the row's bytes
    + 12345) mod nb`` (u32), so every step depends on the last and every
    row byte is used. On the card all ``seg`` steps run in one launch of
    K5's walk entry, one chain per lane. The slab rate is K6's chained
    gather (P5's ``idx <- (row[0] + row[37]) mod S``) over a (8192, 128)
    u32 slab, with the same ``batch`` lanes: P5's own 8192 lanes finish
    a 16-step difference in microseconds, below what a host clock
    resolves. Host clock around each walk plus a one-value readback,
    seg_hi - seg_lo differenced.
    """
    import torch

    from ..models.index import as_device
    from ..ops import probes

    device = as_device(device)
    rng = np.random.default_rng(99)
    rates: Dict[str, float] = {}
    for name, table in tables.items():
        if table is None:
            continue
        nb = table.shape[0]
        idx0 = torch.from_numpy(rng.integers(0, nb, size=batch).astype(np.int32)).to(device)

        mask = (sector_masks or {}).get(name, probes.ALL_SECTORS)

        def run(seg, table=table, idx0=idx0, mask=mask):
            return int(probes.gather_walk(table, idx0, seg, mask, lanes)[0])  # the readback syncs

        rates[name] = difference_rate(run, batch, runs, seg_lo, seg_hi)
        if log:
            read = len(probes.sector_columns(table.shape[1], mask))
            log(f"calib {name}: {rates[name] / 1e6:.1f}M rows/s "
                f"({read} B read of a {table.shape[1]} B row, {nb} rows, {lanes} lane(s) a chain)")
    slab = torch.from_numpy(
        rng.integers(0, 2**32, size=(SLAB_ROWS, probes.SLAB_LANES), dtype=np.uint32).view(np.int32)
    ).to(device)
    sidx0 = torch.from_numpy(rng.integers(0, SLAB_ROWS, size=batch).astype(np.int32)).to(device)

    def run_slab(seg):
        return int(probes.slab_chain(slab, sidx0, seg)[0])

    rates["slab"] = difference_rate(run_slab, batch, runs, seg_lo, seg_hi)
    if log:
        log(f"calib slab: {rates['slab'] / 1e6:.1f}M rows/s "
            f"({SLAB_ROWS} x 512 B, L2-resident, {batch} lanes)")
    return rates

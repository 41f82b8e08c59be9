"""Range-sharded search: the block rows split by block range over devices.

Counterpart of ``avxwindowfmindex_tpu/parallel/range_sharded.py``. The
query-parallel engine (dist.py) needs the whole index on every device.
When the index outgrows one card, the block rows are instead PARTITIONED
by contiguous block range: shard i of n holds global blocks ``i * bps ..
(i + 1) * bps - 1`` (``bps = ceil(num_blocks / n)``, the last shard
padded with zero rows), and the sampled SA is split the same way by
sample index (``sps = ceil(num_samples / n)``, zero samples as padding).
The prefix sums, seed table, code masks and letter tables are small and
are replicated, once per distinct device: a list that names a device
twice holds one seed table.

Every step is then routed, not summed: a route on ``devices[0]`` (the
home device: queries, ranges and hits live there) hands each position of
the step once to the shard that owns its block, which follows from the
position alone, and that shard computes the step's whole value for it
and stores it at the lane's place in the step's output (ops/sharded.py;
on the card the route and K1R over narrow block rows, K1Rw over the
compact wide rows). A backward step routes the 2B positions ``start - 1
|| end`` and each shard counts its own; a locate walks LF, the route
taking the done rule (a lane at a sample is not routed) and each owner
forming the LF itself, until every lane is at a sample, then gathers
each sample from the shard that holds it. Each shard launches on its
own device after the route: a shard on the home device on its current
stream, where it reads its slice as the route wrote it, the route's
counts staying on the card; a shard on another device on a
``torch.cuda.Stream`` of its own, with its slice copied to it and its
results copied back and scattered by lane, so only for such a shard are
the counts read back, once a step. Answers equal ``SearchEngine``'s bit
for bit.

What does not carry over: ``shard_map`` and ``psum`` (the route and
per-shard launches that each store their lanes' values), the fixed trip
count of the JAX backtrace segment and its compaction helpers
(``_gather_undone_rs``, ``_undone_count64_rs``, ``_gather_undone64_rs``,
``_scatter_back64_rs``), ``_dev_specs`` and the hi/lo u32 splits: wide
positions are int64 here. The backtrace compacts its lanes with torch
ops every ``segment`` steps, reading back one count. A step's lanes are
indexed in int32, so a batch holds fewer than 2^31 positions (a count of
at most 2^30 - 1 queries).

This trades throughput for capacity (every step is a route and a launch
a shard); use ``SearchEngine`` or the query-parallel engine when the
index fits one card.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..models import alphabet as alpha
from ..models.config import AlphabetType
from ..models.index import (
    DeviceIndex,
    FmIndex,
    device_code_masks,
    pack_device_blocks,
    pack_device_blocks64,
    u32_tensor,
    u64_tensor,
)
from ..ops import rank as rank_ops
from ..ops import sharded
from ..search import SearchEngine, initial_ranges, step_letters
from .dist import make_query_mesh


def make_index_mesh(num_devices: Optional[int] = None, devices=None) -> List[torch.device]:
    """The devices the block rows are split over: ``devices`` (names or
    ``torch.device``s, a device named twice holding two shards), else
    every visible CUDA device, the first ``num_devices`` of them. Without
    CUDA the default raises; pass ``devices=["cpu"] * n`` to run the
    plain versions."""
    return make_query_mesh(num_devices, devices)


class RangeShardedSearchEngine(SearchEngine):
    """count/locate with the block rows range-sharded over ``devices``.

    The search semantics and results are the single-device engine's;
    only the storage and the rank's assembly differ. ``devices`` defaults
    to every visible card. ``wide`` picks the 64-bit layout (compact
    wide rows), by default for bwtLength >= 2^32.

    ``shards``: one view a shard (its block rows and samples, the
    replicated tables of its device); ``dev``: the home shard's view,
    whose replicated tables the ranges use; ``first_blocks`` and
    ``first_samples``: each shard's global offsets; ``copied_shards``:
    the shards on another device than the home one, whose slices are
    copied; ``last_backtrace``: the LF loop's segments, steps, lanes,
    routed lanes and K1R launches of the last locate.
    """

    def __init__(self, index: FmIndex, devices=None, wide: Optional[bool] = None):
        self.devices = make_index_mesh(devices=devices)
        self.n_dev = len(self.devices)
        self.device = self.devices[0]
        self.host_index = index
        if index.sampled_sa is None:
            raise ValueError(
                "range-sharded search requires the sampled suffix array in "
                "memory (load with keep_suffix_array_in_memory=True)"
            )
        bwt_length = int(index.bwt_length)
        self.wide = bool(wide if wide is not None else bwt_length >= 2**32)
        if not self.wide and bwt_length >= 2**32:
            # an explicit wide=False must not truncate positions to u32
            raise ValueError(
                "bwtLength >= 2**32 requires the 64-bit layout "
                "(wide=True, chosen automatically)"
            )
        ratio = int(index.config.suffix_array_compression_ratio)
        if self.wide:
            if index.num_blocks >= 2**31:
                raise ValueError(
                    "device block index rides int32 gathers: bwtLength "
                    "must be < 2^39 positions (~550 G bases)"
                )
            if bwt_length // ratio >= 2**31:
                raise ValueError(
                    "sampled-SA gather index must fit int32: need "
                    "bwtLength / saCompressionRatio < 2^31"
                )
        self._ascii_lut = (
            alpha.AA_ASCII_TO_INDEX
            if index.alphabet == AlphabetType.AMINO
            else alpha.NT_ASCII_TO_INDEX
        )

        # the shards are cut on the host: this engine exists for indexes
        # that do not fit one card, so the rows never pass through one
        if self.wide:
            rows = pack_device_blocks64(
                index.bwt_letters, index.milestones(), index.alphabet, pair=False
            )
        else:
            rows = pack_device_blocks(index.bwt_letters, index.milestones(), index.alphabet)
        nb = rows.shape[0]
        self.blocks_per_shard = -(-nb // self.n_dev)
        padded = np.zeros((self.blocks_per_shard * self.n_dev, rows.shape[1]), dtype=np.uint8)
        padded[:nb] = rows
        del rows
        n_samples = len(index.sampled_sa)
        self.samples_per_shard = -(-n_samples // self.n_dev)
        sa = np.zeros(self.samples_per_shard * self.n_dev, dtype=np.uint64)
        sa[:n_samples] = index.sampled_sa
        as_table = u64_tensor if self.wide else u32_tensor

        tables = {}  # device -> its replicated tables
        for d in self.devices:
            if d in tables:
                continue
            seed = index.seed_table_tensor(d, self.wide)
            if seed is None:
                raise ValueError("index has no seed table (not yet built)")
            tables[d] = dict(
                prefix_sums=as_table(index.prefix_sums, d),
                seed_table=seed,
                code_masks=torch.from_numpy(device_code_masks(index.alphabet)).to(d),
                vec_to_index=torch.from_numpy(
                    alpha.vector_to_index_lut(index.alphabet).astype(np.int32)
                ).to(d),
            )
        bps, sps = self.blocks_per_shard, self.samples_per_shard
        self.first_blocks = [i * bps for i in range(self.n_dev)]
        self.first_samples = [i * sps for i in range(self.n_dev)]
        self.shards = [
            DeviceIndex(
                packed=torch.from_numpy(padded[i * bps : (i + 1) * bps]).to(d),
                packed_pair=None,
                sampled_sa=as_table(sa[i * sps : (i + 1) * sps], d),
                bwt_length=bwt_length,
                ratio=ratio,
                kmer_length_in_seed_table=int(index.config.kmer_length_in_seed_table),
                alphabet=index.alphabet,
                wide=self.wide,
                pair_fused=not self.wide,
                shard=True,
                **tables[d],
            )
            for i, d in enumerate(self.devices)
        ]
        self.dev = self.shards[0]
        self.copied_shards = frozenset(
            i for i, d in enumerate(self.devices) if d != self.device)
        # a stream for each shard on another card, so that the cards run at
        # once; the shards on the home device launch on its current stream,
        # after the route (a stream each measured host-bound: PERF.md §6)
        self.streams = [
            torch.cuda.Stream(device=d) if d.type == "cuda" and d != self.device else None
            for d in self.devices
        ]
        # what an LF step gives a lane no shard owns: letter 0 and
        # lf_from_letter_occ(0, 0), as the JAX engine's psum of zeros
        zero = torch.zeros(1, dtype=torch.int64)
        home = dataclasses.replace(self.dev, prefix_sums=self.dev.prefix_sums.cpu())
        self.lf_unowned = int(rank_ops.lf_from_letter_occ(home, zero, zero)[0])
        # LF steps a segment of the backtrace between two compactions
        self.segment = min(64, max(4, ratio))
        self.last_backtrace = {}

    # -- the shards ---------------------------------------------------------

    @contextlib.contextmanager
    def _on_stream(self, i: int, *tensors):
        """Copied shard i's work on its own stream, after the current stream
        of its device (which wrote the inputs); ``tensors`` are recorded on
        it."""
        stream = self.streams[i]
        if stream is None:
            yield
            return
        stream.wait_stream(torch.cuda.current_stream(self.devices[i]))
        for t in tensors:
            if t is not None:
                t.record_stream(stream)
        with torch.cuda.stream(stream):
            yield

    def _step(self, pos: torch.Tensor, out: torch.Tensor, *, occ_letters=None,
              ratio: int = 0, off=None, letters=None, counts=None) -> int:
        """One routed step over the positions ``pos`` (int64, on the home
        device): occ mode with ``occ_letters`` (out[i] = occ(occ_letters[i],
        pos[i])), else LF mode (out[i] = LF(pos[i]), ``out`` may be ``pos``;
        ``letters`` gets the letter; ``ratio`` > 0: the done rule, with
        ``off`` + 1 for every lane stepped). ``counts`` ((n + 1,) int32)
        receives the route's totals. Returns the shard launches made."""
        n = self.n_dev
        if counts is None:
            counts = torch.empty(n + 1, dtype=torch.int32, device=self.device)
        lf_mode = occ_letters is None
        slot_pos, slot_lane = sharded.route(
            pos, out, n, self.blocks_per_shard, self.wide, self.lf_unowned if lf_mode else 0,
            counts, ratio, off, letters)
        # one readback a step, and only when a shard is on another device
        sizes = counts.tolist() if self.copied_shards else None
        launched, copied = 0, []
        for i, shard in enumerate(self.shards):
            fb = self.first_blocks[i]
            if i not in self.copied_shards:
                if lf_mode:
                    sharded.shard_lf(shard, fb, slot_pos, slot_lane, counts, i, out, letters)
                else:
                    sharded.shard_occurrence(shard, fb, slot_pos, slot_lane, counts, i,
                                             occ_letters, out)
                launched += 1
                continue
            c = sizes[i]
            if c == 0:
                continue
            begin = sum(sizes[:i])
            lanes = slot_lane[begin : begin + c].to(torch.int64)
            part = slot_pos[begin : begin + c].to(shard.device)
            part_letters = None if lf_mode else occ_letters[lanes].to(shard.device)
            with self._on_stream(i, part, part_letters):
                res = torch.empty(c, dtype=torch.int64, device=shard.device)
                res_letters = None
                if lf_mode:
                    if letters is not None:
                        res_letters = torch.empty(c, dtype=torch.int32, device=shard.device)
                    sharded.shard_lf(shard, fb, part, None, None, i, res, res_letters, count=c)
                else:
                    sharded.shard_occurrence(shard, fb, part, None, None, i, part_letters, res,
                                             count=c)
            launched += 1
            copied.append((i, lanes, res, res_letters))
        for i, stream in enumerate(self.streams):
            if stream is not None:
                torch.cuda.current_stream(self.devices[i]).wait_stream(stream)
        for i, lanes, res, res_letters in copied:
            for t in (res, res_letters):
                if t is not None and self.streams[i] is not None:
                    t.record_stream(torch.cuda.current_stream(self.devices[i]))
            out.index_copy_(0, lanes, res.to(self.device))
            if res_letters is not None:
                letters.index_copy_(0, lanes, res_letters.to(self.device))
        return launched

    def occurrence(self, positions: torch.Tensor, letters: torch.Tensor) -> torch.Tensor:
        """occ(letter, position), each position counted by the shard that
        owns it and 0 where none does (positions wrapped to the position
        width, as the JAX engine's u32 lanes wrap)."""
        pos = (positions.to(torch.int64) & self.dev.pos_mask).contiguous()
        out = torch.empty_like(pos)
        self._step(pos, out, occ_letters=letters.to(torch.int32).contiguous())
        return out

    def letter_and_lf(self, positions: torch.Tensor):
        """(letter, LF) of each position, formed by the shard that owns it;
        (0, ``lf_unowned``) where none does."""
        lf = (positions.to(torch.int64) & self.dev.pos_mask).contiguous()
        lett = torch.empty(lf.shape, dtype=torch.int32, device=lf.device)
        self._step(lf, lf, letters=lett)
        return lett.to(torch.int64), lf

    # -- ranges -------------------------------------------------------------

    def _backward_step(self, start, end, letters, active):
        """One backward step, each rank counted by the shard that owns its
        position; only rows that are ``active`` and valid (start <= end)
        are updated."""
        dev = self.dev
        mask = dev.pos_mask
        b = start.shape[0]
        c = rank_ops._prefix_sum_select(dev, letters)
        occ = self.occurrence(torch.cat([start - 1, end]), torch.cat([letters, letters]))
        new_start = (c + occ[:b]) & mask
        new_end = (c + occ[b:] - 1) & mask
        keep = active & rank_ops.le_unsigned(start, end, self.wide)
        return torch.where(keep, new_start, start), torch.where(keep, new_end, end)

    def _run_ranges(self, mat: np.ndarray, lengths: np.ndarray, seeded: bool):
        """Final ranges of a batch that is all seeded or all unseeded:
        one step a letter, the longest query's count of them."""
        m = torch.from_numpy(mat).to(self.device).to(torch.int64)
        lens = torch.from_numpy(lengths).to(self.device).to(torch.int64)
        flags = torch.full(lens.shape, seeded, dtype=torch.bool, device=self.device)
        start, end, nxt = initial_ranges(self.dev, m, lens, flags)
        first = self.dev.kmer_length_in_seed_table if seeded else 1
        for t in range(int(lengths.max()) - first):
            p = nxt - t
            start, end = self._backward_step(start, end, step_letters(m, p), p >= 0)
        return start, end

    def _ranges_device(self, mat: np.ndarray, lengths: np.ndarray):
        """(start, end) on the home device. Seed-eligible and ineligible
        queries run as two batches, as in the JAX engine."""
        eligible = self._seed_eligibility(mat, lengths)
        if eligible.all() or not eligible.any():
            return self._run_ranges(mat, lengths, bool(eligible.all()))
        start = torch.empty(mat.shape[0], dtype=torch.int64, device=self.device)
        end = torch.empty_like(start)
        for sel, seeded in ((eligible, True), (~eligible, False)):
            idx = np.nonzero(sel)[0]
            s, e = self._run_ranges(mat[idx], lengths[idx], seeded)
            where = torch.from_numpy(idx).to(self.device)
            start[where] = s
            end[where] = e
        return start, end

    # -- locate -------------------------------------------------------------

    def backtrace(self, positions: torch.Tensor):
        """(p, off): each position walked with LF until p % ratio == 0.

        Runs ``segment`` LF steps on the lanes still walking, then reads
        back their count and keeps only those (a chain is longest at the
        tail, so the batch shrinks as it goes); every step is one route,
        which leaves a lane at a sample where it is, and one launch a
        shard over the lanes it owns. The route's totals of a segment are
        read once, at the end. A valid index ends every walk within
        bwtLength steps; past that the index is malformed and this
        raises."""
        dev = self.dev
        ratio = dev.ratio
        p_all = (positions.to(torch.int64) & dev.pos_mask).contiguous()
        off_all = torch.zeros_like(p_all)
        idx = torch.arange(p_all.shape[0], device=p_all.device)
        p, off = p_all, off_all
        stats = {"segments": 0, "lf_steps": 0, "lane_steps": 0, "routed_lanes": 0,
                 "launches": 0}
        routed = []
        while True:
            todo = torch.nonzero(p % ratio != 0)[:, 0]
            if stats["segments"]:
                p_all[idx] = p
                off_all[idx] = off
            if todo.numel() == 0:
                break
            if stats["lf_steps"] >= dev.bwt_length:
                raise RuntimeError("an LF walk outlasted bwtLength steps: malformed index")
            idx, p, off = idx[todo], p[todo].contiguous(), off[todo].contiguous()
            counts = torch.empty((self.segment, self.n_dev + 1), dtype=torch.int32,
                                 device=p.device)
            for k in range(self.segment):
                stats["launches"] += self._step(p, p, ratio=ratio, off=off, counts=counts[k])
            routed.append(counts[:, : self.n_dev])
            stats["segments"] += 1
            stats["lf_steps"] += self.segment
            stats["lane_steps"] += self.segment * int(todo.numel())
        per_step = torch.cat(routed).sum(dim=1).tolist() if routed else []
        stats["routed_lanes"] = int(sum(per_step))
        stats["routed_per_step"] = per_step
        self.last_backtrace = stats
        return p_all, off_all

    def _samples(self, p: torch.Tensor) -> torch.Tensor:
        """SA[p // ratio] of each position, gathered by the shard whose
        sample range holds it (0 where none does): torch ops, once a
        locate."""
        q = sharded._int32((p & self.dev.pos_mask) // self.dev.ratio)
        sps = self.samples_per_shard
        owner = torch.where((q >= 0) & (q < sps * self.n_dev), q // sps, -1)
        sa = torch.zeros_like(p)
        for i, shard in enumerate(self.shards):
            lanes = torch.nonzero(owner == i)[:, 0]
            if lanes.numel():
                got = sharded.local_samples(shard, p[lanes].to(shard.device),
                                            self.first_samples[i])
                sa[lanes] = got.to(self.device)
        return sa

    def _resolve(self, positions: torch.Tensor) -> np.ndarray:
        """Hits of BWT positions on the home device: the backtrace, then
        the samples, each from the shard that holds it, and the wrap-aware
        mod."""
        p, off = self.backtrace(positions)
        sa = self._samples(p)
        return sharded.resolve_hits(self.dev, sa, off).cpu().numpy().astype(np.uint64)

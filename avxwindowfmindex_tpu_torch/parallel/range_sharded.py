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

Every rank is then the sum of per-shard masked ranks: each shard gets
the whole position batch, answers for the positions whose block it owns
and gives 0 elsewhere (ops/sharded.py; K1R over narrow block rows, K1Rw
over the compact wide rows, on the card), and exactly one shard owns a
real position. Where the JAX engine runs the shards under ``shard_map``
and sums with ``psum``, here each shard launches on its own device and
its own ``torch.cuda.Stream``, and the partial results are copied to
``devices[0]`` (the home device: queries, ranges and hits live there)
and summed. A backward step launches K1R once a shard over the 2B
positions ``start - 1 || end``; a locate walks LF with one masked
(letter, occ) launch a shard and a step until every lane is at a
sample, then gathers the samples the same way. Answers equal
``SearchEngine``'s bit for bit.

What does not carry over: ``shard_map`` and ``psum`` (per-shard launches
and a sum on the home device), the fixed trip count of the JAX
backtrace segment and its compaction helpers (``_gather_undone_rs``,
``_undone_count64_rs``, ``_gather_undone64_rs``, ``_scatter_back64_rs``),
``_dev_specs`` and the hi/lo u32 splits: wide positions are int64 here.
The backtrace compacts its lanes with torch ops every ``segment`` steps,
reading back one count.

This trades throughput for capacity (every step is a launch a shard and
a sum); use ``SearchEngine`` or the query-parallel engine when the index
fits one card.
"""

from __future__ import annotations

import contextlib
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
    ``first_samples``: each shard's global offsets; ``last_backtrace``:
    the LF loop's segments, steps and K1R launches of the last locate.
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
                **tables[d],
            )
            for i, d in enumerate(self.devices)
        ]
        self.dev = self.shards[0]
        self.streams = [
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.devices
        ]
        # LF steps a segment of the backtrace between two compactions
        self.segment = min(64, max(4, ratio))
        self.last_backtrace = {}

    # -- the shards ---------------------------------------------------------

    def _on_shards(self, fn, *tensors: torch.Tensor) -> list:
        """The sum over the shards of ``fn(i, shard, *tensors)`` (a tuple of
        int64 tensors), on the home device. Each shard runs on its own
        stream, after the current stream of its device (which wrote the
        inputs); its outputs are ordered after that stream before the sum."""
        outs = []
        for i, (shard, stream) in enumerate(zip(self.shards, self.streams)):
            args = [t.to(shard.device) for t in tensors]
            ctx = contextlib.nullcontext()
            if stream is not None:
                stream.wait_stream(torch.cuda.current_stream(shard.device))
                for a in args:
                    a.record_stream(stream)
                ctx = torch.cuda.stream(stream)
            with ctx:
                outs.append(fn(i, shard, *args))
        total = None
        for out, shard, stream in zip(outs, self.shards, self.streams):
            if stream is not None:
                current = torch.cuda.current_stream(shard.device)
                current.wait_stream(stream)
                for t in out:
                    t.record_stream(current)
            out = [t.to(self.device) for t in out]
            total = out if total is None else [a + b for a, b in zip(total, out)]
        return total

    def occurrence(self, positions: torch.Tensor, letters: torch.Tensor) -> torch.Tensor:
        """occ(letter, position), summed over the shards' masked ranks
        (positions wrapped to the position width, as the JAX engine's u32
        lanes wrap)."""
        return self._on_shards(
            lambda i, shard, p, l: (sharded.occurrence(shard, p, l, self.first_blocks[i]),),
            positions.to(torch.int64) & self.dev.pos_mask, letters.to(torch.int64),
        )[0]

    def letter_and_lf(self, positions: torch.Tensor):
        """(letter, LF) of each position: the shards' masked (letter, occ)
        summed, then the LF formed from the sum."""
        lett, occ = self._on_shards(
            lambda i, shard, p: sharded.letter_occ(shard, p, self.first_blocks[i]),
            positions,
        )
        return lett, rank_ops.lf_from_letter_occ(self.dev, lett, occ)

    # -- ranges -------------------------------------------------------------

    def _backward_step(self, start, end, letters, active):
        """One backward step with the rank summed over the shards; only
        rows that are ``active`` and valid (start <= end) are updated."""
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
        tail, so the batch shrinks as it goes); every step is one masked
        (letter, occ) launch a shard and one sum. A valid index ends every
        walk within bwtLength steps; past that the index is malformed and
        this raises."""
        dev = self.dev
        ratio = dev.ratio
        p_all = positions.to(torch.int64) & dev.pos_mask
        off_all = torch.zeros_like(p_all)
        idx = torch.arange(p_all.shape[0], device=p_all.device)
        p, off = p_all, off_all
        stats = {"segments": 0, "lf_steps": 0, "lane_steps": 0, "launches": 0}
        while True:
            todo = torch.nonzero(p % ratio != 0)[:, 0]
            if stats["segments"]:
                p_all[idx] = p
                off_all[idx] = off
            if todo.numel() == 0:
                break
            if stats["lf_steps"] >= dev.bwt_length:
                raise RuntimeError("an LF walk outlasted bwtLength steps: malformed index")
            idx, p, off = idx[todo], p[todo], off[todo]
            for _ in range(self.segment):
                done = p % ratio == 0
                _, lf = self.letter_and_lf(p)
                p = torch.where(done, p, lf)
                off = torch.where(done, off, off + 1)
            stats["segments"] += 1
            stats["lf_steps"] += self.segment
            stats["lane_steps"] += self.segment * int(todo.numel())
            stats["launches"] += self.segment * self.n_dev
        self.last_backtrace = stats
        return p_all, off_all

    def _resolve(self, positions: torch.Tensor) -> np.ndarray:
        """Hits of BWT positions on the home device: the backtrace, then
        the samples gathered from the shard that holds each one, summed,
        and the wrap-aware mod."""
        p, off = self.backtrace(positions)
        sa = self._on_shards(
            lambda i, shard, q: (sharded.local_samples(shard, q, self.first_samples[i]),), p
        )[0]
        return sharded.resolve_hits(self.dev, sa, off).cpu().numpy().astype(np.uint64)

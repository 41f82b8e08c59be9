"""Query-parallel search over a list of devices.

Counterpart of ``avxwindowfmindex_tpu/parallel/dist.py``. The JAX engine
replicates the index over a 1-D ``shard_map`` mesh and shards the query
batch over it. Here the "mesh" is a list of ``torch.device``s in one
process:

  - the index is REPLICATED: one view per distinct device, made by
    moving the tensors of one view (a list that names a device twice
    shares one view);
  - the padded batch is split into ``len(devices)`` contiguous parts,
    and each part runs K2 (then the enumerate and K3 for locate) on its
    device's view, on its own ``torch.cuda.Stream``, so parts on one card
    overlap; no range leaves its device;
  - the results are joined in part order; ``count_replicated`` copies
    the counts to every device in place of the ``all_gather``.

Narrow and wide views (positions >= 2^32, or ``to_device(wide=True)``)
run through the same body: the JAX file's hi/lo ``*64`` twins fold into
the port's int64 positions. Results equal ``SearchEngine``'s bit for bit.

Multi-process: the JAX engine runs under ``jax.distributed``, each
process feeding its process-local slice of the global batch. Here the
processes form a ``torch.distributed`` world (``init_process_group``:
gloo for a CPU rank, NCCL for a card unless the caller names gloo), each
rank runs its contiguous slice ``[r*B//W, (r+1)*B//W)`` through a
``DistributedSearchEngine`` over its own device list, and
``count_allgather`` / ``resolve_allgather`` merge the ranks' counts or
hits with a tiled all-gather (``process_allgather``), so every rank ends
with the whole batch's answers in global order. ``spawn_ranks`` starts
the ranks of one world as processes and waits for them.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..models.index import DeviceIndex, FmIndex, resolve_device
from ..search import (
    SearchEngine,
    _round_up,
    _round_up_pow2,
    backtrace_resolve,
    enumerate_range_positions,
    range_counts,
    search_ranges,
)
from ..utils import metrics


def make_query_mesh(num_devices: Optional[int] = None, devices=None) -> List[torch.device]:
    """The devices of the query-parallel axis: ``devices`` (names or
    ``torch.device``s), else every visible CUDA device, the first
    ``num_devices`` of them. Without CUDA the default raises; pass
    ``devices=["cpu"] * n`` to run the plain versions."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "torch.cuda.is_available() is False; pass devices= explicitly "
                "(e.g. ['cpu'] * n) to run the plain versions"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    else:
        devs = [resolve_device(d) for d in devices]
    if num_devices is not None:
        devs = devs[:num_devices]
    if not devs:
        raise ValueError("a query mesh needs at least one device")
    return devs


def init_process_group(world_size: int, rank: int, init_method: str, device,
                       backend: Optional[str] = None) -> str:
    """Join rank ``rank`` of a ``world_size``-process ``torch.distributed``
    world that meets at ``init_method`` (``"tcp://127.0.0.1:<port>"`` or
    ``"file://<path>"``); returns the backend. ``backend=None`` follows
    ``device``: gloo for the CPU, NCCL for a card (made the process's
    current device). Any other pairing is the caller's to name, e.g. gloo
    for ranks that share one card, whose collectives then pass through
    host memory. NCCL where it is not available raises: nothing falls
    back to gloo."""
    device = resolve_device(device)
    if backend is None:
        backend = "gloo" if device.type == "cpu" else "nccl"
    if backend == "nccl":
        if not torch.distributed.is_nccl_available():
            raise RuntimeError("torch.distributed.is_nccl_available() is False: no nccl backend")
        if device.type != "cuda":
            raise ValueError(f"the nccl backend needs a CUDA device, not {device}")
    elif backend != "gloo":
        raise ValueError(f"backend must be 'gloo', 'nccl' or None, not {backend!r}")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    torch.distributed.init_process_group(
        backend, init_method=init_method, world_size=world_size, rank=rank)
    return backend


def process_allgather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' equal-length tensors ``t`` joined along dim 0 in rank
    order (``multihost_utils.process_allgather(tiled=True)``). Over gloo a
    CUDA tensor is staged through host memory, where gloo's collectives
    run; the result lies on ``t``'s device."""
    staged = t.cpu() if t.is_cuda and torch.distributed.get_backend(group) == "gloo" else t
    staged = staged.contiguous()
    parts = [torch.empty_like(staged) for _ in range(torch.distributed.get_world_size(group))]
    torch.distributed.all_gather(parts, staged, group=group)
    return torch.cat(parts).to(t.device)


def spawn_ranks(cmd: Sequence[str], world_size: int, timeout: float, env=None) -> List[str]:
    """Run ``cmd + [str(rank)]`` for every rank of a world at once, on
    this host, and return each rank's output (stdout and stderr). A rank
    that exits nonzero, or is still running ``timeout`` seconds after the
    start, raises RuntimeError once every rank still running is killed by
    its PID."""
    # the ranks share this host: gloo meets over the loopback interface
    env = dict(os.environ if env is None else env)
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = [
        subprocess.Popen([*cmd, str(r)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         env=env, text=True)
        for r in range(world_size)
    ]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for r, p in enumerate(procs):
            try:
                outs.append(p.communicate(timeout=max(0.0, deadline - time.monotonic()))[0])
            except subprocess.TimeoutExpired:
                raise RuntimeError(f"rank {r} of {world_size} outlasted {timeout}s") from None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} of {world_size} exited {p.returncode}:\n{out}")
    return outs


def replicate_index(view: DeviceIndex, device: torch.device) -> DeviceIndex:
    """``view`` with every tensor moved to ``device``; tensors that one
    view shares (the wide view's one row table) stay shared."""
    if view.device == device:
        return view
    moved = {}
    for field in dataclasses.fields(view):
        t = getattr(view, field.name)
        if isinstance(t, torch.Tensor):
            same = next((moved[f] for f in moved if getattr(view, f) is t), None)
            moved[field.name] = same if same is not None else t.to(device)
    return dataclasses.replace(view, **moved)


class DistributedSearchEngine(SearchEngine):
    """Query-data-parallel search over a list of devices.

    Same API as :class:`SearchEngine`; batches are padded to a multiple
    of the device count and split into contiguous parts, one a device;
    the index is replicated once at construction. ``index`` is an
    ``FmIndex`` (its view on ``devices[0]``) or a ``DeviceIndex``,
    narrow or wide; ``devices`` defaults to every visible card.
    """

    def __init__(self, index: Union[FmIndex, DeviceIndex], devices=None):
        self.devices = make_query_mesh(devices=devices)
        home = index.device if isinstance(index, DeviceIndex) else self.devices[0]
        super().__init__(index, device=home)
        self.n_dev = len(self.devices)
        views = {self.dev.device: self.dev}
        for d in self.devices:
            if d not in views:
                views[d] = replicate_index(self.dev, d)
        self.replicas = [views[d] for d in self.devices]
        self.streams = [
            torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in self.devices
        ]
        # device -> the whole counts vector of the last count_replicated
        self.replicated_counts = {}

    # batch padding must be divisible by the device count
    def _pad_batch(self, n: int) -> int:
        return _round_up(_round_up_pow2(n), self.n_dev)

    def _launch(self, fn, *arrays: np.ndarray) -> list:
        """``fn(view, *parts)`` for each device's contiguous part of the
        host ``arrays`` (leading dimension divisible by the device count),
        each uploaded and run on the part's stream; the outputs are
        ordered after that stream on the device's current stream."""
        size = arrays[0].shape[0] // self.n_dev
        outs = []
        for i, (view, stream) in enumerate(zip(self.replicas, self.streams)):
            ctx = contextlib.nullcontext()
            if stream is not None:
                # the replicated tables were written on the current stream
                stream.wait_stream(torch.cuda.current_stream(view.device))
                ctx = torch.cuda.stream(stream)
            with ctx:
                parts = [torch.from_numpy(a[i * size : (i + 1) * size]).to(view.device)
                         for a in arrays]
                outs.append(fn(view, *parts))
        for out, view, stream in zip(outs, self.replicas, self.streams):
            if stream is not None:
                current = torch.cuda.current_stream(view.device)
                current.wait_stream(stream)
                for t in out if isinstance(out, tuple) else (out,):
                    t.record_stream(current)
        return outs

    def _pad_encoded(self, mat: np.ndarray, lengths: np.ndarray):
        """The encoded batch padded to a multiple of the device count, with
        K2's per-query seed flag: seed-eligible and ineligible queries
        share one launch a part, as in ``SearchEngine._ranges_device``."""
        b_pad = self._pad_batch(mat.shape[0])
        if b_pad != mat.shape[0]:
            mat = np.pad(mat, ((0, b_pad - mat.shape[0]), (0, 0)))
            # max real length keeps uniform batches uniform
            lengths = np.pad(lengths, (0, b_pad - len(lengths)),
                             constant_values=int(lengths.max()))
        seeded = self._seed_eligibility(mat, lengths).astype(np.uint8)
        return mat, lengths.astype(np.int32), seeded

    @staticmethod
    def _join(outs) -> np.ndarray:
        """The parts' outputs (one tensor each) joined in part order on
        the host."""
        return torch.cat([o.cpu() for o in outs]).numpy()

    def find_ranges_encoded(self, mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Final BWT ranges -> (B, 2) uint64, one K2 launch a part."""
        outs = self._launch(
            lambda view, m, l, f: torch.stack(search_ranges(view, m, l, f), dim=1),
            *self._pad_encoded(mat, lengths),
        )
        return self._join(outs)[: mat.shape[0]].astype(np.uint64)

    def _count_parts(self, mat: np.ndarray, lengths: np.ndarray) -> list:
        """Each part's counts (K2, then the range lengths) on its device."""
        return self._launch(
            lambda view, m, l, f: range_counts(*search_ranges(view, m, l, f), view.wide),
            *self._pad_encoded(mat, lengths),
        )

    def count(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """Occurrences of each kmer (awFmParallelSearchCount parity)."""
        metrics.counter("search.count.queries").add(len(kmers))
        with metrics.timer("search.count.seconds"):
            mat, lengths, n = self.encode_kmers(kmers)
            return self._join(self._count_parts(mat, lengths))[:n].astype(np.uint64)

    def _locate_flat(self, kmers: Sequence[Union[str, bytes]]):
        """``locate``'s hits before the split. Each part runs K2, the
        enumerate and K3 on its own device; only the hits and the counts
        come back, joined in part order. With the suffix array on disk
        the packed-SA reads run on the host."""
        metrics.counter("search.locate.queries").add(len(kmers))
        with metrics.timer("search.locate.seconds"):
            mat, lengths, n = self.encode_kmers(kmers)
            mat, lengths, seeded = self._pad_encoded(mat, lengths)
            on_disk = self._sa_on_disk()
            real = np.arange(mat.shape[0]) < n

            def part(view, m, l, f, r):
                start, end = search_ranges(view, m, l, f)
                # pad rows enumerate nothing
                counts = torch.where(r, range_counts(start, end, view.wide), 0)
                out = backtrace_resolve(view, enumerate_range_positions(start, counts))
                return (*out, counts) if on_disk else (out, counts)

            outs = self._launch(part, mat, lengths, seeded, real)
            counts = self._join([o[-1] for o in outs])[:n]
            if on_disk:
                hits = self._resolve_from_file(
                    self._join([o[0] for o in outs]), self._join([o[1] for o in outs])
                )
            else:
                hits = self._join([o[0] for o in outs]).astype(np.uint64)
        metrics.counter("search.locate.hits").add(int(counts.sum()))
        return hits, counts

    def resolve_positions(self, bwt_positions: np.ndarray) -> np.ndarray:
        """Backtrace + resolve a flat array of BWT positions, split over
        the devices. With the suffix array on disk the walks still run on
        the devices and only the packed-SA reads run on the host
        (awFmGetSuffixArrayValueFromFile, AwFmFile.c:484-522)."""
        n = len(bwt_positions)
        if n == 0:
            return np.empty(0, dtype=np.uint64)
        on_disk = self._sa_on_disk()
        padded = np.zeros(self._pad_batch(n), dtype=np.int64)
        padded[:n] = np.asarray(bwt_positions).astype(np.uint64).view(np.int64)
        outs = self._launch(backtrace_resolve, padded)
        if on_disk:
            p = self._join([o[0] for o in outs])[:n]
            off = self._join([o[1] for o in outs])[:n]
            return self._resolve_from_file(p, off)
        return self._join(outs)[:n].astype(np.uint64)

    def count_replicated(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """Counts merged to every device: each part's counts are copied
        to every device of the list (the JAX engine's ``all_gather``).
        Every kmer must be seed-eligible."""
        mat, lengths, n = self.encode_kmers(kmers)
        if not self._seed_eligibility(mat, lengths).all():
            raise ValueError("count_replicated requires seed-eligible kmers")
        outs = self._count_parts(mat, lengths)
        self.replicated_counts = {
            d: torch.cat([c.to(d) for c in outs]) for d in dict.fromkeys(self.devices)
        }
        return self.replicated_counts[self.devices[0]][:n].cpu().numpy().astype(np.uint64)

    def _allgather_local(self, outs, n: int) -> np.ndarray:
        """This rank's parts (its first ``n`` rows) all-gathered with every
        other rank's, in rank order: the ranks' row counts first, then the
        rows padded to the longest count, the pad rows dropped after."""
        local = torch.cat([o.to(self.devices[0]) for o in outs])[:n]
        sizes = process_allgather(torch.tensor([n], device=local.device)).tolist()
        width = max(sizes)
        padded = torch.zeros(width, dtype=local.dtype, device=local.device)
        padded[:n] = local
        full = process_allgather(padded)
        merged = torch.cat([full[r * width : r * width + s] for r, s in enumerate(sizes)])
        return merged.cpu().numpy().view(np.uint64)

    def count_allgather(self, local_kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """This rank's slice of a global batch counted (K2, K2w on a wide
        view, one launch a part) and merged with every rank's by
        all-gather: each rank returns the whole batch's counts in global
        order (``_sharded_count_allgather_fn`` and its 64-bit twin). Every
        rank of the world calls it together."""
        mat, lengths, n = self.encode_kmers(local_kmers)
        return self._allgather_local(self._count_parts(mat, lengths), n)

    def resolve_allgather(self, local_positions: np.ndarray) -> np.ndarray:
        """This rank's slice of BWT positions backtraced and resolved (K3,
        K3w on a wide view) and merged with every rank's hits by
        all-gather (``_sharded_resolve_fn`` / ``_sharded_resolve64_fn``,
        then ``process_allgather``). Positions and hits are 64-bit. Needs
        the suffix array in memory; every rank calls it together."""
        if self._sa_on_disk():
            raise ValueError("resolve_allgather needs the suffix array in memory")
        n = len(local_positions)
        padded = np.zeros(self._pad_batch(n), dtype=np.int64)
        padded[:n] = np.asarray(local_positions).astype(np.uint64).view(np.int64)
        return self._allgather_local(self._launch(backtrace_resolve, padded), n)

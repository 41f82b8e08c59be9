"""Batched k-mer seed-table construction (BFS with unconditional steps).

Counterpart of ``avxwindowfmindex_tpu/ops/seed_table.py:49-119`` and,
for a wide view, of ``search64.py:build_seed_table_device64``. The
reference fills the |A|^k memoized ranges depth-first
(AwFmCreate.c:407-450); this builds the same recurrence breadth-first:
at depth d every one of the |A|^d ranges is stepped by every letter,
giving ``new_index = letter * |A|^d + old_index``. Steps are
unconditional (``backward_step(check_valid=False)``), so absent k-mers
keep the stepped-through ``start > end`` values the reference stores
and the ``.awfmi`` bytes depend on.

One depth is :func:`extend_level`: on the card one launch of K1X (K1WX
for a wide view, ``ops/kernels.py:k1_extend``), which reads each parent
range once, counts every letter at one position a parent (a level's
ranges are consecutive pieces of the BWT, so a parent's ``start - 1`` is
its neighbour's ``end``) and writes the children in place; for a CPU
table its plain version, :func:`extend_level_plain`. That one steps the
level in chunks of ``chunk`` ranges per letter, written straight into
the next level's (n, 2) table, so the temporaries stay a few hundred MB
even at k = 14 (4^14 ranges, a 2.1 GiB table; 4.3 GiB of int64 pairs
for a wide view).

On the card :func:`build_seed_table` takes the BFS mode first
(``kernels.k1_seed_table``): the depth-1 ranges and every depth whose
parents number at most the form's ``BFS_MAX_PARENTS`` in one cooperative
launch (:func:`bfs_depths`), then one :func:`extend_level` a depth for the
rest. A small table's depths hold a few thousand parents, and one launch
a depth left the card waiting on the host's work for each (the table's
upload, the wrapper, the launch); the BFS mode's plain version is the
plain loop of a CPU view.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.index import u32_tensor, u64_tensor
from . import rank as rank_ops

CHUNK = 1 << 22
# The parents a depth may hold to go into the BFS mode's one launch, by
# the form of K1X a view takes (``kernels.form_of``). Set by
# ``tools.kernel_ab --cases bfs`` (PERF.md section 6).
BFS_MAX_PARENTS = {"k1_extend": 1 << 18, "k1w_extend": 1 << 18, "k1w_extend_compact": 1 << 22}


def bfs_depths(card: int, k: int, max_parents: int) -> int:
    """How many depths of a k-mer BFS over ``card`` letters go into the BFS
    mode's one launch: depths 1 .. s, the leading ones whose ``card**d``
    parents number at most ``max_parents`` (a BFS has k - 1 depths). The
    launch forms the depth-1 ranges even when s is 0."""
    s = 0
    while s + 1 < k and card ** (s + 1) <= max_parents:
        s += 1
    return s


def bfs_max_parents(dev) -> int:
    """``BFS_MAX_PARENTS`` of the form of K1X that ``dev`` takes."""
    from . import kernels

    return BFS_MAX_PARENTS[kernels.form_of(dev, kernels.K1X).name]


def bfs_launches(dev, k: int) -> int:
    """Kernel launches of :func:`build_seed_table` on the card: one for the
    BFS mode and one for each depth past it."""
    return 1 + (k - 1 - bfs_depths(dev.cardinality, k, bfs_max_parents(dev)))


def extend_level_plain(dev, table: torch.Tensor, occurrence_fn=rank_ops.occurrence_plain,
                       chunk: int = CHUNK) -> torch.Tensor:
    """One BFS depth in plain torch: the (card * n, 2) children of the
    (n, 2) parent ranges ``table`` (the view's storage type), child
    ``letter * n + i`` = ``backward_step(check_valid=False)`` of parent
    i by the letter. ``occurrence_fn`` is passed to ``backward_step``
    (``rank_ops.occurrence`` takes K1's occ mode on the card)."""
    card = dev.cardinality
    n = table.shape[0]
    nxt = torch.empty((card * n, 2), dtype=table.dtype, device=table.device)
    for lo in range(0, n, chunk):
        hi = min(lo + chunk, n)
        start = dev.widen(table[lo:hi, 0])
        end = dev.widen(table[lo:hi, 1])
        for lett in range(card):
            letters = torch.full((hi - lo,), lett, dtype=torch.int64, device=table.device)
            s, e = rank_ops.backward_step(
                dev, start, end, letters, check_valid=False, occurrence_fn=occurrence_fn,
            )
            nxt[lett * n + lo : lett * n + hi, 0] = dev.store(s)
            nxt[lett * n + lo : lett * n + hi, 1] = dev.store(e)
    return nxt


def extend_level(dev, table: torch.Tensor, chunk: int = CHUNK) -> torch.Tensor:
    """One BFS depth: K1X (K1WX for a wide view) for a CUDA table, the
    plain version, in chunks of ``chunk``, for a CPU one."""
    if rank_ops.device_kind(table) == "cuda":
        from . import kernels

        return kernels.k1_extend(dev, table)
    return extend_level_plain(dev, table, chunk=chunk)


def build_seed_table(dev, cardinality: int, k: int, prefix_sums_host,
                     occurrence_fn=None, chunk: int = CHUNK) -> torch.Tensor:
    """The (|A|^k, 2) seed table on dev's device, in the view's storage
    type: u32 in an int32 tensor, or u64 in an int64 tensor (wide).

    Depth-1 ranges come from the prefix sums (AwFmCreate.c:410-413):
    table1[i] = [C[i], C[i+1]-1]. On the card the BFS mode forms them from
    the view's own C[] (the same values) and steps the depths that
    :func:`bfs_depths` gives under the form's ``BFS_MAX_PARENTS`` in one
    launch, then one :func:`extend_level` a depth. A CPU view, or an
    ``occurrence_fn``, takes the host's depth-1 table and one
    :func:`extend_level` a depth
    (``rank_ops.occurrence_plain``: the plain BFS on any device, the
    yardstick of the kernels).
    """
    total = cardinality**k
    if total >= 2**31:
        raise NotImplementedError(
            f"seed table with |A|^k = {total} exceeds the int32 index "
            "range; use a smaller kmerLengthInSeedTable"
        )
    if occurrence_fn is None and rank_ops.device_kind(dev.packed) == "cuda":
        from . import kernels

        if cardinality != dev.cardinality:
            raise ValueError(f"the view has {dev.cardinality} letters, not {cardinality}")
        steps = bfs_depths(cardinality, k, bfs_max_parents(dev))
        table = kernels.k1_seed_table(dev, steps + 1)
        for _depth in range(steps + 1, k):
            table = kernels.k1_extend(dev, table)
        return table
    ps = np.asarray(prefix_sums_host, dtype=np.uint64)
    table = (u64_tensor if dev.wide else u32_tensor)(
        np.stack([ps[:cardinality], ps[1 : cardinality + 1] - 1], axis=1),
        dev.device,
    )
    for _depth in range(1, k):
        if occurrence_fn is None:
            table = extend_level(dev, table, chunk)
        else:
            table = extend_level_plain(dev, table, occurrence_fn, chunk)
    return table

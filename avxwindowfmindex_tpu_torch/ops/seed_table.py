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

Each depth is stepped in chunks of ``chunk`` ranges per letter, written
straight into the next level's (n, 2) table, so the temporaries stay a
few hundred MB even at k = 14 (4^14 ranges, a 2.1 GiB table; 4.3 GiB
of int64 pairs for a wide view).
"""

from __future__ import annotations

import numpy as np
import torch

from ..models.index import u32_tensor, u64_tensor
from . import rank as rank_ops

CHUNK = 1 << 22


def build_seed_table(dev, cardinality: int, k: int, prefix_sums_host,
                     occurrence_fn=None, chunk: int = CHUNK) -> torch.Tensor:
    """The (|A|^k, 2) seed table on dev's device, in the view's storage
    type: u32 in an int32 tensor, or u64 in an int64 tensor (wide).

    Depth-1 ranges come from the prefix sums (AwFmCreate.c:410-413):
    table1[i] = [C[i], C[i+1]-1]. ``occurrence_fn`` is passed to
    ``backward_step`` (default: the K1 / K1w dispatch wrapper).
    """
    total = cardinality**k
    if total >= 2**31:
        raise NotImplementedError(
            f"seed table with |A|^k = {total} exceeds the int32 index "
            "range; use a smaller kmerLengthInSeedTable"
        )
    ps = np.asarray(prefix_sums_host, dtype=np.uint64)
    table = (u64_tensor if dev.wide else u32_tensor)(
        np.stack([ps[:cardinality], ps[1 : cardinality + 1] - 1], axis=1),
        dev.device,
    )
    for _depth in range(1, k):
        n = table.shape[0]
        nxt = torch.empty((cardinality * n, 2), dtype=table.dtype, device=dev.device)
        for lo in range(0, n, chunk):
            hi = min(lo + chunk, n)
            start = dev.widen(table[lo:hi, 0])
            end = dev.widen(table[lo:hi, 1])
            for lett in range(cardinality):
                letters = torch.full((hi - lo,), lett, dtype=torch.int64, device=dev.device)
                s, e = rank_ops.backward_step(
                    dev, start, end, letters, check_valid=False,
                    occurrence_fn=occurrence_fn,
                )
                nxt[lett * n + lo : lett * n + hi, 0] = dev.store(s)
                nxt[lett * n + lo : lett * n + hi, 1] = dev.store(e)
        table = nxt
    return table

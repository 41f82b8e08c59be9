"""Share of the pair forms' steps that read one block row (%):
100 block_row / (block_row + wider) over the port's counters of the steps
that K2 and K4's tail take over a narrow view's pair rows, by class
(``awfm.pairrows.block_row``: the first-block class, read from the block
row; ``awfm.pairrows.wider``: the pair window or two block rows), from
``utils/metrics.snapshot()``. The kernels count on the card while a
profiler records: in a traced run, the warm-up's requests and the
window's. Nothing to read where the port has no such counters or counted
no step (a view without pair rows, a run off the card)."""

BLOCK_ROW, WIDER = "awfm.pairrows.block_row", "awfm.pairrows.wider"


def share(snapshot: dict):
    """% of the steps that read one block row; None without a step."""
    one, wider = snapshot.get(BLOCK_ROW, 0), snapshot.get(WIDER, 0)
    if one + wider <= 0:
        return None
    return 100.0 * one / (one + wider)


def read(ctx):
    from avxwindowfmindex_tpu_torch.utils import metrics

    return share(metrics.snapshot())

"""Block rows a step (rows): (one_row + 2 two_rows) / (one_row + two_rows)
over the port's counters of the steps that K2 and K4's tail take over the
block rows of a view without pair rows, by class
(``awfm.blockrows.one_row``: both ends in one block row;
``awfm.blockrows.two_rows``: read over two), from
``utils/metrics.snapshot()``. The kernels count on the card while a
profiler records: in a traced run, the warm-up's requests and the
window's. Nothing to read where the port has no such counters or counted
no step (a view with pair rows, a run off the card)."""

ONE_ROW, TWO_ROWS = "awfm.blockrows.one_row", "awfm.blockrows.two_rows"


def rows_a_step(snapshot: dict):
    """Block rows a step from a counter snapshot; None without a step."""
    one, two = snapshot.get(ONE_ROW, 0), snapshot.get(TWO_ROWS, 0)
    if one + two <= 0:
        return None
    return (one + 2.0 * two) / (one + two)


def read(ctx):
    from avxwindowfmindex_tpu_torch.utils import metrics

    return rows_a_step(metrics.snapshot())

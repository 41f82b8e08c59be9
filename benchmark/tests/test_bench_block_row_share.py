"""``block_row_share``'s reader: the share of the pair forms' steps that
read one block row, from a counter snapshot of the port's registry, and
nothing where no step was counted (the parent of the counters, a view
without pair rows, a run off the card)."""

import pytest

from benchmark.harness import manifest

BLOCK_ROW, WIDER = "awfm.pairrows.block_row", "awfm.pairrows.wider"


def _reader():
    return manifest.load_reader("block_row_share.locate")


@pytest.mark.parametrize("snap, want", [
    ({BLOCK_ROW: 3, WIDER: 1}, 75.0), ({BLOCK_ROW: 7}, 100.0), ({WIDER: 5}, 0.0),
    ({BLOCK_ROW: 0, WIDER: 0}, None), ({}, None),
    ({"awfm.blockrows.one_row": 9, "awfm.blockrows.two_rows": 1}, None),
])
def test_block_row_share_reads_a_counter_snapshot(snap, want):
    assert _reader().__globals__["share"](snap) == want


def test_block_row_share_reads_the_port_registry(monkeypatch):
    from avxwindowfmindex_tpu_torch.utils import metrics

    monkeypatch.setattr(metrics, "snapshot", lambda: {BLOCK_ROW: 97, WIDER: 3, "x": 4})
    assert _reader()(None) == pytest.approx(97.0)
    assert manifest.load_reader("block_row_share.count")(None) == pytest.approx(97.0)
    monkeypatch.setattr(metrics, "snapshot", lambda: {})
    assert _reader()(None) is None

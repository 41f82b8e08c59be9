"""K2 and K4's tail over a narrow view's pair rows: the first-block class
read from the block row, and the step counters of the pair forms.

A narrow view keeps its block rows beside its pair rows, so the pair forms
read a first-block step's sectors from the block row; the pair window and
two-row classes are as they were. The inputs are ``chip_smoke.py``'s
window-class corpora (``pairless_corpora``): runs of one letter in random
text, whose queries take every window class of K2's steps (nucleotide and
amino) and of K4's n-gram steps and tail (n = 2, 3), as
``tests/test_torch_window_classes.py`` shows on the CPU, where the plain
versions equal the JAX package on them. The tests marked ``card`` hold the
kernels to the plain versions there, tolerance 0, and the counters
``awfm.pairrows.block_row`` / ``awfm.pairrows.wider`` to the plain
versions' window classes; they skip without a card. The module imports
nothing of JAX, so on a card it runs alone:

    python -m pytest tests/test_torch_pairrow_steps.py -m card --noconftest -q
"""

import os

import pytest
import torch

import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.utils import metrics
from benchmark.harness import manifest
from benchmark.tests.helpers import ROOT
from pairrow_corpora import FORMS, corpus_inputs, corpus_text, plain

BLOCK_ROW, WIDER = kernels.PAIR_STEPS


def launch(view, ng, args):
    if ng is None:
        return kernels.k2_ranges(view, *args)
    return kernels.k4_ngram_ranges(view, ng, *args)


# ---------------------------------------------------------------------------
# the metrics that read the counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name, moves, cells", [
    ("block_row_share.locate", "locate_qps",
     ["aa-sprot.peptides", "nt-chr1.locate25", "nt-chr1.locate11"]),
    ("block_row_share.count", "count_qps", ["nt-chr1.count25"]),
])
def test_each_block_row_share_reads_the_pair_row_cells(name, moves, cells):
    m = manifest.load(os.path.join(ROOT, "BENCHMARK.json"))
    (p,) = [p for p in m["per_layer"] if p["name"] == name]
    assert p["workloads"] == cells and p["moves"] == moves and p["layer"] == "ranges"
    assert p["source"] == "program_counter" and p["unit"] == "%" and p["better"] == "higher"
    for cell in cells:
        config = manifest.config(m, manifest.cell(m, cell)["config"], ROOT)
        assert config["pair_rows"] is True and manifest.reports(m, cell, moves)
    reader = manifest.load_reader(name).__globals__  # the names the kernels count under
    assert (reader["BLOCK_ROW"], reader["WIDER"]) == kernels.PAIR_STEPS


# ---------------------------------------------------------------------------
# on the card: the kernels against the plain versions, the counters against
# the window classes
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def card_indexes():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    out = {}
    for form in ("k2-dna-41", "k2-amino"):
        text, k, alphabet = corpus_text(form)
        out[alphabet] = pt.create_index(text, pt.IndexConfiguration(8, k, alphabet),
                                        device="cuda:0")
    return out


@pytest.mark.card
@pytest.mark.parametrize("form", FORMS)
def test_the_pair_forms_equal_the_plain_version_on_the_card(form, card_indexes):
    _, _, alphabet = corpus_text(form)
    view, ng, qs, args = corpus_inputs(form, card_indexes[alphabet], "cuda:0")
    want_s, want_e, classes = plain(view, ng, args)
    c = classes.tolist()
    assert min(c) >= 1, (form, c)  # every class of K2's steps / K4's tail
    for rows in (len(qs), 333):  # whole and ragged
        got_s, got_e = launch(view, ng, tuple(a[:rows] if torch.is_tensor(a) else a
                                              for a in args))
        assert torch.equal(got_s & 0xFFFFFFFF, want_s[:rows] & 0xFFFFFFFF), form
        assert torch.equal(got_e & 0xFFFFFFFF, want_e[:rows] & 0xFFFFFFFF), form


@pytest.mark.card
@pytest.mark.parametrize("form", FORMS)
def test_the_pair_counters_equal_the_window_classes_on_the_card(form, card_indexes):
    _, _, alphabet = corpus_text(form)
    view, ng, _, args = corpus_inputs(form, card_indexes[alphabet], "cuda:0")
    _, _, classes = plain(view, ng, args)
    c = classes.tolist()
    metrics.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        launch(view, ng, args)
    snap = metrics.snapshot()
    assert (snap[BLOCK_ROW], snap[WIDER]) == (c[0], c[1] + c[2]), (form, snap, c)
    assert "awfm.blockrows.one_row" not in snap
    # with no profiler the launch takes a null counter and counts nothing
    metrics.reset()
    launch(view, ng, args)
    assert BLOCK_ROW not in metrics.snapshot()

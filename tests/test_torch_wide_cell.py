"""The chr1 index in the 64-bit layout: a wide view on the benchmark's
path, and K2w's step counters.

On the CPU: the wide configuration is the pair-row one with ``wide`` on
and no n-gram table; its one cell takes locate25 on one chip and is read
by the new metrics alone; the harness serves a wide copy of a small
nucleotide configuration (300,000 bases, seed k = 12, so 11-mers take
K2w from the last letter and 25-mers from the seed) under count-11,
locate-25 and locate-11 traffic, every answer equal to
``benchmark/reference``, and ``first_hit`` is caught; the view takes
K2W and K3W; K2w's counters (the pair forms', ``PAIR_STEPS``) exist
only while a profiler records, and ``block_row_share.wide_locate`` reads
them. The tests marked ``card`` hold K2w over a wide view of the
window-class corpora (``tests/pairrow_corpora.py``) to the plain version,
tolerance 0, and its counters to the plain version's window classes of
the same steps (``ops/rank.window_classes``); they skip without a card.
The module imports nothing of JAX, so on a card it runs alone:

    python -m pytest tests/test_torch_wide_cell.py -m card --noconftest -q
"""

import functools
import json
import os
import time
import types

import pytest
import torch

import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.ops import seed_table as seed_mod
from avxwindowfmindex_tpu_torch.utils import metrics
from benchmark.harness import index_cache, main, manifest, textgen, traffic
from benchmark.tests.helpers import ROOT, TINY_CONFIGS, tiny_manifest
from pairrow_corpora import corpus_inputs, corpus_text, plain

FIRST, WIDER = kernels.PAIR_STEPS
CONFIG = "nt-chr1-k12-r8-wide"
CELL = "nt-chr1.locate25-wide"
# each read by its stem's reader (benchmark/metrics/<stem>.py)
NEW_METRICS = {"ranges_roofline.wide_locate": ("ranges", "device_trace", "higher"),
               "hits_roofline.wide_locate": ("hits", "device_trace", "higher"),
               "block_row_share.wide_locate": ("ranges", "program_counter", "higher"),
               "device_idle.wide_locate": ("device", "device_trace", "lower")}
SMALL = dict(TINY_CONFIGS["nt-tiny"], name="nt-small-wide", seed_k=12, wide=True, ngram_n=None,
             text=dict(TINY_CONFIGS["nt-tiny"]["text"], bases=300_000))
SMALL_TRAFFIC = {"count11": {"op": "count", "source": "text_kmers", "length": 11, "batch": 512,
                             "pool": 3, "pad_to": 4},
                 "locate25": {"op": "locate", "source": "text_kmers", "length": 25, "batch": 512,
                              "pool": 3, "pad_to": 4},
                 # ~7% of these 11-mers occur twice or more: what first_hit drops
                 "locate11": {"op": "locate", "source": "text_kmers", "length": 11, "batch": 512,
                              "pool": 3, "pad_to": 4}}


def _real():
    return manifest.load(os.path.join(ROOT, "BENCHMARK.json"))


# ---------------------------------------------------------------------------
# the configuration and its cell
# ---------------------------------------------------------------------------

def test_the_wide_configuration_is_the_pair_row_one_in_the_64_bit_layout():
    m = _real()
    wide = manifest.config(m, CONFIG, ROOT)
    pair = manifest.config(m, "nt-chr1-k12-r8", ROOT)
    differ = {k for k in set(wide) | set(pair) if wide.get(k) != pair.get(k)}
    assert differ == {"name", "source", "deployment", "source_bases", "reduced_why", "reference",
                      "wide", "ngram_n"}
    assert wide["wide"] is True and wide["ngram_n"] is None and wide["pair_rows"] is True
    assert all(wide[k] == pair[k] for k in index_cache.INDEX_KEYS)
    assert wide["reduced"] == ["bases"] and wide["guarantee"] == pair["guarantee"]
    assert wide["source_bases"] == 6_199_468_300 > 2**32 > wide["text"]["bases"]
    (entry,) = [c for c in m["configs"] if c["name"] == CONFIG]
    assert entry["file"] == f"benchmark/configs/{CONFIG}.json" and entry["reduced"] == ["bases"]


def test_the_wide_cell_takes_locate25_on_one_chip():
    m = _real()
    w = manifest.cell(m, CELL)
    spec = manifest.traffic(w["traffic"])
    traffic.check(spec)
    assert w["config"] == CONFIG and w["traffic"] == "locate25" and w["chips"] == 1
    assert spec["length"] == 25 and spec["batch"] == 4_194_304 and spec["pool"] == 8
    assert {e["name"] for e in m["end_to_end"] if manifest.reports(m, CELL, e["name"])} == {
        "locate_qps", "request_p95_ms", "setup_s"}
    # the new metrics read this cell alone, and no other metric lists it
    assert {p["name"] for p in manifest.metrics_of(m, CELL, "per_layer")} == set(NEW_METRICS)


@pytest.mark.parametrize("name", sorted(NEW_METRICS))
def test_each_new_metric_reads_the_wide_cell_alone(name):
    m = _real()
    (p,) = [p for p in m["per_layer"] if p["name"] == name]
    assert p["workloads"] == [CELL] and p["moves"] == "locate_qps" and p["unit"] == "%"
    assert (p["layer"], p["source"], p["better"]) == NEW_METRICS[name]
    assert manifest.reader_path(name) == manifest.reader_path(name.split(".")[0] + ".locate")


# ---------------------------------------------------------------------------
# the harness on the CPU over a small wide index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(manifest, root) of the small wide cells, their index built once:
    the seed table's plain BFS in chunks of 2^18 ranges, so that k = 12
    takes under a GB of host memory."""
    root = str(tmp_path_factory.mktemp("wide"))
    m = tiny_manifest(root)
    d = os.path.join(root, "benchmark")
    with open(os.path.join(d, "configs", SMALL["name"] + ".json"), "w") as fh:
        json.dump(SMALL, fh)
    for name, body in SMALL_TRAFFIC.items():
        with open(os.path.join(d, "traffic", name + ".json"), "w") as fh:
            json.dump(body, fh)
    m["configs"].append({"name": SMALL["name"], "source": "tiny",
                         "file": f"benchmark/configs/{SMALL['name']}.json", "reduced": [],
                         "why": "tiny"})
    for name, spec in SMALL_TRAFFIC.items():
        cell = f"small.{name}"
        m["workloads"].append({"name": cell, "config": SMALL["name"], "traffic": name,
                               "chips": 1, "why": "tiny"})
        moves = "count_qps" if spec["op"] == "count" else "locate_qps"
        for e in m["end_to_end"]:
            if e["name"] in (moves, "request_p95_ms", "setup_s"):
                e["workloads"].append(cell)
        for p in m["per_layer"]:
            if p["name"] in NEW_METRICS and p["moves"] == moves:
                p["workloads"].append(cell)
    orig = seed_mod.build_seed_table
    seed_mod.build_seed_table = functools.partial(orig, chunk=1 << 18)
    try:
        _run(m, root, "small.locate25")  # builds and caches the index
    finally:
        seed_mod.build_seed_table = orig
    return m, root


def _run(m, root, cell, trace_on=False, control=None):
    return main.run_cell(
        m, cell, 2**31 + 29, 0.05, trace_on, device=torch.device("cpu"), t0=time.perf_counter(),
        control=control, root=root, bench=os.path.join(root, "benchmark"),
        cache_root=os.path.join(root, "cache"),
    )


@pytest.mark.parametrize("cell", ["small.count11", "small.locate25", "small.locate11"])
def test_a_wide_cell_is_correct_on_the_cpu(small, cell):
    res, checks = _run(*small, cell)
    count = cell.endswith("count11")
    assert [n for n, _, _ in checks] == (
        ["count_wrong"] if count else ["count_wrong", "hits_wrong", "totals_wrong"])
    assert all(v == 0 for _, v, _ in checks), checks
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "request_p95_ms",
                                   "count_qps" if count else "locate_qps"}


def test_the_first_hit_control_is_caught_on_a_wide_cell(small):
    _, checks = _run(*small, "small.locate11", control="first_hit")
    wrong = {n: v for n, v, _ in checks}
    assert wrong["count_wrong"] == 0 and wrong["hits_wrong"] > 0, checks


def test_a_traced_wide_run_off_the_card_reads_no_step(small):
    metrics.reset()
    res, checks = _run(*small, "small.locate25", trace_on=True)
    assert all(v == 0 for _, v, _ in checks), checks
    assert res["metrics"] == {} and FIRST not in metrics.snapshot()


def test_the_wide_view_takes_the_wide_forms(small):
    m, root = small
    cfg = manifest.config(m, SMALL["name"], root)
    _, dev, ng = index_cache.prepare(cfg, textgen.generate(cfg["text"]), torch.device("cpu"),
                                     os.path.join(root, "cache"))
    assert dev.wide and dev.pair_rows and ng is None
    assert dev.kmer_length_in_seed_table == 12 and dev.seed_table.dtype == torch.int64
    assert dev.seed_table.shape == (4**12, 2) and dev.sampled_sa.dtype == torch.int64
    assert kernels.form_of(dev, kernels.K2) is kernels.K2W
    assert kernels.form_of(dev, kernels.K3) is kernels.K3W


# ---------------------------------------------------------------------------
# the counters and the metric that reads them
# ---------------------------------------------------------------------------

def test_the_wide_counters_exist_only_while_a_profiler_records():
    metrics.reset()
    cpu = torch.device("cpu")
    assert metrics.device_counts(kernels.PAIR_STEPS, cpu) is None
    assert kernels._row_steps(kernels.K2W, cpu) == (None,)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        counts = metrics.device_counts(kernels.PAIR_STEPS, cpu)
        assert counts.dtype == torch.int64 and counts.tolist() == [0, 0]
        # the pair forms' tensor: a wide view's pair-fused rows are its block rows
        assert kernels._row_steps(kernels.K2W, cpu) == (counts.data_ptr(),)
        assert kernels._row_steps(kernels.K2, cpu) == (counts.data_ptr(),)
        assert metrics.device_counts(kernels.ROW_STEPS, cpu) is not counts
        for k in (kernels.K2W_COMPACT, kernels.K3W, kernels.K1W):
            assert kernels._row_steps(k, cpu) == ()
    counts += torch.tensor([9, 1])
    snap = metrics.snapshot()
    assert (snap[FIRST], snap[WIDER]) == (9, 1)
    metrics.reset()
    assert metrics.snapshot() == {}


@pytest.mark.parametrize("snap, want", [
    ({FIRST: 3, WIDER: 1}, 75.0), ({FIRST: 7}, 100.0), ({WIDER: 5}, 0.0), ({FIRST: 0, WIDER: 0}, None),
    ({}, None), ({"awfm.blockrows.one_row": 9, "awfm.blockrows.two_rows": 1}, None),
])
def test_block_row_share_reads_the_wide_cell_from_the_pair_counters(snap, want, monkeypatch):
    reader = manifest.load_reader("block_row_share.wide_locate")
    assert (reader.__globals__["BLOCK_ROW"], reader.__globals__["WIDER"]) == kernels.PAIR_STEPS
    monkeypatch.setattr(metrics, "snapshot", lambda: dict(snap, **{"search.queries": 4}))
    assert reader(None) == want


@pytest.mark.parametrize("trace, want", [
    ({"window_s": 10.0, "busy_s": 9.25}, 7.5), ({"window_s": 10.0, "busy_s": 0.0}, None),
    (None, None),
])
def test_device_idle_reads_the_wide_cell_from_its_trace(trace, want):
    reader = manifest.load_reader("device_idle.wide_locate")
    got = reader(types.SimpleNamespace(trace=trace))
    assert got == want if want is None else got == pytest.approx(want)


# ---------------------------------------------------------------------------
# on the card: K2w against the plain version, its counters against the
# window classes of the same steps
# ---------------------------------------------------------------------------

WIDE_FORMS = ["k2-dna-41", "k2-dna-29", "k2-amino"]


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
@pytest.mark.parametrize("form", WIDE_FORMS)
def test_k2w_and_its_counters_equal_the_plain_version_on_the_card(form, card_indexes):
    _, _, alphabet = corpus_text(form)
    index = card_indexes[alphabet]
    _, _, _, args = corpus_inputs(form, index, "cuda:0")
    view = index.to_device("cuda:0", wide=True, pair_rows=True)
    assert view.wide and kernels.form_of(view, kernels.K2) is kernels.K2W
    want_s, want_e, classes = plain(view, None, args)
    c = classes.tolist()
    assert c[0] > 0 and c[1] + c[2] > 0, (form, c)
    metrics.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        got_s, got_e = kernels.k2_ranges(view, *args)
    snap = metrics.snapshot()
    assert torch.equal(got_s, want_s) and torch.equal(got_e, want_e), form
    assert (snap[FIRST], snap[WIDER]) == (c[0], c[1] + c[2]), (form, snap, c)
    assert "awfm.blockrows.one_row" not in snap
    # with no profiler the launch takes a null counter, counts nothing and
    # gives the same ranges
    metrics.reset()
    got_s, got_e = kernels.k2_ranges(view, *args)
    assert torch.equal(got_s, want_s) and torch.equal(got_e, want_e), form
    assert FIRST not in metrics.snapshot()

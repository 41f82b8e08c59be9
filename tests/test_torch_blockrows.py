"""The chr1 index in the upstream's layout: a view without pair rows on the
benchmark's path, and the block-row step counters of K2 and K4's tail.

On the CPU: the block-row configuration is the pair-row one with
``pair_rows`` off; the harness serves a block-row copy of a small
nucleotide configuration (300,000 bases, seed k = 12, so 11-mers take
K2's path from the last letter and 25-mers K4's) under count-11 and
locate-25 traffic, every answer equal to ``benchmark/reference``; the
view takes the block-row forms; the counters exist only while a profiler
records; ``blockrow_rows`` reads a counter snapshot. The test marked
``card`` runs K2 and K4 over block rows under a profiler and finds their
counters equal to the window classes of the same steps
(``ops/rank.window_classes`` through the plain versions); it skips
without a card. The module imports nothing of JAX, so on a card it runs
alone:

    python -m pytest tests/test_torch_blockrows.py -m card --noconftest -q
"""

import functools
import json
import os
import time

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch import search
from avxwindowfmindex_tpu_torch.models import alphabet as alpha
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.ops import ngram as ngram_ops
from avxwindowfmindex_tpu_torch.ops import seed_table as seed_mod
from avxwindowfmindex_tpu_torch.utils import metrics
from benchmark.harness import index_cache, main, manifest, traffic
from benchmark.tests.helpers import ROOT, TINY_CONFIGS, tiny_manifest

ONE, TWO = kernels.ROW_STEPS
CONFIG = "nt-chr1-k12-r8-blockrows"
SMALL = dict(TINY_CONFIGS["nt-tiny"], name="nt-small-blockrows", seed_k=12, pair_rows=False,
             text=dict(TINY_CONFIGS["nt-tiny"]["text"], bases=300_000))
SMALL_TRAFFIC = {"count11": {"op": "count", "source": "text_kmers", "length": 11, "batch": 512,
                             "pool": 3, "pad_to": 4},
                 "locate25": {"op": "locate", "source": "text_kmers", "length": 25, "batch": 512,
                              "pool": 3, "pad_to": 4}}


def _real():
    return manifest.load(os.path.join(ROOT, "BENCHMARK.json"))


# ---------------------------------------------------------------------------
# the configuration and its cells
# ---------------------------------------------------------------------------

def test_the_block_row_configuration_is_the_pair_row_one_without_pair_rows():
    m = _real()
    block = manifest.config(m, CONFIG, ROOT)
    pair = manifest.config(m, "nt-chr1-k12-r8", ROOT)
    differ = {k for k in set(block) | set(pair) if block.get(k) != pair.get(k)}
    assert differ == {"name", "source", "deployment", "pair_rows", "reference"}
    assert block["pair_rows"] is False and pair["pair_rows"] is True
    assert index_cache.INDEX_KEYS and all(block[k] == pair[k] for k in index_cache.INDEX_KEYS)
    assert block["reduced"] == ["bases"] and block["guarantee"] == pair["guarantee"]


@pytest.mark.parametrize("cell, name, length", [
    ("nt-chr1.locate25-blockrows", "locate25", 25), ("nt-chr1.count11-blockrows", "count11", 11),
])
def test_each_cell_takes_its_traffic_on_either_side_of_the_seed(cell, name, length):
    m = _real()
    w = manifest.cell(m, cell)
    spec = manifest.traffic(w["traffic"])
    traffic.check(spec)
    k = manifest.config(m, w["config"], ROOT)["seed_k"]
    assert w["config"] == CONFIG and w["traffic"] == name and w["chips"] == 1
    assert spec["length"] == length and spec["batch"] == 4_194_304 and spec["pool"] == 8
    assert (length > k) == (name == "locate25")


@pytest.mark.parametrize("name, moves", [
    ("ranges_roofline.blockrows_locate", "locate_qps"), ("ranges_roofline.blockrows_count", "count_qps"),
    ("blockrow_rows.locate", "locate_qps"), ("blockrow_rows.count", "count_qps"),
])
def test_each_new_metric_reads_its_one_cell(name, moves):
    m = _real()
    (p,) = [p for p in m["per_layer"] if p["name"] == name]
    (cell,) = p["workloads"]
    assert p["moves"] == moves and p["layer"] == "ranges" and manifest.reports(m, cell, moves)
    assert manifest.config(m, manifest.cell(m, cell)["config"], ROOT)["name"] == CONFIG
    assert callable(manifest.load_reader(name))


# ---------------------------------------------------------------------------
# the harness on the CPU over a small block-row index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """(manifest, root) of the small block-row cells, their index built
    once: the seed table's plain BFS in chunks of 2^18 ranges, so that
    k = 12 takes under a GB of host memory."""
    root = str(tmp_path_factory.mktemp("blockrows"))
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
            if p["moves"] == moves and p["name"].startswith(("blockrow_rows.", "ranges_roofline.blockrows")):
                p["workloads"].append(cell)
    orig = seed_mod.build_seed_table
    seed_mod.build_seed_table = functools.partial(orig, chunk=1 << 18)
    try:
        _run(m, root, "small.locate25")  # builds and caches the index
    finally:
        seed_mod.build_seed_table = orig
    return m, root


def _run(m, root, cell, trace_on=False):
    res, checks = main.run_cell(
        m, cell, 2**31 + 23, 0.05, trace_on, device=torch.device("cpu"), t0=time.perf_counter(),
        root=root, bench=os.path.join(root, "benchmark"), cache_root=os.path.join(root, "cache"),
    )
    return res, checks


@pytest.mark.parametrize("cell", ["small.count11", "small.locate25"])
def test_a_block_row_cell_is_correct_on_the_cpu(small, cell):
    res, checks = _run(*small, cell)
    assert [n for n, _, _ in checks] == (
        ["count_wrong"] if cell.endswith("count11") else ["count_wrong", "hits_wrong", "totals_wrong"])
    assert all(v == 0 for _, v, _ in checks), checks
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert set(res["metrics"]) == {"setup_s", "request_p95_ms",
                                   "count_qps" if cell.endswith("count11") else "locate_qps"}


def test_a_traced_block_row_run_off_the_card_reads_no_step(small):
    res, checks = _run(*small, "small.count11", trace_on=True)
    assert all(v == 0 for _, v, _ in checks), checks
    assert res["metrics"] == {}


def test_the_block_row_view_takes_the_block_row_forms(small):
    m, root = small
    cfg = manifest.config(m, SMALL["name"], root)
    from benchmark.harness import textgen

    _, dev, ng = index_cache.prepare(cfg, textgen.generate(cfg["text"]), torch.device("cpu"),
                                     os.path.join(root, "cache"))
    assert not dev.pair_rows and dev.packed_pair is None and ng is not None and ng.n == 2
    assert dev.kmer_length_in_seed_table == 12
    assert kernels.form_of(dev, kernels.K2) is kernels.K2_BLOCK
    assert kernels.form_of(dev, kernels.K4) is kernels.K4_BLOCK


# ---------------------------------------------------------------------------
# the counters
# ---------------------------------------------------------------------------

def _reader():
    return manifest.load_reader("blockrow_rows.count")


def _rows_a_step():
    return _reader().__globals__["rows_a_step"]


@pytest.mark.parametrize("snap, want", [
    ({ONE: 3, TWO: 1}, 1.25), ({ONE: 7}, 1.0), ({TWO: 5}, 2.0), ({ONE: 0, TWO: 0}, None),
    ({}, None), ({"search.count.queries": 9}, None),
])
def test_blockrow_rows_reads_a_counter_snapshot(snap, want):
    assert _rows_a_step()(snap) == want


def test_blockrow_rows_reads_the_port_registry(monkeypatch):
    monkeypatch.setattr(metrics, "snapshot", lambda: {ONE: 6, TWO: 2, "search.count.queries": 4})
    assert _reader()(None) == 1.25
    monkeypatch.setattr(metrics, "snapshot", lambda: {})
    assert _reader()(None) is None


def test_device_counts_exist_only_while_a_profiler_records():
    metrics.reset()
    cpu = torch.device("cpu")
    assert metrics.device_counts(kernels.ROW_STEPS, cpu) is None
    assert kernels._row_steps(kernels.K2_BLOCK, cpu) == (None,)
    assert kernels._row_steps(kernels.K4_BLOCK, cpu) == (None,)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        counts = metrics.device_counts(kernels.ROW_STEPS, cpu)
        assert counts.dtype == torch.int64 and counts.tolist() == [0, 0]
        assert metrics.device_counts(kernels.ROW_STEPS, cpu) is counts
        assert kernels._row_steps(kernels.K2_BLOCK, cpu) == (counts.data_ptr(),)
        for k in (kernels.K2, kernels.K4, kernels.K2W_COMPACT, kernels.K3):
            assert kernels._row_steps(k, cpu) == ()
        metrics.set_enabled(False)
        try:
            assert metrics.device_counts(kernels.ROW_STEPS, cpu) is None
        finally:
            metrics.set_enabled(True)
    counts += torch.tensor([5, 2])
    metrics.counter("search.count.queries").add(3)
    assert metrics.snapshot() == {ONE: 5, TWO: 2, "search.count.queries": 3}
    metrics.reset()
    assert metrics.snapshot() == {}


# ---------------------------------------------------------------------------
# on the card: the counters against the window classes of the same steps
# ---------------------------------------------------------------------------

def _letters(text, starts, length, device):
    ascii_ = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(length)[None, :]]
    return torch.from_numpy(alpha.NT_ASCII_TO_INDEX[ascii_].astype(np.uint8)).to(device)


@pytest.mark.card
def test_the_counters_equal_the_window_classes_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    device = torch.device("cuda:0")
    rng = np.random.default_rng(0xB10C)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=200_000))
    idx = pt.create_index(text, pt.IndexConfiguration(8, 6, pt.AlphabetType.DNA), device=device,
                          pair_rows=False)
    dev = idx.to_device(device)
    ng = ngram_ops.build_ngram_device(idx, 2, device=device)
    assert not dev.pair_rows
    # K2: 11-mers over the seed, 5-mers under it (unseeded), and random
    # letters (mostly empty after a few steps): both classes
    n = 4096
    starts = rng.integers(0, len(text) - 12, size=n)
    mat = _letters(text, starts, 12, device)
    mat[n // 2:] = torch.from_numpy(rng.integers(0, 4, size=(n - n // 2, 12)).astype(np.uint8)).to(device)
    lengths = torch.from_numpy(np.where(np.arange(n) % 3 == 0, 5, 11).astype(np.int32)).to(device)
    seeded = (lengths >= 6).to(torch.uint8)
    # K4: uniform 9-mers, one n-gram step and one tail step each
    k4_mat = _letters(text, rng.integers(0, len(text) - 12, size=n), 12, device)
    for run in ("k2", "k4"):
        metrics.reset()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            if run == "k2":
                got = kernels.k2_ranges(dev, mat, lengths, seeded)
            else:
                got = kernels.k4_ngram_ranges(dev, ng, k4_mat, 9)
        snap = metrics.snapshot()
        if run == "k2":
            classes = torch.zeros(3, dtype=torch.int64, device=device)
            want = search.ranges_plain(dev, mat, lengths, seeded, classes=classes)
        else:
            by_table = search.new_step_classes(device)
            want = search.ngram_ranges_plain(dev, ng, k4_mat, 9, classes=by_table)
            classes = by_table["pair"]
        for g, w in zip(got, want):
            assert torch.equal(g & 0xFFFFFFFF, w & 0xFFFFFFFF)
        c = classes.tolist()
        assert c[0] > 0 and c[1] + c[2] > 0, (run, c)
        assert (snap[ONE], snap[TWO]) == (c[0], c[1] + c[2]), (run, snap, c)
    # with no profiler the launch takes a null counter and counts nothing
    metrics.reset()
    kernels.k2_ranges(dev, mat, lengths, seeded)
    kernels.k4_ngram_ranges(dev, ng, k4_mat, 9)
    assert ONE not in metrics.snapshot()

"""The port's spans (``utils/metrics.span``) on its device path.

A count and a locate go through the batched functions as a pipeline
calls them (``search_ranges`` or ``ngram_ranges``, ``range_counts``,
``locate_flat_device``). With no profiler they enter no
``record_function``; under one they leave the ``awfm.*`` ranges nested
as designed; ``metrics.set_enabled(False)`` silences them; the answers
do not change. The test marked ``card`` traces a locate on the card and
finds K3's kernel launched inside ``awfm.launch.k3_backtrace_resolve``
and ``awfm.backtrace``; another finds one request's launches counted
once each over one checked view state. They skip without a card. It imports nothing of
JAX, so on a card it runs alone:

    python -m pytest tests/test_torch_spans.py -m card --noconftest -q
"""

import json

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch import search
from avxwindowfmindex_tpu_torch.models import alphabet as alpha
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.ops import ngram as ngram_ops
from avxwindowfmindex_tpu_torch.utils import metrics

K = 3
LENGTH = 9  # longer than the seed, so a uniform clean batch takes K4 on a card
# the spans of a request in the order they open, on the CPU (no launch
# spans: the plain versions run there); range_counts runs inside
# enumerate_flat too
COUNT = ["awfm.ranges", "awfm.counts"]
LOCATE = COUNT + ["awfm.locate", "awfm.enumerate", "awfm.counts", "awfm.backtrace"]


def _build(device):
    """(device view, n-gram table, letters, lengths, seeded) over a
    3,000-base random text with 96 queries drawn from it."""
    rng = np.random.default_rng(0x5BA7)
    text = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=3000))
    idx = pt.create_index(text, pt.IndexConfiguration(8, K, pt.AlphabetType.DNA), device=device)
    starts = rng.integers(0, len(text) - LENGTH, size=96)
    ascii_ = np.frombuffer(text, np.uint8)[starts[:, None] + np.arange(LENGTH)[None, :]]
    mat = torch.from_numpy(alpha.NT_ASCII_TO_INDEX[ascii_].astype(np.uint8)).to(device)
    n = mat.shape[0]
    lengths = torch.full((n,), LENGTH, dtype=torch.int32, device=device)
    seeded = torch.ones(n, dtype=torch.uint8, device=device)
    ng = ngram_ops.build_ngram_device(idx, 2, device=device)
    return idx.to_device(device), ng, mat, lengths, seeded


@pytest.fixture(scope="module")
def cpu():
    return _build(torch.device("cpu"))


def _request(built, ngram: bool, locate: bool):
    """One request as the benchmark's client makes it: (counts, hits)."""
    dev, ng, mat, lengths, seeded = built
    if ngram:
        s, e = search.ngram_ranges(dev, ng, mat, LENGTH)
    else:
        s, e = search.search_ranges(dev, mat, lengths, seeded)
    counts = search.range_counts(s, e, dev.wide)
    if not locate:
        return counts, None
    total = int(counts.sum())
    hits, _, _ = search.locate_flat_device(dev, s, e, capacity=total)
    return counts, hits[:total]


def _profiled(fn, activities=(torch.profiler.ProfilerActivity.CPU,)):
    """(fn's result, the ``awfm.*`` events of a profiler around it, by start)."""
    with torch.profiler.profile(activities=list(activities)) as prof:
        out = fn()
    spans = [e for e in prof.events() if e.name.startswith("awfm.")]
    return out, sorted(spans, key=lambda e: (e.time_range.start, -e.time_range.end))


def _inside(inner, outer) -> bool:
    return (outer.time_range.start <= inner.time_range.start
            and inner.time_range.end <= outer.time_range.end)


@pytest.mark.parametrize("ngram", [False, True], ids=["k2", "k4"])
def test_no_profiler_enters_no_record_function(cpu, ngram, monkeypatch):
    class Refused:
        def __init__(self, *a, **k):
            raise AssertionError("a record_function was made with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", Refused)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", Refused)
    counts, _ = _request(cpu, ngram, locate=False)
    counts2, hits = _request(cpu, ngram, locate=True)
    assert torch.equal(counts, counts2) and hits.shape[0] == int(counts.sum()) > 0


@pytest.mark.parametrize("ngram", [False, True], ids=["k2", "k4"])
def test_spans_under_a_profiler_nest_as_designed(cpu, ngram):
    _, spans = _profiled(lambda: _request(cpu, ngram, locate=False))
    assert [e.name for e in spans] == COUNT
    _, spans = _profiled(lambda: _request(cpu, ngram, locate=True))
    assert [e.name for e in spans] == LOCATE
    by = {}
    for e in spans:
        by.setdefault(e.name, []).append(e)
    (locate,), (enum,), (bt,) = by["awfm.locate"], by["awfm.enumerate"], by["awfm.backtrace"]
    assert _inside(enum, locate) and _inside(bt, locate)
    assert enum.time_range.end <= bt.time_range.start
    outer, inner = by["awfm.counts"]
    assert not _inside(outer, locate) and _inside(inner, enum)
    assert not _inside(by["awfm.ranges"][0], locate)


def test_the_registry_switch_silences_the_spans(cpu):
    metrics.set_enabled(False)
    try:
        _, spans = _profiled(lambda: _request(cpu, True, locate=True))
    finally:
        metrics.set_enabled(True)
    assert spans == []
    _, spans = _profiled(lambda: _request(cpu, True, locate=True))
    assert len(spans) == len(LOCATE)


@pytest.mark.parametrize("ngram", [False, True], ids=["k2", "k4"])
def test_answers_are_the_same_with_the_spans_on(cpu, ngram):
    (counts_on, hits_on), spans = _profiled(lambda: _request(cpu, ngram, locate=True))
    assert spans
    counts_off, hits_off = _request(cpu, ngram, locate=True)
    assert torch.equal(counts_on, counts_off) and torch.equal(hits_on, hits_off)


def test_a_launch_runs_inside_its_forms_span():
    seen = []
    fake = lambda *args: seen.append(args) or 0  # stands for a C entry point
    kernels.reset_launch_counts()
    _, spans = _profiled(lambda: kernels._launch(kernels.K3W_COMPACT, fake, 1, 2))
    assert seen == [(1, 2)] and kernels.K3W_COMPACT.launches == 1
    assert [e.name for e in spans] == ["awfm.launch.k3w_backtrace_resolve_compact"]
    assert [k.span for k in (kernels.K3, kernels.K4)] == [
        "launch.k3_backtrace_resolve", "launch.k4_ngram_ranges"]


@pytest.mark.card
def test_on_a_card_k3_is_launched_inside_its_spans(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    built = _build(torch.device("cuda:0"))
    _request(built, True, locate=True)  # builds the kernels and warms up
    torch.cuda.synchronize()
    acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=list(acts)) as prof:
        counts, hits = _request(built, True, locate=True)
        torch.cuda.synchronize()
    cpu_counts, cpu_hits = _request(_build(torch.device("cpu")), True, locate=True)
    assert torch.equal(counts.cpu(), cpu_counts) and torch.equal(hits.cpu(), cpu_hits)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    spans = [e for e in events if e.get("cat") == "user_annotation"
             and e["name"].startswith("awfm.")]
    names = sorted(e["name"] for e in spans)
    # on the card enumerate is K7's launch, with no range_counts inside it
    assert names == sorted(COUNT + ["awfm.locate", "awfm.enumerate", "awfm.backtrace",
                                    "awfm.launch.k4_ngram_ranges", "awfm.launch.k7_enumerate",
                                    "awfm.launch.k3_backtrace_resolve"])
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    k3 = [e for e in events
          if e.get("cat") == "kernel" and "k3_backtrace_resolve_kernel" in e["name"]]
    assert len(k3) == 1
    at = launched[k3[0]["args"]["correlation"]]

    def holds(name):
        (span,) = [e for e in spans if e["name"] == name]
        return span["ts"] <= at <= span["ts"] + span["dur"]

    assert holds("awfm.launch.k3_backtrace_resolve") and holds("awfm.backtrace")
    assert holds("awfm.locate") and not holds("awfm.enumerate")


@pytest.mark.card
@pytest.mark.parametrize("ngram", [False, True], ids=["k2", "k4"])
def test_on_a_card_a_request_checks_its_view_once_and_launches_each_kernel_once(ngram):
    """A locate on one view (K2 or K4, K7's scan and write, K3) builds one
    ``_view_state`` for the view, which the next request reuses, and
    counts exactly the launches it makes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card in this process")
    built = _build(torch.device("cuda:0"))
    dev = built[0]
    kernels.reset_launch_counts()
    counts, hits = _request(built, ngram, locate=True)
    assert int(counts.sum()) == hits.shape[0] > 0
    (state,) = [st for ref, st in kernels._VIEW_STATE.values() if ref() is dev]
    assert {k: v for k, v in kernels.launch_counts().items() if v} == {
        "k4_ngram_ranges" if ngram else "k2_ranges": 1, "k7_enumerate": 2,
        "k7_enumerate.scan": 1, "k7_enumerate.write": 1, "k3_backtrace_resolve": 1}
    _request(built, ngram, locate=True)
    assert kernels._VIEW_STATE[id(dev)][1] is state

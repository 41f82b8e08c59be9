"""The harness on the CPU at a tiny size: sound runs are correct, and
the controls and each fault the cells can have come out not correct.

These runs skip the harness's look for a card (``run_cell`` with a CPU
device) and drive the rest of a run: set-up, the window, the
comparison with the reference."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark.harness import main, manifest
from benchmark.tests.helpers import BENCH, ROOT, TINY_CELLS, TINY_CONFIGS, TINY_TRAFFIC, run_tiny, tiny_manifest

LOCATE = [c for c, _, t in TINY_CELLS if TINY_TRAFFIC[t]["op"] == "locate"]


@pytest.mark.parametrize("cell", [c for c, _, _ in TINY_CELLS])
def test_sound_runs_are_correct(tiny, cell):
    res, checks = run_tiny(tiny, cell)
    assert res["correct"], checks
    m, _ = tiny
    assert set(res["metrics"]) == {e["name"] for e in manifest.metrics_of(m, cell, "end_to_end")}
    assert res["attempted"] >= 3 and res["failed"] == 0
    assert all(v == 0 for _, v, _ in checks)


def test_a_traced_run_is_correct_and_reads_nothing_off_the_card(tiny):
    res, checks = run_tiny(tiny, "nt-tiny.l10", trace_on=True)
    assert res["correct"], checks
    # no device trace on the CPU, and a traced line reports no end-to-end metric
    assert res["metrics"] == {}


@pytest.mark.parametrize("cell, control", [
    ("nt-tiny.l5", "first_hit"), ("aa-tiny.pep", "first_hit"),
    ("nt-tiny.c10", "seed_count"), ("nt-tiny.l10", "seed_count"),
])
def test_controls_are_not_correct(tiny, cell, control):
    res, checks = run_tiny(tiny, cell, control=control)
    assert not res["correct"], checks


def _faulty(fault: str, search):
    """The port's functions with ``fault`` planted where they produce."""
    ngram, steps = search.ngram_ranges, search.search_ranges
    counts, resolve = search.range_counts, search.backtrace_resolve

    if fault == "state unchanged":  # the backward steps return the seed's range
        def ngram_f(dev, ng, mat, kmer_len):
            n = mat.shape[0]
            lengths = torch.full((n,), kmer_len, dtype=torch.int64, device=mat.device)
            ones = torch.ones(n, dtype=torch.bool, device=mat.device)
            return search.initial_ranges(dev, mat.long(), lengths, ones)[:2]

        def steps_f(dev, mat, lengths, seeded):
            return search.initial_ranges(dev, mat.long(), lengths.long(), seeded.bool())[:2]

        return {"ngram_ranges": ngram_f, "search_ranges": steps_f}
    if fault == "half the batch left out":
        def halve(fn):
            def f(*a):
                s, e = fn(*a)
                s, e = s.clone(), e.clone()
                s[s.shape[0] // 2:], e[e.shape[0] // 2:] = 1, 0
                return s, e
            return f

        return {"ngram_ranges": halve(ngram), "search_ranges": halve(steps)}
    if fault == "an answer altered":
        def counts_f(s, e, wide=False):
            c = counts(s, e, wide).clone()
            c[0] += 1
            return c

        def resolve_f(dev, pos):
            h = resolve(dev, pos).clone()
            h[0] += 1
            return h

        return {"range_counts": counts_f, "backtrace_resolve": resolve_f}
    raise ValueError(fault)


@pytest.mark.parametrize("cell", ["nt-tiny.l10", "nt-tiny.c10", "aa-tiny.pep"])
@pytest.mark.parametrize("fault", ["state unchanged", "half the batch left out", "an answer altered"])
def test_each_fault_is_not_correct(tiny, monkeypatch, cell, fault):
    from avxwindowfmindex_tpu_torch import search

    for name, fn in _faulty(fault, search).items():
        monkeypatch.setattr(search, name, fn)
    res, checks = run_tiny(tiny, cell)
    assert not res["correct"], checks


def test_only_a_hit_altered_is_caught_by_the_hits(tiny, monkeypatch):
    from avxwindowfmindex_tpu_torch import search

    monkeypatch.setattr(search, "backtrace_resolve", _faulty("an answer altered", search)["backtrace_resolve"])
    res, checks = run_tiny(tiny, "nt-tiny.l5")
    got = {n: v for n, v, _ in checks}
    assert got["count_wrong"] == 0 and got["hits_wrong"] >= 1 and not res["correct"]


def test_finish_prints_the_checks_last(capsys):
    res = {"correct": None, "attempted": 1, "failed": 0, "metrics": {}, "device": {}}
    assert main.finish(res, [("count_wrong", 0, 0), ("hits_wrong", 2, 0)]) == 0
    out, err = capsys.readouterr()
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is False and list(line)[-1] == "checks"
    assert line["checks"]["hits_wrong"] == {"value": 2, "limit": 0}
    assert err.strip().splitlines()[-1] == "check hits_wrong 2 limit 0"


def test_the_command_refuses_a_process_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this process has a card")
    r = subprocess.run([sys.executable, os.path.join(BENCH, "run.py"), "--workload",
                        "nt-chr1.locate25", "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""


def test_a_cell_added_by_files_alone(tmp_path):
    """A later change adds a configuration, a traffic mix and a metric as
    new files and entries; no file of the benchmark is edited."""
    copy = tmp_path / "checkout"
    shutil.copytree(BENCH, copy / "benchmark", ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), copy / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in (copy / "benchmark").rglob("*") if p.is_file()}
    cfg = dict(TINY_CONFIGS["nt-tiny"], name="nt-small")
    (copy / "benchmark/configs/nt-small.json").write_text(json.dumps(cfg))
    (copy / "benchmark/traffic/locate9.json").write_text(json.dumps(dict(TINY_TRAFFIC["l10"], length=9)))
    (copy / "benchmark/metrics/request_count.py").write_text(
        "def read(ctx):\n    return float(ctx.layers['ranges']['device_ms'] > 0) or None\n")
    m = json.loads((copy / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "nt-small", "source": "tiny", "file": "benchmark/configs/nt-small.json",
                         "reduced": [], "why": "tiny"})
    m["workloads"].append({"name": "nt-small.locate9", "config": "nt-small", "traffic": "locate9",
                           "chips": 1, "why": "tiny"})
    for e in m["end_to_end"]:
        if "workloads" in e and e["name"] == "locate_qps":
            e["workloads"].append("nt-small.locate9")
    m["per_layer"].append({"name": "request_count.locate", "unit": "1", "better": "higher",
                           "source": "device_trace", "layer": "ranges", "moves": "locate_qps",
                           "workloads": ["nt-small.locate9"]})
    (copy / "BENCHMARK.json").write_text(json.dumps(m))
    code = (
        "import sys, time, json, torch\n"
        "from benchmark.harness import main, manifest\n"
        "m = manifest.load()\n"
        "assert manifest.validate(m) == [], manifest.validate(m)\n"
        "res, checks = main.run_cell(m, 'nt-small.locate9', 2**31 + 1, 0.05, False,\n"
        "    device=torch.device('cpu'), t0=time.perf_counter(), cache_root=sys.argv[1])\n"
        "sys.exit(main.finish(res, checks))\n"
    )
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(copy), ROOT]))
    r = subprocess.run([sys.executable, "-c", code, str(tmp_path / "cache")], cwd=copy,
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and set(line["metrics"]) == {"locate_qps", "request_p95_ms", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before


@pytest.mark.card
def test_control_and_sound_run_on_the_card(tmp_path, cuda_device):
    m = tiny_manifest(str(tmp_path))
    sound, checks = run_tiny((m, str(tmp_path)), "nt-tiny.l5", device=cuda_device)
    assert sound["correct"], checks
    control, checks = run_tiny((m, str(tmp_path)), "nt-tiny.l5", control="first_hit", device=cuda_device)
    assert not control["correct"], checks

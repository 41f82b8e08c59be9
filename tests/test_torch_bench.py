"""Port parity: the measurement path — capacity planner, roofline, metrics,
the CLIs and the bench protocol — against the JAX package.

The planner's byte counts must equal both the JAX function and the
``nbytes`` of the port's own tensors; the roofline's row model must equal
the JAX formulas and the port's row widths, with every calibrated
fraction a ceiling; the engine must count its queries as the JAX engine
does; ``tools/bench.py`` must run its whole protocol on the CPU at a tiny
size and print the JSON lines of ``bench.py``; and no module of the port
may import jax or read one of the JAX bench's ``AWFM_*`` knobs.
"""

import ast
import json
import os
import re

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.utils import capacity as jcap
from avxwindowfmindex_tpu.utils import roofline as jroof
from avxwindowfmindex_tpu_torch.tools import bench as pbench
from avxwindowfmindex_tpu_torch.tools import build_index as pbuild_cli
from avxwindowfmindex_tpu_torch.tools import gather_probe as pprobe_cli
from avxwindowfmindex_tpu_torch.tools import time_search as psearch_cli
from avxwindowfmindex_tpu_torch.utils import capacity as pcap
from avxwindowfmindex_tpu_torch.utils import metrics as pmetrics
from avxwindowfmindex_tpu_torch.utils import roofline as proof

from oracle import random_sequence
from torch_helpers import configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DNA = jx.AlphabetType.DNA
V5E = jcap.HBM_BYTES["v5e"]


# ---------------------------------------------------------------------------
# capacity planner
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(seed_k=14, sa_ratio=8, device_sa_ratio=4, ngram=True),
    dict(seed_k=12, sa_ratio=8, device_sa_ratio=None, ngram=False, pair_rows=False),
    dict(seed_k=13, sa_ratio=16, device_sa_ratio=2, ngram=True, ngram_n=3),
], ids=["k14-dense-ngram", "k12-classic", "k13-n3"])
@pytest.mark.parametrize("num_bases", [64_000_000, 3_100_000_000])
def test_component_bytes_equal_jax(num_bases, kw):
    assert pcap.component_bytes(num_bases, pt.AlphabetType.DNA, **kw) == jcap.component_bytes(
        num_bases, DNA, **kw
    )
    amino = dict(seed_k=5, sa_ratio=8, device_sa_ratio=4)
    assert pcap.component_bytes(num_bases, pt.AlphabetType.AMINO, **amino) == jcap.component_bytes(
        num_bases, jx.AlphabetType.AMINO, **amino
    )


def test_component_bytes_equal_port_tensors():
    seq = random_sequence(np.random.default_rng(12), 5000, DNA, clean=True)
    _, pcfg = configs(8, 4, DNA)
    idx = pt.create_index(seq, pcfg, device_sa_ratio=2, device="cpu")
    dev = idx.to_device("cpu")
    ng = pt.build_ngram_device(idx, 2, device="cpu")
    comp = pcap.component_bytes(len(seq), pt.AlphabetType.DNA, seed_k=4, sa_ratio=8,
                                device_sa_ratio=2, ngram=True)

    def nbytes(t):
        return t.numel() * t.element_size()

    assert comp == {
        "packed": nbytes(dev.packed), "packed_pair": nbytes(dev.packed_pair),
        "ngram": nbytes(ng.packed), "seed_table": nbytes(dev.seed_table),
        "sampled_sa": nbytes(dev.sampled_sa),
    }


@pytest.mark.parametrize("case", [
    dict(num_bases=64_000_000, hbm_bytes=V5E, batch=1 << 22),
    dict(num_bases=3_100_000_000, hbm_bytes=V5E, batch=1 << 22),
    dict(num_bases=3_100_000_000, hbm_bytes=jcap.HBM_BYTES["v5p"], batch=1 << 22),
    dict(num_bases=3_100_000_000, hbm_bytes=int(13e9), batch=1 << 20),
    dict(num_bases=3_100_000_000, hbm_bytes=int(8e9), batch=1 << 20),
    dict(num_bases=3_100_000_000, hbm_bytes=int(6.2e9), batch=1 << 20),
    dict(num_bases=16_000_000, alphabet="AMINO", hbm_bytes=V5E, batch=1 << 20, kmer_len=20),
    dict(num_bases=64_000_000, hbm_bytes=V5E, batch=1 << 20, kmer_len=12),
    dict(num_bases=1_000_000, hbm_bytes=V5E, batch=1 << 16),
], ids=["64M", "hg38", "hg38-v5p", "ladder-13G", "ladder-8G", "ladder-6.2G", "amino", "short-kmer", "1M"])
def test_plan_picks_equal_jax(monkeypatch, case):
    """The narrow, replicated cases of tests/test_capacity.py, with the
    same budget passed in and the same workspace slack, pick the same
    seed k, dense SA and n-gram table as the JAX planner."""
    monkeypatch.setattr(pcap, "_WORKSPACE_SLACK_BYTES", jcap._XLA_SLACK_BYTES)
    case = dict(case)
    alphabet = case.pop("alphabet", "DNA")
    want = jcap.plan_capacity(alphabet=jx.AlphabetType[alphabet], **case)
    got = pcap.plan_capacity(alphabet=pt.AlphabetType[alphabet], **case)
    assert (got.seed_k, got.device_sa_ratio, got.ngram, got.pair_rows) == (
        want.seed_k, want.device_sa_ratio, want.ngram, want.pair_rows
    )
    assert got.components == want.components and got.budget == want.budget
    cfg = got.index_configuration()
    assert cfg.kmer_length_in_seed_table == got.seed_k
    assert "replicated" in got.summary()


def test_plan_on_an_h100_budget():
    plan = pcap.plan_capacity(64_000_000, hbm_bytes=80 * 2**30, batch=1 << 22)
    assert (plan.seed_k, plan.device_sa_ratio, plan.ngram) == (14, 4, True)


def test_planner_assumes_no_device_memory():
    with pytest.raises(ValueError, match="hbm_bytes"):
        pcap.detect_hbm_bytes("cpu")
    with pytest.raises(ValueError, match="hbm_bytes"):
        pcap.plan_capacity(64_000_000, device="cpu")
    with pytest.raises(ValueError, match="device or hbm_bytes"):
        pcap.plan_capacity(64_000_000)
    # a plan over several devices needs a budget as much as one does; a
    # corpus one device holds stays replicated
    with pytest.raises(ValueError, match="device or hbm_bytes"):
        pcap.plan_capacity(64_000_000, n_devices=8)
    plan = pcap.plan_capacity(64_000_000, hbm_bytes=V5E, n_devices=8)
    assert (plan.engine, plan.n_devices, plan.per_chip_bytes) == (
        "replicated", 8, plan.index_bytes)


@pytest.mark.parametrize("case", [
    dict(num_bases=5_000_000_000, hbm_bytes=V5E, batch=1 << 20),
    dict(num_bases=5_000_000_000, hbm_bytes=80 * 2**30, batch=1 << 22),
    dict(num_bases=6_200_000_000, hbm_bytes=int(40e9), batch=1 << 22),
    dict(num_bases=5_000_000_000, alphabet="AMINO", hbm_bytes=80 * 2**30, batch=1 << 20, kmer_len=20),
    dict(num_bases=20_000_000_000, hbm_bytes=80 * 2**30, batch=1 << 22),
    # one card holds this amino corpus on the compact 384 B rows only
    dict(num_bases=5_000_000_000, alphabet="AMINO", hbm_bytes=int(16e9), batch=1 << 20,
         kmer_len=20, pair_rows=False),
], ids=["5G-16GB", "5G-80GiB", "6.2G-40GB", "amino-5G", "20G-no-dense", "amino-5G-compact"])
def test_wide_plan_picks_equal_jax(monkeypatch, case):
    """A corpus of 2^32 positions and more gets a wide plan with the JAX
    planner's component bytes: 16 B seed entries, 8 B SA entries, one
    table of wide rows, no n-gram candidate; pair-fused rows, or the
    compact amino rows where only they fit (``pair_rows`` of the case)."""
    monkeypatch.setattr(pcap, "_WORKSPACE_SLACK_BYTES", jcap._XLA_SLACK_BYTES)
    case = dict(case)
    alphabet = case.pop("alphabet", "DNA")
    pair_rows = case.pop("pair_rows", True)
    want = jcap.plan_capacity(alphabet=jx.AlphabetType[alphabet], **case)
    got = pcap.plan_capacity(alphabet=pt.AlphabetType[alphabet], **case)
    assert got.wide and want.wide and not got.ngram
    assert got.pair_rows == want.pair_rows == pair_rows
    assert (got.seed_k, got.device_sa_ratio) == (want.seed_k, want.device_sa_ratio)
    assert got.components == want.components and got.budget == want.budget
    assert set(got.components) == {"packed", "seed_table", "sampled_sa"}
    assert "wide" in got.summary()


@pytest.mark.parametrize("case", [
    dict(num_bases=5_000_000_000, alphabet="AMINO", hbm_bytes=int(16e9), batch=1 << 20,
         kmer_len=20),
    dict(num_bases=3_000_000_000, hbm_bytes=int(6e9), batch=1 << 20),
], ids=["amino-wide-compact", "dna-narrow-no-pair-rows"])
def test_plans_without_pair_rows_equal_jax_and_build(monkeypatch, case):
    """A corpus one card holds only without pair rows: the port's plan is
    the JAX planner's (seed k, pair_rows, components, budget), and the
    port builds the view that plan names, at a small scale, with the
    plan's bytes per row: the compact 384 B amino wide rows, or narrow
    block rows with no pair table."""
    monkeypatch.setattr(pcap, "_WORKSPACE_SLACK_BYTES", jcap._XLA_SLACK_BYTES)
    case = dict(case)
    alphabet = case.pop("alphabet", "DNA")
    want = jcap.plan_capacity(alphabet=jx.AlphabetType[alphabet], **case)
    got = pcap.plan_capacity(alphabet=pt.AlphabetType[alphabet], **case)
    assert not got.pair_rows and not want.pair_rows
    assert (got.seed_k, got.device_sa_ratio, got.ngram, got.wide, got.engine) == (
        want.seed_k, want.device_sa_ratio, want.ngram, want.wide, want.engine)
    assert got.components == want.components and got.budget == want.budget
    assert "pair_rows=off" in got.summary()
    palpha = pt.AlphabetType[alphabet]
    seq = random_sequence(np.random.default_rng(31), 4000, jx.AlphabetType[alphabet], clean=True)
    idx = pt.create_index(seq, pt.IndexConfiguration(8, 3, palpha), device="cpu")
    dev = idx.to_device("cpu", wide=got.wide, pair_rows=got.pair_rows)
    assert dev.packed_pair is None and not dev.pair_rows and dev.wide == got.wide
    small = pcap.component_bytes(len(seq), palpha, seed_k=3, sa_ratio=8, pair_rows=False,
                                 wide=got.wide)
    assert small == {"packed": dev.packed.numel(),
                     "seed_table": dev.seed_table.numel() * dev.seed_table.element_size(),
                     "sampled_sa": dev.sampled_sa.numel() * dev.sampled_sa.element_size()}
    if got.wide:
        assert dev.packed.shape[1] == 384 and not dev.pair_fused


def test_wide_component_bytes_equal_jax_and_port_tensors():
    for alphabet, k in (("DNA", 12), ("AMINO", 5)):
        kw = dict(seed_k=k, sa_ratio=8, device_sa_ratio=4)
        assert pcap.component_bytes(5_000_000_000, pt.AlphabetType[alphabet], **kw) == (
            jcap.component_bytes(5_000_000_000, jx.AlphabetType[alphabet], **kw)
        )
    # forced wide on a small index: the figures are the tensors' bytes
    seq = random_sequence(np.random.default_rng(13), 5000, DNA, clean=True)
    _, pcfg = configs(8, 4, DNA)
    dev = pt.create_index(seq, pcfg, device_sa_ratio=2, device="cpu").to_device("cpu", wide=True)
    comp = pcap.component_bytes(len(seq), pt.AlphabetType.DNA, seed_k=4, sa_ratio=8,
                                device_sa_ratio=2, wide=True)
    assert comp == {
        "packed": dev.packed.numel(), "seed_table": dev.seed_table.numel() * 8,
        "sampled_sa": dev.sampled_sa.numel() * 8,
    }
    with pytest.raises(ValueError, match="narrow-only"):
        pcap.component_bytes(5_000_000_000, seed_k=12, ngram=True)
    # the compact wide rows (the range-sharded engine's) equal the JAX figure
    assert pcap.component_bytes(5_000_000_000, seed_k=12, pair_rows=False) == (
        jcap.component_bytes(5_000_000_000, seed_k=12, pair_rows=False))


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kmer_len,seed_k,n,pair", [
    (25, 12, 2, True), (25, 13, 2, True), (25, 12, 1, True), (25, 12, 1, False),
    (25, 12, 2, False), (25, 14, 3, True), (11, 1, 1, False), (12, 12, 1, True),
])
def test_range_phase_rows_equal_jax(kmer_len, seed_k, n, pair):
    assert proof.range_phase_rows(kmer_len, seed_k, ngram_n=n, pair_rows=pair) == \
        jroof.range_phase_rows(kmer_len, seed_k, ngram_n=n, pair_rows=pair)


def test_table_row_bytes_equal_jax_and_port_tensors():
    for alphabet, n in ((DNA, 2), (DNA, 3), (jx.AlphabetType.AMINO, 1)):
        assert proof.table_row_bytes(pt.AlphabetType(int(alphabet)), ngram_n=n) == \
            jroof.table_row_bytes(alphabet, ngram_n=n)
    seq = random_sequence(np.random.default_rng(13), 2000, DNA, clean=True)
    _, pcfg = configs(8, 3, DNA)
    idx = pt.create_index(seq, pcfg, device="cpu")
    dev = idx.to_device("cpu")
    ng = pt.build_ngram_device(idx, 2, device="cpu")
    rb = proof.table_row_bytes(ngram_n=2)
    assert rb == {"single": dev.packed.shape[1], "pair": dev.packed_pair.shape[1],
                  "ngram_pair": ng.packed.shape[1]}


RATES = {"single": 250e6, "pair": 120e6, "ngram_pair": 60e6}
ROWB = {"single": 128, "pair": 256, "ngram_pair": 384}
H100 = proof.CHIPS["h100"]


def test_report_fractions_are_ceilings():
    kw = dict(kmer_len=25, seed_k=12, ratio=8, ngram_n=2, pair_rows=True,
              locate_positions_per_query=1.0, row_bytes=ROWB, rates=RATES, chip=H100)
    rep = proof.report(3.2e6, **kw)
    assert rep["calibrated"] and rep["fraction_of_gather_ceiling"] <= 1.0
    assert 0 < rep["fraction_of_hbm_sol"] < 0.2
    assert set(rep["phases"]) == {"range", "backtrace"}
    assert abs(sum(p["share_of_gather_time"] for p in rep["phases"].values()) - 1.0) < 0.01
    # K3's model: ratio - 1 block rows per position, one 4 B resolve
    assert rep["phases"]["backtrace"]["rows_per_query"] == 7.0
    assert rep["phases"]["backtrace"]["bytes_per_query"] == 7 * 128 + 4
    # every stage of the bench at its own ceiling reports 1.0
    for stage in (dict(ngram_n=1, locate_positions_per_query=0.0),
                  dict(ngram_n=2, locate_positions_per_query=0.0),
                  dict(ngram_n=2, locate_positions_per_query=1.0),
                  dict(ngram_n=2, locate_positions_per_query=1.0625),
                  dict(ngram_n=1, seed_k=1, pair_rows=False, kmer_len=11,
                       locate_positions_per_query=16.5)):
        skw = {**kw, **stage}
        ceiling = proof.report(1.0, **skw)["gather_ceiling_qps"]
        assert abs(proof.report(ceiling, **skw)["fraction_of_gather_ceiling"] - 1.0) < 0.01
        assert proof.report(0.5 * ceiling, **skw)["fraction_of_gather_ceiling"] <= 1.0


def test_first_block_visits_name_the_sectors_a_step_reads():
    """Per table: the first 32 B sector of each plane and the sector of
    the milestones, against the layouts written out by hand."""
    assert proof.first_block_visits(ngram_n=2) == {
        "single": (0b1111, 128),  # 3 planes x 32 B, milestones at 96: the whole row
        "pair": (0b1010101, 128),  # planes at 0, 64, 128, milestones at 192
        # K4's rows: the 5 planes' first 32 B at 0-159, word 8's milestone at 192
        "ngram_pair": (0b1011111, 192),
    }
    # 7 planes' first 32 B at 0-223, word 32's milestone at 224 + 128
    assert proof.first_block_visits(ngram_n=3)["ngram_pair"] == (0b100001111111, 256)
    amino = proof.first_block_visits(pt.AlphabetType.AMINO)
    assert amino == {"single": (0b111111, 192), "pair": (0b10101010101, 192)}
    for alphabet, n in ((pt.AlphabetType.DNA, 2), (pt.AlphabetType.DNA, 3), (pt.AlphabetType.AMINO, 1)):
        rb = proof.table_row_bytes(alphabet, ngram_n=n)
        for t, (mask, nbytes) in proof.first_block_visits(alphabet, ngram_n=n).items():
            assert mask < 1 << (rb[t] // 32) and nbytes <= rb[t]


def test_report_with_visit_bytes_against_a_hand_computed_case():
    """25-mers at k = 14, n = 2, ratio 8, one position per query: 5 n-gram
    visits of 192 B, 1 pair visit of 128 B, 7 block rows of 128 B and the
    4 B resolve; rates are per visit and do not change with the bytes."""
    kw = dict(kmer_len=25, seed_k=14, ratio=8, ngram_n=2, locate_positions_per_query=1.0,
              row_bytes=ROWB, rates=RATES, chip=H100)
    visit = {"single": 128, "pair": 128, "ngram_pair": 192}
    rep = proof.report(1e8, visit_bytes=visit, **kw)
    assert rep["phases"]["range"]["bytes_per_query"] == 5 * 192 + 128 == 1088
    assert rep["phases"]["backtrace"]["bytes_per_query"] == 7 * 128 + 4
    assert rep["bytes_per_query"] == 1088 + 900 and rep["rows_per_query"] == 13.0
    assert rep["hbm_speed_of_light_qps"] == round(3350e9 / 1988)
    assert rep["fraction_of_hbm_sol"] == round(1e8 / (3350e9 / 1988), 4)
    secs = 5 / RATES["ngram_pair"] + 1 / RATES["pair"] + 7 / RATES["single"]
    assert rep["gather_ceiling_qps"] == round(1 / secs)
    # the default charges whole rows, as before: 5 x 384 + 256 in the range phase
    whole = proof.report(1e8, **kw)
    assert whole["phases"]["range"]["bytes_per_query"] == 5 * 384 + 256 == 2176
    assert whole == proof.report(1e8, visit_bytes=ROWB, **kw)
    assert whole["gather_ceiling_qps"] == rep["gather_ceiling_qps"]
    assert whole["fraction_of_hbm_sol"] > rep["fraction_of_hbm_sol"]
    # a table the caller names no visit for keeps its whole row
    part = proof.report(1e8, visit_bytes={"ngram_pair": 192}, **kw)
    assert part["phases"]["range"]["bytes_per_query"] == 5 * 192 + 256


def test_report_uncalibrated_and_zero_gather():
    rep = proof.report(1e6, kmer_len=25, seed_k=12, ratio=8, ngram_n=2, row_bytes=ROWB, chip=H100)
    assert rep["calibrated"] is False
    assert rep["gather_ceiling_qps"] is None and rep["fraction_of_gather_ceiling"] is None
    assert rep["hbm_speed_of_light_qps"] > 0  # the byte model stays
    off_card = proof.report(1e6, kmer_len=25, seed_k=12, ratio=8, row_bytes=ROWB,
                            rates=RATES, chip=proof.detect_chip("cpu"))
    assert off_card["hbm_speed_of_light_qps"] is None and off_card["chip"] == "cpu"
    zero = proof.report(1e6, kmer_len=12, seed_k=12, ratio=8, row_bytes=ROWB, chip=H100)
    assert zero["rows_per_query"] == 0.0 and zero["gather_ceiling_qps"] is None
    assert proof.backtrace_rows_per_position(1) == 0.0


def test_calibration_runs_on_every_table():
    seq = random_sequence(np.random.default_rng(14), 3000, DNA, clean=True)
    _, pcfg = configs(8, 3, DNA)
    idx = pt.create_index(seq, pcfg, device="cpu")
    dev = idx.to_device("cpu")
    rates = proof.calibrate_gather_rates(
        {"single": dev.packed, "pair": dev.packed_pair, "none": None},
        batch=256, device="cpu", runs=1, seg_lo=1, seg_hi=2,
    )
    assert set(rates) == {"single", "pair", "slab"} and all(r > 0 for r in rates.values())


def test_calibration_walks_the_masked_sectors(monkeypatch):
    """With sector masks the calibration hands each table's mask to K5's
    walk, and whole rows to a table without one."""
    from avxwindowfmindex_tpu_torch.ops import probes

    seen = {}
    real = probes.gather_walk

    def spy(table, idx, seg, mask=probes.ALL_SECTORS, lanes=1):
        assert lanes == 1  # the bench's walk: one lane a chain
        seen[table.shape[1]] = mask
        return real(table, idx, seg, mask, lanes)

    monkeypatch.setattr(probes, "gather_walk", spy)
    seq = random_sequence(np.random.default_rng(16), 3000, DNA, clean=True)
    _, pcfg = configs(8, 3, DNA)
    idx = pt.create_index(seq, pcfg, device="cpu")
    dev = idx.to_device("cpu")
    ng = pt.build_ngram_device(idx, 2, device="cpu")
    visits = proof.first_block_visits(ngram_n=2)
    rates = proof.calibrate_gather_rates(
        {"single": dev.packed, "pair": dev.packed_pair, "ngram_pair": ng.packed},
        batch=128, device="cpu", runs=1, seg_lo=1, seg_hi=2,
        sector_masks={"pair": visits["pair"][0], "ngram_pair": visits["ngram_pair"][0]},
    )
    assert seen == {128: probes.ALL_SECTORS, 256: 0b1010101, 384: 0b1011111}
    assert all(r > 0 for r in rates.values())


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_registry_and_switch():
    pmetrics.reset()
    pmetrics.counter("x").add(3)
    pmetrics.counter("x").inc()
    with pmetrics.timer("t"):
        pass
    snap = pmetrics.snapshot()
    assert snap["x"] == 4 and snap["t"] >= 0 and snap["t.calls"] == 1
    pmetrics.reset()
    pmetrics.set_enabled(False)
    try:
        pmetrics.counter("y").add(5)
        with pmetrics.timer("ty"):
            pass
        assert pmetrics.snapshot() == {}
    finally:
        pmetrics.set_enabled(True)


def test_engine_counts_queries_as_jax():
    """tests/test_metrics.py:36-52: the same counters after the same
    count and locate calls in both packages."""
    from avxwindowfmindex_tpu.utils import metrics as jmetrics

    seq = bytes(np.random.default_rng(15).choice(np.frombuffer(b"ACGT", np.uint8), size=600))
    jcfg, pcfg = configs(4, 3, DNA)
    jmetrics.reset()
    pmetrics.reset()
    je, pe = jx.SearchEngine(jx.create_index(seq, jcfg)), pt.SearchEngine(
        pt.create_index(seq, pcfg, device="cpu"), device="cpu"
    )
    for eng in (je, pe):
        eng.count([b"ACG", b"TTT"])
        eng.locate([b"ACG", b"GT"])
    want, got = jmetrics.snapshot(), pmetrics.snapshot()
    keys = ("search.count.queries", "search.locate.queries", "search.locate.hits",
            "search.count.seconds.calls", "search.locate.seconds.calls")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["search.count.queries"] == 2 and got["search.locate.hits"] > 0
    pmetrics.reset()
    jmetrics.reset()


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------

@pytest.fixture
def fasta(tmp_path):
    seq = random_sequence(np.random.default_rng(16), 800, DNA, clean=True)
    path = tmp_path / "g.fasta"
    with open(path, "w") as fh:
        fh.write(">chr_test\n")
        for i in range(0, len(seq), 60):
            fh.write(seq[i : i + 60].decode() + "\n")
    return str(path), seq


def test_build_index_cli(fasta, tmp_path, capsys):
    """tests/test_tools.py:23-35, on the port; the file equals JAX's."""
    from avxwindowfmindex_tpu.tools import build_index as jbuild_cli

    fasta_path, seq = fasta
    out, jout = str(tmp_path / "g.awfmi"), str(tmp_path / "j.awfmi")
    rc = pbuild_cli.main([fasta_path, "--output", out, "--seed-length", "4", "--ratio", "4",
                          "--device", "cpu"])
    assert rc == 0
    assert "bwtLength=801" in capsys.readouterr().out
    jbuild_cli.main([fasta_path, "--output", jout, "--seed-length", "4", "--ratio", "4"])
    assert open(out, "rb").read() == open(jout, "rb").read()
    index = pt.read_index_from_file(out)
    assert index.config.kmer_length_in_seed_table == 4
    assert pt.SearchEngine(index, device="cpu").count([seq[100:110]])[0] >= 1


def test_build_index_cli_raw_amino(tmp_path):
    seq = random_sequence(np.random.default_rng(17), 400, jx.AlphabetType.AMINO, clean=True)
    raw = tmp_path / "p.txt"
    raw.write_bytes(seq)
    out = str(tmp_path / "p.awfmi")
    assert pbuild_cli.main([str(raw), "--raw", "--amino", "--output", out, "--seed-length", "2",
                            "--ratio", "4", "--device", "cpu"]) == 0
    assert pt.read_index_from_file(out).config.alphabet_type == pt.AlphabetType.AMINO


@pytest.mark.parametrize("extra", [[], ["--count-only"], ["--ngram", "2"]])
def test_time_search_cli(fasta, tmp_path, capsys, extra):
    fasta_path, _ = fasta
    out = str(tmp_path / "g.awfmi")
    pbuild_cli.main([fasta_path, "--output", out, "--seed-length", "3", "--ratio", "4",
                     "--device", "cpu"])
    rc = psearch_cli.main([out, "-n", "50", "-k", "6", "--runs", "1", "--device", "cpu"] + extra)
    assert rc == 0
    text = capsys.readouterr().out
    assert "queries/s" in text and "50 kmers" in text


def test_tools_refuse_a_missing_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        pbench.main([])


# ---------------------------------------------------------------------------
# the bench protocol, end to end on the CPU
# ---------------------------------------------------------------------------

def _bench_meta_keys():
    """The keys of bench.py's meta dict (bench.py:734-777), read from its
    source without importing it."""
    tree = ast.parse(open(os.path.join(REPO, "bench.py")).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and any(
            isinstance(t, ast.Name) and t.id == "meta" for t in node.targets
        ):
            return [k.value for k in node.value.keys]
    raise AssertionError("bench.py has no meta dict")


def test_bench_end_to_end_on_cpu(capsys):
    rc = pbench.main([
        "--device", "cpu", "--bases", "200000", "--queries", "4096", "--runs", "1",
        "--seed-k", "6", "--multihit-queries", "512", "--calib-batch", "512",
        "--chunk-q", "1024",
    ])
    assert rc == 0
    captured = capsys.readouterr()
    lines = [json.loads(x) for x in captured.out.strip().splitlines()]
    assert len(lines) == 2
    meta, headline = lines[0]["meta"], lines[1]
    assert list(meta) == _bench_meta_keys()
    assert meta["device"] == "cpu" and meta["num_queries"] == 4096 and meta["seed_k"] == 6
    assert meta["device_sa_ratio"] == 4 and meta["locate_all_dense_sa_qps"] > 0
    assert meta["total_hits"] >= 4096 and meta["multihit_kmer_len"] == 11
    assert set(meta["gather_rates_rows_per_sec"]) == {"single", "pair", "ngram_pair", "slab"}
    assert not any("_routed" in k for k in meta["gather_rates_rows_per_sec"])
    for key in ("count_roofline", "count_ngram_roofline", "locate_roofline",
                "locate_all_roofline", "locate_all_dense_sa_roofline", "multihit_roofline"):
        assert meta[key]["calibrated"] and meta[key]["gather_ceiling_qps"] > 0
    assert headline["metric"] == "nt25_locate_all_queries_per_sec"
    assert headline["value"] == meta["locate_all_qps"]
    assert headline["vs_baseline"] == round(meta["locate_all_qps"] / 2.5e6, 3)
    assert "2.5M" in headline["baseline"]
    assert "cross-engine parity: single-step == n-gram" in captured.err
    assert "count spot check: 32/32 exact" in captured.err
    assert "multihit spot check: 64/64 sound" in captured.err


def test_bench_cache_warm_start_on_cpu(tmp_path, capsys):
    """--cache DIR: the first run builds and writes the .awfmx artifact and
    the n-gram rows under bench.py's AWFM_BENCH_CACHE names; the second
    loads both and every stage finds the same hits."""
    argv = ["--device", "cpu", "--bases", "100000", "--queries", "2048", "--runs", "1",
            "--seed-k", "5", "--multihit-queries", "256", "--calib-batch", "256",
            "--chunk-q", "1024", "--cache", str(tmp_path)]
    metas = []
    for _ in range(2):
        assert pbench.main(argv) == 0
        captured = capsys.readouterr()
        metas.append((json.loads(captured.out.splitlines()[0])["meta"], captured.err))
    assert sorted(os.listdir(tmp_path)) == ["b100000_k5_r8_d4.awfmx", "b100000_ng2_pb1.npz"]
    (first, err1), (second, err2) = metas
    assert "index built in" in err1 and "index cached in" in err1
    assert "index loaded from cache in" in err2 and "index built in" not in err2
    for key in ("num_queries", "seed_k", "device_sa_ratio", "total_hits", "multihit_kmer_len",
                "multihit_total_hits", "multihit_hits_per_query"):
        assert second[key] == first[key], key
    for err in (err1, err2):
        assert "cross-engine parity: single-step == n-gram" in err
        assert "count spot check: 32/32 exact" in err
        assert "multihit spot check: 64/64 sound" in err


def test_gather_probe_cli_on_cpu(capsys):
    assert pprobe_cli.main(["--device", "cpu", "--table-bytes", "65536", "--batch", "1024",
                            "--iters", "1", "--reps", "1"]) == 0
    recs = [json.loads(x) for x in capsys.readouterr().out.strip().splitlines()]
    assert [r["probe"] for r in recs] == ["P2"] * 4 + ["P4"] * 3 + ["P3"] * 3 + ["P5"] * 2
    assert all(r["equal"] and r["device"] == "cpu" for r in recs)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_port_imports_no_jax_and_reads_no_bench_knob():
    """Every module of the port, scanned: no import of jax or of the JAX
    package, and no environment read of an AWFM_* variable (the JAX
    bench's knobs are argparse flags here). The one exception is no knob
    but a path: ``AWFM_REFERENCE_SRC``, where the reference C sources lie,
    read by tools/golden_parity.py alone, as the JAX package's tool
    reads it."""
    pkg = os.path.join(REPO, "avxwindowfmindex_tpu_torch")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg) for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    assert len(files) > 20
    golden = os.path.join(pkg, "tools", "golden_parity.py")
    assert golden in files
    for path in files:
        src = open(path).read()
        allowed = {"AWFM_REFERENCE_SRC"} if path == golden else set()
        for node in ast.walk(ast.parse(src)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "avxwindowfmindex_tpu"), (path, name)
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                if re.fullmatch(r"AWFM_[A-Z_]+", node.value) and node.value not in allowed:
                    raise AssertionError(f"{path} names the environment knob {node.value}")
        reads = re.findall(r"(?:environ|getenv)[^\n]*?(AWFM_[A-Z_]+)", src)
        assert set(reads) <= allowed, (path, reads)

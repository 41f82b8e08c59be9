"""The A/B tool ``tools/kernel_ab.py`` on a machine without CUDA: its
argument parsing and case list, and the CPU parts of its K3w cases (the
compact rows it times K3w over, and the walk's models) against the JAX
package. Its timings run only on the card; here ``main`` must refuse.
Every quantity compared is an integer: tolerance 0.
"""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
from avxwindowfmindex_tpu import search64
from avxwindowfmindex_tpu.ops import rank64 as r64
from avxwindowfmindex_tpu_torch import search as psearch
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.tools import kernel_ab
from avxwindowfmindex_tpu_torch.utils import roofline

from oracle import random_sequence
from torch_helpers import build_both

DNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.AMINO


@pytest.mark.parametrize("case", ["all", "bfs", "rs", "k3w", "k5", "pairless", "k1", "k4rows"])
def test_every_case_parses(case):
    assert case in kernel_ab.CASES
    assert kernel_ab.parse_args(["--cases", case]).cases == case


def test_case_list_and_defaults():
    assert kernel_ab.CASES == ("all", "bfs", "rs", "k3w", "k5", "pairless", "k1", "k4rows")
    args = kernel_ab.parse_args([])
    assert args.cases == "all" and args.other == [] and args.reps == 10
    assert args.bases == 64_000_000 and args.queries == 1 << 20 and args.seed_k == 14
    # the wide table beyond the L2: 2^28 bases, 1,048,576 rows x 256 B
    assert kernel_ab.BIG_BASES == 1 << 28
    # the big index is cached under the package's build directory, which
    # git ignores
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(kernel_ab.__file__)))
    assert os.path.dirname(args.cache) == os.path.join(pkg, "build")
    got = kernel_ab.parse_args(["--other", "parent=build/parent", "--other", "b=x=y",
                                "--cache", "somewhere"])
    assert got.other == ["parent=build/parent", "b=x=y"] and got.cache == "somewhere"


def test_k1_case_arguments():
    """``--cases k1`` with a parent checkout, as the README runs it: the
    parent and the case parse, the traces go under ``--cache``, and the
    amino index is phase 4p's 2^26 residues."""
    got = kernel_ab.parse_args(["--other", "parent=build/parent", "--cases", "k1", "--reps", "5"])
    assert got.cases == "k1" and got.other == ["parent=build/parent"] and got.reps == 5
    assert got.bases == 64_000_000 and got.seed_k == 14
    assert kernel_ab.K1_AMINO_RESIDUES == 1 << 26


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_k1_case_routes_agree_on_the_cpu(wide):
    """The route the k1 case times the step mode against (the batched step
    over K1's occ mode on a one-element batch, ``occ_route_step`` /
    ``occ_route_lf``) gives the API's answers, walk for walk, on the CPU."""
    import avxwindowfmindex_tpu_torch as pt

    rng = np.random.default_rng(0xA1)
    seq = random_sequence(rng, 3000, DNA)
    _, p = build_both(seq, 4, 3, DNA)
    arr = np.frombuffer(seq, np.uint8)
    walks = [r.tobytes() for r in kernel_ab._sampled(rng, arr, 9, 4)]
    lf_pos = [0, 1, int(p.bwt_length) - 1, *rng.integers(0, p.bwt_length, 8).tolist()]
    kw = dict(device="cpu", wide=wide)
    new = kernel_ab.walk_calls(p, walks, lf_pos, kw, pt.iterative_step_backward_search,
                               pt.backtrace_return_previous_letter_index)
    old = kernel_ab.walk_calls(p, walks, lf_pos, kw, kernel_ab.occ_route_step,
                               kernel_ab.occ_route_lf)
    assert len(new[0]) == 4 * 8 and len(new[1]) == len(lf_pos)
    assert new[2] == old[2]
    engine = psearch.SearchEngine(p, **kw)
    assert new[2][:4] == [(int(s), int(e)) for s, e in engine.find_ranges(walks)]


@pytest.mark.parametrize("argv", [["--cases", "k4"], ["--other", "parent"], ["--reps", "x"]],
                         ids=["unknown-case", "other-without-dir", "reps-not-int"])
def test_bad_arguments_exit(argv):
    with pytest.raises(SystemExit):
        kernel_ab.parse_args(argv)


def test_main_refuses_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a GPU"):
        kernel_ab.main(["--cases", "k5"])


def test_compact_pieces():
    # nucleotide: planes at 0, 32, 64 and A-T's milestones at 96-127 lie in
    # two 64 B pieces; amino: five planes in three, the milestone in a
    # fourth for 16 of 20 letters
    assert kernel_ab.compact_pieces(3, 4) == 2.0
    assert kernel_ab.compact_pieces(5, 20) == 3.8


@pytest.fixture(scope="module", params=[(DNA, 3000, 3), (AMINO, 2500, 2)], ids=["DNA", "AMINO"])
def index_pair(request):
    alphabet, n, k = request.param
    seq = random_sequence(np.random.default_rng(0xAB + n), n, alphabet)
    j, p = build_both(seq, 8, k, alphabet)
    jdev = j.to_device(refresh=True, wide=True)
    j._device_cache = None
    return j, p, jdev


def test_compact_view_rows_equal_jax(index_pair):
    j, p, _ = index_pair
    wide = p.to_device("cpu", wide=True)
    compact = kernel_ab.compact_view(p, wide)
    want = r64.pack_device_blocks64(j.bwt_letters, j.milestones(), j.alphabet, pair=False)
    assert compact.packed.numpy().tobytes() == np.asarray(want).tobytes()
    assert compact.packed_pair is None and not compact.pair_fused and compact.wide
    pos = torch.from_numpy(np.random.default_rng(3).integers(0, wide.bwt_length, 400))
    # the walk over the compact rows gives the pair-fused rows' answers
    assert torch.equal(psearch.backtrace_resolve(compact, pos), psearch.backtrace_resolve(wide, pos))
    # the compact view takes K3w's compact form, the pair-fused one K3w; the
    # wrapper takes CUDA tensors only, and refuses before any build
    assert kernels.form_of(compact, kernels.K3) is kernels.K3W_COMPACT
    assert kernels.form_of(wide, kernels.K3) is kernels.K3W
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k3_backtrace_resolve(compact, pos)
    assert all(k.launches == 0 for k in kernels.KERNELS)


def test_k3w_model_counts_the_jax_walk(index_pair):
    _, p, jdev = index_pair
    wide = p.to_device("cpu", wide=True)
    pos = np.random.default_rng(4).integers(0, wide.bwt_length, 500).astype(np.uint64)
    model = kernel_ab.k3w_model(wide, torch.from_numpy(pos.view(np.int64)))
    hi, lo = r64.split_u64_host(pos)
    _, _, off = search64.backtrace_all64(jdev, jnp.asarray(hi), jnp.asarray(lo))
    steps = int(np.asarray(off).sum())
    assert model["hits"] == 500 and model["lf_steps"] == steps > 0
    assert model["pieces_per_visit"] == wide.n_planes + 1
    assert model["piece_model_ms"] == pytest.approx(steps * (wide.n_planes + 1) * 64 / 3.35e9)
    assert model["table_bytes"] == wide.packed.numel()
    assert 0 < model["bound_ms"] < model["piece_model_ms"]


def test_first_block_masks_match_the_row_layouts():
    """``roofline.first_block_visits``' masks of the compact wide row and of
    the n = 3 n-gram row name the sectors those rows hold a first-block
    visit's bytes in: the first 32 B of each plane, as
    ``pack_device_blocks64(pair=False)`` and K4's ``_geometry_k4(3)`` lay
    them out, and the sector of one milestone (the middle letter's, the
    middle word's), and no other."""
    from avxwindowfmindex_tpu_torch.models import alphabet as palpha
    from avxwindowfmindex_tpu_torch.models import index as pindex
    from avxwindowfmindex_tpu_torch.ops import ngram as pngram
    from avxwindowfmindex_tpu_torch.utils import roofline

    def sectors(mask):
        return {s for s in range(32) if mask >> s & 1}

    rng = np.random.default_rng(0xAB5)
    for alphabet in (AMINO, DNA):
        seq = random_sequence(rng, 2000, alphabet)
        _, p = build_both(seq, 8, 2, alphabet)
        rows = pindex.pack_device_blocks64(p.bwt_letters, p.milestones(), p.alphabet, pair=False)
        n_planes, card = palpha.num_bit_planes(p.alphabet), palpha.cardinality(p.alphabet)
        mask, nbytes = roofline.first_block_visits(p.alphabet, compact=True)["compact"]
        codes = palpha.index_to_vector_lut(p.alphabet)[p.bwt_letters]
        codes = np.concatenate([codes, np.zeros(rows.shape[0] * 256 - len(codes), np.uint8)])
        for i in range(n_planes):  # plane i's bits of each block in sector i
            bits = np.packbits(((codes >> i) & 1).reshape(-1, 256), axis=1, bitorder="little")
            np.testing.assert_array_equal(rows[:, 32 * i : 32 * i + 32], bits)
        off = n_planes * 32 + 8 * (card // 2)  # the middle letter's u64 milestone
        np.testing.assert_array_equal(rows[:, off : off + 8].copy().view("<u8")[:, 0],
                                      p.milestones()[:, card // 2])
        assert sectors(mask) == set(range(n_planes)) | {off // 32} and off % 32 + 8 <= 32
        assert nbytes == 32 * (n_planes + 1) and rows.shape[1] == pindex.device_row_bytes64(
            p.alphabet, False)
    # K4's n = 3 n-gram row: 7 planes, each block's first 32 B at 32 i,
    # then the milestones at 224 (ops/ngram.py:_geometry_k4); word 32's
    # stands for them
    seq = random_sequence(rng, 3000, DNA)
    _, p = build_both(seq, 8, 3, DNA)
    codes, _ = pngram.build_ngram_host(p, 3)
    blocks = pngram.pack_ngram_blocks(codes, 3)
    rows = pngram.k4_rows(torch.from_numpy(pngram.pair_rows_from_ngram_blocks(blocks, 3)), 3).numpy()
    ng_planes, ms_offset, _, row_bytes = pngram._geometry_k4(3)
    _, _, _, block_ms_offset, _ = pngram._geometry(3)
    mask, nbytes = roofline.first_block_visits(ngram_n=3)["ngram_pair"]
    assert ng_planes == 7 and row_bytes == rows.shape[1] == 768
    for i in range(ng_planes):
        np.testing.assert_array_equal(rows[:, 32 * i : 32 * i + 32], blocks[:, 32 * i : 32 * i + 32])
    off = ms_offset + 4 * 32
    np.testing.assert_array_equal(rows[:, off : off + 4], blocks[:, block_ms_offset + 128 : block_ms_offset + 132])
    assert sectors(mask) == set(range(ng_planes)) | {off // 32}
    assert nbytes == 256 and kernel_ab.mask_pieces(mask) == 5
    assert kernel_ab.mask_pieces(roofline.first_block_visits(AMINO, compact=True)["compact"][0]) == 4


def test_kernel_registers_read_the_ptxas_report():
    """The pairless case's register lines: each matching entry of an
    ``-Xptxas -v`` report with its template arguments, registers and
    spills; entries that do not match are left out."""
    log = "\n".join([
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_128k4_block_ngram_ranges_kernelILi3ELi3ELi8EEEv11AwfmTables' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_128k4_block_ngram_ranges_kernel",
        "    16 bytes stack frame, 8 bytes spill stores, 12 bytes spill loads",
        "ptxas info    : Used 128 registers, used 0 barriers, 424 bytes cmem[0]",
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_116k2_ranges_kernelINS_11WideCompactELi5ELi2ELi8ELb0EEEv11AwfmTables' "
        "for 'sm_90a'",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 64 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113k1_occ_kernelI6NarrowLi3EEEv' "
        "for 'sm_90a'",
        "ptxas info    : Used 30 registers",
    ])
    assert kernel_ab.kernel_registers(log, "k4_block_ngram_ranges_kernel") == [
        {"kernel": "k4_block_ngram_ranges_kernel<3, 3, 8>", "registers": 128, "spill_bytes": 20}]
    assert kernel_ab.kernel_registers(log, "k2_ranges_kernel", "WideCompact") == [
        {"kernel": "k2_ranges_kernel<WideCompact, 5, 2, 8, 0>", "registers": 64, "spill_bytes": 0}]
    assert kernel_ab.kernel_registers(log, "k4_ngram_ranges_kernel") == []
    assert kernel_ab.kernel_registers("", "k2_ranges_kernel") == []


def test_pairless_models_on_the_cpu():
    """The pairless case's models from a run's numbers: row visits at the
    calibrated rates plus the fixed launch, each checkout's better time
    over it, and the bytes bound."""
    line = kernel_ab.visit_model({"ngram2": 5_000_000, "block": 1_000_000},
                                 {"ngram2": 1e10, "block": 2e10}, 0.05,
                                 {"this": [0.6, 0.55], "parent": [0.7, 0.66]})
    assert line["row_visits_ms"] == pytest.approx(0.5 + 0.05)
    assert line["model_ms"] == pytest.approx(0.6)
    assert line["ms"] == {"this": 0.55, "parent": 0.66}
    assert line["ms_over_model"]["parent"] == pytest.approx(1.1)
    # every row visited: the table once, plus the stream
    assert kernel_ab.bytes_bound_ms([(1000, 100, 10**9)], 335) == pytest.approx(
        (1000 * 100 + 335) / 3.35e12 * 1e3)
    assert kernel_ab.bytes_bound_ms([], 0) == 0


def test_pairless_case_runs_on_the_cpu(monkeypatch, capsys):
    """``--cases pairless`` end to end on a small index, each checkout's
    kernels stood in for by the plain versions and CUDA events by the
    host clock: every line it prints, the registers, the calibration over
    the four tables, each K4 and K2w case and its model, in order."""
    import json
    import time
    import types

    from avxwindowfmindex_tpu_torch import AlphabetType as PA, IndexConfiguration, create_index

    log = ("ptxas info    : Compiling entry function "
           "'_ZN12_GLOBAL__N_128k4_block_ngram_ranges_kernelILi2ELi3ELi8EEEv' for 'sm_90a'\n"
           "ptxas info    : Used 120 registers\n")
    plain = types.SimpleNamespace(
        BUILD_LOG=log,
        k2_ranges=lambda v, *a: psearch.ranges_plain(v, *a),
        k4_ngram_ranges=lambda v, ng, mat, n: psearch.ngram_ranges_plain(v, ng, mat, n),
        k3_backtrace_resolve=lambda v, pos: psearch.backtrace_resolve_plain(v, pos))

    def host_ms(fn, reps):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    monkeypatch.setattr(kernel_ab, "cuda_ms", host_ms)
    monkeypatch.setattr(kernel_ab, "K1_AMINO_RESIDUES", 20_000)
    rng = np.random.default_rng(7)
    seq = rng.choice(np.frombuffer(b"acgt", np.uint8), size=40_000)
    index = create_index(seq.tobytes(), IndexConfiguration(8, 6, PA.DNA), device="cpu")
    args = types.SimpleNamespace(queries=96, reps=1, seed_k=6, bases=len(seq))
    kernel_ab.pairless_cases(index, seq, args, {"this": plain, "parent": plain}, "cpu")
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["case"] for x in lines] == [
        "registers", "registers", "k2 block rows", "k2 pair rows", "k3 narrow rows",
        "pairless calibration", "k2 block rows: model",
        "k4 n=2, tail over block rows", "k4 n=2, tail over block rows: model",
        "k4 n=2, tail over pair rows", "k4 n=2, tail over pair rows: model",
        "k4 n=3, tail over block rows", "k4 n=3, tail over block rows: model",
        "k4 n=3, tail over pair rows", "k4 n=3, tail over pair rows: model",
        "k2w amino 20000, compact rows", "k2w amino 20000, pair-fused rows",
        "k3w amino 20000, compact rows", "k3w amino 20000, compact rows, on-disk form",
        "k3w amino 20000, pair-fused rows", "k2w amino 20000, compact rows: model",
        "k3w amino 20000, compact rows: model"]
    assert lines[0]["kernels"] == [
        {"kernel": "k4_block_ngram_ranges_kernel<2, 3, 8>", "registers": 120, "spill_bytes": 0}]
    assert set(lines[5]["tables"]) == {"block", "pair", "ngram2", "ngram3"}
    # the block rows walked with 1 and 4 lanes a chain
    assert set(lines[5]["block_rows_by_lanes_a_chain"]) == {"1", str(kernel_ab.CEILING_LANES)}
    for case in ("k2 block rows", "k2 pair rows", "k3 narrow rows", "k3w amino 20000, compact rows"):
        timed = next(x for x in lines if x["case"] == case)
        assert set(timed["ms"]) == {"this", "parent"} and all(len(t) == 2 for t in timed["ms"].values())
    for model in (x for x in lines if x["case"].endswith(": model")):
        assert set(model["ms"]) == {"this", "parent"} and model["model_ms"] > 0
        assert sum(model["row_visits"].values()) > 0 and model["bound_ms"] > 0
    k2 = lines[6]
    assert sum(k2["classes"]) > 0 and k2["row_visits"]["block"] >= sum(k2["classes"])
    ceiling = k2["ceiling"]
    assert ceiling["lanes_a_chain"] == 4 and ceiling["model_ms"] > 0
    assert ceiling["rate_rows_per_s"] == lines[5]["block_rows_by_lanes_a_chain"]["4"]
    k3 = lines[-1]
    assert k3["row_visits"]["compact"] == k3["lf_steps"] > 0 and k3["hits"] == 96
    assert 0 < k3["lane_occupancy"] <= 1
    k4 = lines[8]
    # 25-mers at k = 6: up to 9 n-gram steps and one tail step a query, and
    # every sampled query makes its first n-gram step
    assert sum(k4["ngram_classes"]) >= 96 and 0 < sum(k4["tail_classes"]) <= sum(k4["ngram_classes"]) / 9 + 1
    assert k4["row_visits"]["block"] >= sum(k4["tail_classes"])
    assert lines[-2]["compact_pieces_per_visit"] == 3.8 and lines[-2]["pieces_per_visit"] == 4


def test_bfs_case_arguments():
    """``--cases bfs`` with a parent and thresholds of the depth split: the
    amino tables are phase 4p's, at k = 5 and k = 6."""
    got = kernel_ab.parse_args(["--other", "parent=build/parent", "--cases", "bfs",
                                "--bfs-max-parents", "0", "262144", "4194304"])
    assert got.cases == "bfs" and got.bfs_max_parents == [0, 262144, 4194304]
    assert kernel_ab.parse_args([]).bfs_max_parents == []
    assert kernel_ab.COMPACT_BFS_K == (5, 6) and kernel_ab.K1_AMINO_RESIDUES == 1 << 26


def test_compact_bfs_case_runs_on_the_cpu(monkeypatch, capsys):
    """The compact amino BFS case end to end on a small index, the
    checkouts' ``build_seed_table`` on the CPU (the plain loop) and CUDA
    events stood in for by the host clock: a line a k, every checkout and
    every threshold timed twice on equal tables."""
    import json
    import time

    def host_ms(fn, reps):
        t = time.perf_counter()
        fn()
        return (time.perf_counter() - t) * 1e3

    monkeypatch.setattr(kernel_ab, "cuda_ms", host_ms)
    monkeypatch.setattr(kernel_ab, "K1_AMINO_RESIDUES", 20_000)
    kernel_ab.compact_bfs_cases({"this": kernels, "parent": kernels}, 1, [0, 400, 2**22],
                                np.random.default_rng(3), "cpu", ks=(2, 3))
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["case"] for x in lines] == ["bfs amino compact k=2", "bfs amino compact k=3"]
    assert [x["shape"] for x in lines] == ["20^2 ranges", "20^3 ranges"]
    for line in lines:
        assert set(line["ms"]) == {"this", "parent", "this, max_parents=0",
                                   "this, max_parents=400", "this, max_parents=4194304"}
        assert all(len(t) == 2 for t in line["ms"].values())


@pytest.mark.parametrize("steps", [0, 1, 2, 3])
@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
def test_split_seed_table_on_the_cpu(alphabet, steps):
    """The split that ``--bfs-max-parents`` times, on a CPU view: the plain
    loop at every split, equal to the JAX package's seed table, and no
    launch."""
    rng = np.random.default_rng(0x5B17 + steps)
    j, p = build_both(random_sequence(rng, 2500, alphabet), 4, 4, alphabet)
    dev = p.to_device("cpu")
    before = kernels.launch_counts()
    got = kernel_ab.split_seed_table(dev, 4, steps, p.prefix_sums)
    assert kernels.launch_counts() == before
    np.testing.assert_array_equal(got.numpy().view(np.uint32), j.kmer_seed_table)

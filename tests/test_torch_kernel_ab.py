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

from oracle import random_sequence
from torch_helpers import build_both

DNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.AMINO


@pytest.mark.parametrize("case", ["all", "bfs", "rs", "k3w", "k5", "pairless", "k1"])
def test_every_case_parses(case):
    assert case in kernel_ab.CASES
    assert kernel_ab.parse_args(["--cases", case]).cases == case


def test_case_list_and_defaults():
    assert kernel_ab.CASES == ("all", "bfs", "rs", "k3w", "k5", "pairless", "k1")
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

"""The port's slice end to end, against the JAX package and known answers.

FASTA -> create_index_from_fasta -> .awfmi -> read_index_from_file ->
SearchEngine -> count / locate, on the CPU. The `.awfmi` files the two
packages write must be byte-identical, the verify recipe's known answers
must hold, and importing the port must not import jax. Exact: tolerance 0.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt

from oracle import random_sequence
from torch_helpers import assert_locates_equal, configs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEMO_FASTA = b">a\nGATTACAGATTACA\nACGTACGT\n>b\nTTTTGATTACATTTT\n"


@pytest.fixture
def demo_fasta(tmp_path):
    path = tmp_path / "demo.fasta"
    path.write_bytes(DEMO_FASTA)
    return str(path)


def test_known_answers(tmp_path, demo_fasta):
    cfg = pt.IndexConfiguration(
        suffix_array_compression_ratio=4, kmer_length_in_seed_table=3,
        alphabet_type=pt.AlphabetType.DNA,
    )
    out = str(tmp_path / "demo.awfmi")
    pt.create_index_from_fasta(demo_fasta, cfg, index_file_src=out, device="cpu")
    idx = pt.read_index_from_file(out)
    eng = pt.SearchEngine(idx, device="cpu")
    assert eng.count(["GATTACA", "ACGT", "CCCC"]).tolist() == [3, 2, 0]
    assert sorted(eng.locate(["GATTACA"])[0].tolist()) == [0, 7, 26]
    seq_num, local = idx.get_local_sequence_position(26)
    assert (int(seq_num), int(local)) == (1, 4)
    assert idx.get_header(1).startswith(b"b")
    assert sorted(eng.locate(["TTTT"])[0].tolist()) == [21, 22, 33]


@pytest.mark.parametrize(
    "alphabet,ratio,k,store",
    [
        (jx.AlphabetType.DNA, 4, 3, True),
        (jx.AlphabetType.DNA, 8, 5, False),
        (jx.AlphabetType.AMINO, 8, 2, True),
    ],
    ids=["dna-r4-k3", "dna-r8-k5-noseq", "amino-r8-k2"],
)
def test_awfmi_byte_identical(tmp_path, alphabet, ratio, k, store):
    rng = np.random.default_rng(0xF11E + k)
    seq = random_sequence(rng, 3000, alphabet)
    jcfg, pcfg = configs(ratio, k, alphabet, store_original_sequence=store)
    jpath, ppath = str(tmp_path / "j.awfmi"), str(tmp_path / "p.awfmi")
    jx.create_index(seq, jcfg, file_src=jpath)
    pt.create_index(seq, pcfg, file_src=ppath, device="cpu")
    assert open(ppath, "rb").read() == open(jpath, "rb").read()


def test_awfmi_byte_identical_fasta(tmp_path, demo_fasta):
    jcfg, pcfg = configs(4, 2, jx.AlphabetType.DNA)
    jpath, ppath = str(tmp_path / "j.awfmi"), str(tmp_path / "p.awfmi")
    jx.create_index_from_fasta(demo_fasta, jcfg, index_file_src=jpath)
    pt.create_index_from_fasta(demo_fasta, pcfg, index_file_src=ppath, device="cpu")
    assert open(ppath, "rb").read() == open(jpath, "rb").read()


def test_port_reads_jax_file_and_back(tmp_path):
    rng = np.random.default_rng(31)
    seq = random_sequence(rng, 2500, jx.AlphabetType.DNA)
    jcfg, _ = configs(4, 3, jx.AlphabetType.DNA)
    jpath, ppath = str(tmp_path / "j.awfmi"), str(tmp_path / "p.awfmi")
    j = jx.create_index(seq, jcfg, file_src=jpath)
    loaded = pt.read_index_from_file(jpath)
    pt.write_index_to_file(loaded, ppath)
    assert open(ppath, "rb").read() == open(jpath, "rb").read()
    qs = [seq[s : s + 7] for s in rng.integers(0, 2490, 50)]
    np.testing.assert_array_equal(
        pt.SearchEngine(loaded, device="cpu").count(qs), jx.SearchEngine(j).count(qs)
    )


@pytest.mark.parametrize("alphabet", [jx.AlphabetType.DNA, jx.AlphabetType.AMINO], ids=lambda a: a.name)
def test_slice_end_to_end(tmp_path, alphabet):
    """The whole slice: build, write, read (SA in memory and on disk),
    count and locate — equal to the JAX package at every step."""
    rng = np.random.default_rng(41)
    seq = random_sequence(rng, 6000, alphabet)
    jcfg, pcfg = configs(8, 3, alphabet)
    path = str(tmp_path / "slice.awfmi")
    j = jx.create_index(seq, jcfg)
    p = pt.create_index(seq, pcfg, file_src=path, device="cpu")
    qs = [seq[s : s + int(L)] for s, L in zip(rng.integers(0, 5980, 150), rng.integers(1, 18, 150))]
    want_c = jx.SearchEngine(j).count(qs)
    want_l = jx.SearchEngine(j).locate(qs)
    for idx in (p, pt.read_index_from_file(path), pt.read_index_from_file(path, False)):
        eng = pt.SearchEngine(idx, device="cpu")
        np.testing.assert_array_equal(eng.count(qs), want_c)
        assert_locates_equal(eng.locate(qs), want_l)


def test_import_leaves_jax_out():
    code = (
        "import sys, avxwindowfmindex_tpu_torch\n"
        "from avxwindowfmindex_tpu_torch.ops import kernels, rank, seed_table\n"
        "from avxwindowfmindex_tpu_torch.models import convert\n"
        "from avxwindowfmindex_tpu_torch.io import artifact\n"
        "from avxwindowfmindex_tpu_torch.parallel import api, chunked, dist, reliability\n"
        "from avxwindowfmindex_tpu_torch.tools import golden_parity, scaling_report\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not any(m.startswith('avxwindowfmindex_tpu.') or m == 'avxwindowfmindex_tpu'"
        " for m in sys.modules), 'JAX package imported'\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


def test_public_surface_covers_the_jax_package():
    """Every name of the JAX package's __all__ is in the port's, bound to
    something, and the two packages carry one version."""
    missing = sorted(set(jx.__all__) - set(pt.__all__))
    assert not missing, missing
    assert all(hasattr(pt, name) for name in pt.__all__)
    assert pt.__version__ == jx.__version__


def test_chip_smoke_refuses_without_cuda():
    # on a machine with no card the smoke script exits nonzero and prints no result
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
    assert "is_available() is False" in proc.stderr


def test_host_cpp_is_the_ports_own_byte_equal_copy():
    """The port compiles its own copy of the host C++ (SA-IS, FASTA) and
    reads no file of the JAX package; the copy is byte-equal to the JAX
    package's source, so both sort suffixes with the same code."""
    from avxwindowfmindex_tpu_torch.native import hostlib

    own = os.path.join(REPO, "avxwindowfmindex_tpu_torch", "csrc", "awfm_host.cpp")
    theirs = os.path.join(REPO, "avxwindowfmindex_tpu", "native", "src", "awfm_host.cpp")
    assert os.path.samefile(hostlib.SOURCE, own)
    with open(own, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
    if hostlib.available():  # a g++ is at hand: the copy builds and sorts
        sa = hostlib.suffix_array(np.frombuffer(b"banana$", np.uint8))
        assert sa.tolist() == [6, 5, 3, 1, 0, 4, 2]

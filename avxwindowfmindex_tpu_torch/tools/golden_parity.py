"""Build and drive the GOLDEN reference binary for parity checks.

The counterpart of ``avxwindowfmindex_tpu/tools/golden_parity.py``. The
reference C library (its sources at ``AWFM_REFERENCE_SRC``, else at
``DEFAULT_REFERENCE_SRC``, the JAX package's tool's path; read-only)
cannot compile as shipped: its libdivsufsort and FastaVector submodules
are empty. This module builds it anyway, by pairing the untouched
reference sources with the port's own copies of the shims in
``avxwindowfmindex_tpu_torch/native/golden/`` (divsufsort64 backed by
the port's SA-IS, ``csrc/awfm_host.cpp``; a minimal FastaVector matching
the documented usage), plus a small driver CLI (``golden_driver.c``),
into ``avxwindowfmindex_tpu_torch/build/golden/``. The result is the reference implementation itself: its .awfmi bytes and
hit lists are ground truth that tests/test_torch_golden_reference.py
byte-compares against the port's output, built on the CPU. Nothing here
touches a device.

CLI:
  python -m avxwindowfmindex_tpu_torch.tools.golden_parity build [--out DIR]
  python -m avxwindowfmindex_tpu_torch.tools.golden_parity demo  # self-check
"""

from __future__ import annotations

import os
import subprocess
import sys

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN_SRC = os.path.join(PKG, "native", "golden")
SHIMS = ("FastaVector.h", "divsufsort64.h", "golden_shims.c", "golden_driver.c")
HOST_CPP = os.path.join(PKG, "csrc", "awfm_host.cpp")
DEFAULT_OUT = os.path.join(PKG, "build", "golden")
DEFAULT_REFERENCE_SRC = "/root/reference/src"


def reference_src() -> str:
    """The reference library's source directory: ``AWFM_REFERENCE_SRC``,
    else ``DEFAULT_REFERENCE_SRC``."""
    return os.environ.get("AWFM_REFERENCE_SRC", DEFAULT_REFERENCE_SRC)


def reference_available() -> bool:
    return os.path.isfile(os.path.join(reference_src(), "AwFmIndex.h"))


def build_golden_driver(out_dir: str = DEFAULT_OUT, force: bool = False) -> str:
    """Compile the golden driver; returns the binary path.

    Rebuilds only when any input is newer than the existing binary.
    Raises on compile failure (callers may skip tests instead).
    """
    ref = reference_src()
    os.makedirs(out_dir, exist_ok=True)
    binary = os.path.join(out_dir, "golden_driver")
    ref_sources = sorted(os.path.join(ref, f) for f in os.listdir(ref) if f.endswith(".c"))
    inputs = [HOST_CPP] + [os.path.join(GOLDEN_SRC, f) for f in SHIMS] + ref_sources
    if (
        not force
        and os.path.isfile(binary)
        and all(os.path.getmtime(binary) >= os.path.getmtime(p) for p in inputs)
    ):
        return binary

    objs = []

    def compile_one(cmd, obj):
        subprocess.run(cmd + ["-c", "-o", obj], check=True, capture_output=True)
        objs.append(obj)

    cflags = ["-O2", "-std=c17", "-mavx2", "-fopenmp", f"-I{GOLDEN_SRC}", f"-I{ref}"]
    compile_one(["g++", "-O2", HOST_CPP], os.path.join(out_dir, "awfm_host.o"))
    for src in ref_sources + [
        os.path.join(GOLDEN_SRC, "golden_shims.c"),
        os.path.join(GOLDEN_SRC, "golden_driver.c"),
    ]:
        obj = os.path.join(out_dir, os.path.splitext(os.path.basename(src))[0] + ".o")
        compile_one(["gcc", *cflags, src], obj)
    subprocess.run(
        ["g++", "-O2", "-fopenmp", *objs, "-o", binary, "-lm"],
        check=True,
        capture_output=True,
    )
    return binary


def run_driver(binary: str, *args: str) -> str:
    proc = subprocess.run([binary, *args], check=True, capture_output=True, text=True)
    return proc.stdout


def _demo() -> int:
    import tempfile

    binary = build_golden_driver()
    with tempfile.TemporaryDirectory() as td:
        fasta = os.path.join(td, "demo.fasta")
        with open(fasta, "w") as fh:
            fh.write(">a\nGATTACAGATTACA\nACGTACGT\n>b\nTTTTGATTACATTTT\n")
        out = os.path.join(td, "demo.awfmi")
        print(run_driver(binary, "create-fasta", fasta, "dna", "4", "3", "1", out))
        kmers = os.path.join(td, "kmers.txt")
        with open(kmers, "w") as fh:
            fh.write("GATTACA\nACGT\nCCCC\n")
        print(run_driver(binary, "locate", out, kmers, "1"))
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] == "build":
        out = DEFAULT_OUT
        if len(argv) >= 3 and argv[1] == "--out":
            out = argv[2]
        print(build_golden_driver(out))
        return 0
    if argv[0] == "demo":
        return _demo()
    print(__doc__)
    return 2


if __name__ == "__main__":
    raise SystemExit(main())

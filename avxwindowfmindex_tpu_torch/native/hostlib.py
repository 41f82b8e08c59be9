"""ctypes bindings for the native host library (SA-IS and FASTA parsing).

The C++ source is ``avxwindowfmindex_tpu_torch/csrc/awfm_host.cpp``, the
port's own copy of the JAX package's ``native/src/awfm_host.cpp``, kept
byte-equal to it (tests/test_torch_slice.py), so both packages sort
suffixes and parse FASTA with the same code and the port reads no file
of the JAX package. It is compiled with g++ into the port's ignored
build directory (``avxwindowfmindex_tpu_torch/build/host/``), keyed on a
hash of the source.

If no compiler or source is available, ``available()`` is False and
callers fall back to the NumPy/Python implementations, except where a
caller asks for the native backend by name.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "awfm_host.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "host")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _lib_path() -> str:
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libawfm_host_{digest}.so")


def _try_build(path: str) -> bool:
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build under a per-process name, then rename: concurrent test
    # workers must never load a half-written library
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = [
        "g++", "-O3", "-march=native", "-fPIC", "-shared", "-std=c++17",
        SOURCE, "-o", tmp,
    ]
    try:
        proc = subprocess.run(cmd, capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        return False
    os.replace(tmp, path)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or not os.path.exists(SOURCE):
            _build_failed = True
            return None
        path = _lib_path()
        if not os.path.exists(path) and not _try_build(path):
            _build_failed = True
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            _build_failed = True
            return None
        lib.awfm_suffix_array.restype = ctypes.c_int
        lib.awfm_suffix_array.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.awfm_read_fasta.restype = ctypes.c_int
        lib.awfm_read_fasta.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.awfm_free.restype = None
        lib.awfm_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def suffix_array(sequence: np.ndarray) -> np.ndarray:
    """SA-IS suffix array over raw bytes; divsufsort64 call parity."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    seq = np.ascontiguousarray(sequence, dtype=np.uint8)
    n = len(seq)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    rc = lib.awfm_suffix_array(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
    )
    if rc != 0:
        raise RuntimeError(f"native suffix_array failed with code {rc}")
    return out


def read_fasta(path: str) -> Tuple[bytes, object]:
    """Native C++ FASTA parse (FastaVector-equivalent semantics)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    from ..models.index import FastaMetadata

    seq_p = ctypes.POINTER(ctypes.c_uint8)()
    seq_len = ctypes.c_int64()
    hdr_p = ctypes.POINTER(ctypes.c_uint8)()
    hdr_len = ctypes.c_int64()
    hdr_ends_p = ctypes.POINTER(ctypes.c_int64)()
    seq_ends_p = ctypes.POINTER(ctypes.c_int64)()
    num_seqs = ctypes.c_int64()
    rc = lib.awfm_read_fasta(
        path.encode(), ctypes.byref(seq_p), ctypes.byref(seq_len),
        ctypes.byref(hdr_p), ctypes.byref(hdr_len),
        ctypes.byref(hdr_ends_p), ctypes.byref(seq_ends_p),
        ctypes.byref(num_seqs),
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise RuntimeError(f"native read_fasta failed with code {rc}")
    try:
        n = num_seqs.value
        sequence = bytes(
            np.ctypeslib.as_array(seq_p, shape=(seq_len.value,))
        ) if seq_len.value else b""
        headers = bytes(
            np.ctypeslib.as_array(hdr_p, shape=(hdr_len.value,))
        ) if hdr_len.value else b""
        header_ends = (
            np.ctypeslib.as_array(hdr_ends_p, shape=(n,)).astype(np.uint64)
            if n else np.empty(0, np.uint64)
        )
        sequence_ends = (
            np.ctypeslib.as_array(seq_ends_p, shape=(n,)).astype(np.uint64)
            if n else np.empty(0, np.uint64)
        )
    finally:
        lib.awfm_free(seq_p)
        lib.awfm_free(hdr_p)
        lib.awfm_free(hdr_ends_p)
        lib.awfm_free(seq_ends_p)
    return sequence, FastaMetadata(
        headers=headers, header_ends=header_ends, sequence_ends=sequence_ends
    )

"""The hand-written CUDA kernels: build, ctypes bindings, launch counts.

The sources are ``avxwindowfmindex_tpu_torch/csrc/*.cu`` and nothing
else. At first use they are compiled with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC

into ``avxwindowfmindex_tpu_torch/build/kernels/<hash of the sources>/``
(ignored by git), and the shared library is loaded with ctypes. Each C
entry point launches on PyTorch's current stream and returns
``cudaGetLastError()``; the launchers below raise when it is nonzero.
Nothing here falls back to the plain torch versions: those are chosen
by the dispatch wrappers (``ops/rank.py``, ``search.py``) only for
tensors that lie on the CPU.

Each kernel keeps a plain integer count of its launches
(``K1.launches`` ...), incremented right after a launch and nowhere
else, so a run can show that its main path went through the kernels.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Optional

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class Kernel:
    """One hand-written kernel: its name, where it lives, what TPU code
    it replaces, and how many times it was launched."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0


K1 = Kernel(
    "k1_rank", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/ops/rank_pallas.py:40",
)
K2 = Kernel(
    "k2_ranges", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/ops/rank.py:370",
)
K3 = Kernel(
    "k3_backtrace_resolve", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/search.py:940",
)
K4 = Kernel(
    "k4_ngram_ranges", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "experiments/ab_r5_pallas_gather.py:119",
)
KERNELS = (K1, K2, K3, K4)


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0


class _Tables(ctypes.Structure):
    """Mirror of ``struct AwfmTables`` in csrc/awfm_kernels.cu."""

    _fields_ = [
        ("packed", ctypes.c_void_p),
        ("packed_pair", ctypes.c_void_p),
        ("prefix_sums", ctypes.c_void_p),
        ("code_masks", ctypes.c_void_p),
        ("vec_to_index", ctypes.c_void_p),
        ("nb", ctypes.c_int64),
        ("row_bytes", ctypes.c_int32),
        ("pair_row_bytes", ctypes.c_int32),
        ("card", ctypes.c_int32),
        ("n_planes", ctypes.c_int32),
    ]


class _NgramTables(ctypes.Structure):
    """Mirror of ``struct NgramTables`` in csrc/awfm_kernels.cu."""

    _fields_ = [
        ("packed", ctypes.c_void_p),
        ("cn", ctypes.c_void_p),
        ("nb", ctypes.c_int64),
        ("row_bytes", ctypes.c_int32),
        ("n", ctypes.c_int32),
        ("biased", ctypes.c_int32),
    ]


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
BUILD_LOG = ""  # nvcc's output (ptxas register and spill report) of the last build


def _sources():
    return sorted(
        glob.glob(os.path.join(CSRC_DIR, "*.cu"))
        + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    )


def _nvcc() -> str:
    path = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    return path if os.path.exists(path) else (shutil.which("nvcc") or path)


def library_path() -> str:
    h = hashlib.sha256()
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, h.hexdigest()[:16], "libawfm_kernels.so")


def build() -> float:
    """Compile (if needed) and load the kernel library; returns seconds.

    Raises RuntimeError with nvcc's output when the build fails.
    """
    global _lib, BUILD_LOG
    t0 = time.time()
    with _lock:
        if _lib is not None:
            return 0.0
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            cu = [s for s in _sources() if s.endswith(".cu")]
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            BUILD_LOG = proc.stdout + proc.stderr
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{BUILD_LOG}"
                )
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        tables_p = ctypes.POINTER(_Tables)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.awfm_k1_occ.argtypes = [i32, tables_p, vp, vp, i64, vp, vp]
        lib.awfm_k1_letter_lf.argtypes = [i32, tables_p, vp, i64, vp, vp, vp]
        lib.awfm_k2_ranges.argtypes = [
            i32, tables_p, vp, i64, i32, vp, i64, i64, vp, vp, vp, vp, vp,
        ]
        lib.awfm_k3_backtrace_resolve.argtypes = [
            i32, tables_p, vp, i64, ctypes.c_uint32, ctypes.c_uint32, vp,
            vp, vp, vp, vp,
        ]
        lib.awfm_k4_ngram_ranges.argtypes = [
            i32, tables_p, ctypes.POINTER(_NgramTables), vp, i64, i32, vp,
            i64, i64, i32, vp, vp, vp,
        ]
        for fn in (
            lib.awfm_k1_occ, lib.awfm_k1_letter_lf, lib.awfm_k2_ranges,
            lib.awfm_k3_backtrace_resolve, lib.awfm_k4_ngram_ranges,
        ):
            fn.restype = ctypes.c_int
        lib.awfm_error_string.argtypes = [ctypes.c_int]
        lib.awfm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return time.time() - t0


def _library() -> ctypes.CDLL:
    if _lib is None:
        build()
    return _lib


def _check(rc: int, what: str) -> None:
    if rc != 0:
        msg = _library().awfm_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def _require(t: torch.Tensor, name: str, dtype, device) -> None:
    if not t.is_cuda or t.device != device:
        raise ValueError(f"{name} must be a CUDA tensor on {device}, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _tables(dev) -> _Tables:
    device = dev.packed.device
    for name, dtype in (
        ("packed", torch.uint8), ("packed_pair", torch.uint8),
        ("prefix_sums", torch.int32), ("code_masks", torch.uint8),
        ("vec_to_index", torch.int32),
    ):
        _require(getattr(dev, name), name, dtype, device)
    return _Tables(
        packed=dev.packed.data_ptr(),
        packed_pair=dev.packed_pair.data_ptr(),
        prefix_sums=dev.prefix_sums.data_ptr(),
        code_masks=dev.code_masks.data_ptr(),
        vec_to_index=dev.vec_to_index.data_ptr(),
        nb=int(dev.packed.shape[0]),
        row_bytes=int(dev.packed.shape[1]),
        pair_row_bytes=int(dev.packed_pair.shape[1]),
        card=int(dev.cardinality),
        n_planes=int(dev.n_planes),
    )


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def k1_occurrence(dev, positions: torch.Tensor, letters: torch.Tensor) -> torch.Tensor:
    """K1, occ mode: (n,) int64 occ(letter, position mod 2^32), as u32."""
    tables = _tables(dev)
    device = dev.packed.device
    _require(positions, "positions", torch.int64, device)
    _require(letters, "letters", torch.int32, device)
    if positions.shape != letters.shape or positions.dim() != 1:
        raise ValueError("positions and letters must be 1-D of one length")
    n = positions.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    rc = _library().awfm_k1_occ(
        device.index, ctypes.byref(tables), positions.data_ptr(),
        letters.data_ptr(), n, out.data_ptr(), _stream(device),
    )
    _check(rc, "awfm_k1_occ")
    K1.launches += 1
    return out


def k1_letter_and_lf(dev, positions: torch.Tensor):
    """K1, LF mode: ((n,) int32 letters, (n,) int64 LF positions)."""
    tables = _tables(dev)
    device = dev.packed.device
    _require(positions, "positions", torch.int64, device)
    if positions.dim() != 1:
        raise ValueError("positions must be 1-D")
    n = positions.shape[0]
    letters = torch.empty(n, dtype=torch.int32, device=device)
    lf = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return letters, lf
    rc = _library().awfm_k1_letter_lf(
        device.index, ctypes.byref(tables), positions.data_ptr(), n,
        letters.data_ptr(), lf.data_ptr(), _stream(device),
    )
    _check(rc, "awfm_k1_letter_lf")
    K1.launches += 1
    return letters, lf


def k2_ranges(dev, mat: torch.Tensor, lengths: torch.Tensor, seeded: torch.Tensor):
    """K2: final (start, end) BWT ranges, (b,) int64 each, as u32."""
    tables = _tables(dev)
    device = dev.packed.device
    _require(dev.seed_table, "seed_table", torch.int32, device)
    _require(mat, "mat", torch.uint8, device)
    _require(lengths, "lengths", torch.int32, device)
    _require(seeded, "seeded", torch.uint8, device)
    if mat.dim() != 2 or lengths.shape != (mat.shape[0],) or seeded.shape != lengths.shape:
        raise ValueError("mat must be (b, l) with lengths and seeded (b,)")
    b, l_pad = mat.shape
    start = torch.empty(b, dtype=torch.int64, device=device)
    end = torch.empty(b, dtype=torch.int64, device=device)
    if b == 0:
        return start, end
    rc = _library().awfm_k2_ranges(
        device.index, ctypes.byref(tables), dev.seed_table.data_ptr(),
        int(dev.seed_table.shape[0]), int(dev.kmer_length_in_seed_table),
        mat.data_ptr(), b, l_pad, lengths.data_ptr(), seeded.data_ptr(),
        start.data_ptr(), end.data_ptr(), _stream(device),
    )
    _check(rc, "awfm_k2_ranges")
    K2.launches += 1
    return start, end


def k3_backtrace_resolve(dev, positions: torch.Tensor):
    """K3: hits (n,) int64 when the sampled SA is resident, else the
    sampled positions and walk offsets ((n,) int64 each)."""
    tables = _tables(dev)
    device = dev.packed.device
    _require(positions, "positions", torch.int64, device)
    if positions.dim() != 1:
        raise ValueError("positions must be 1-D")
    n = positions.shape[0]
    on_disk = dev.sampled_sa is None
    if on_disk:
        hits = None
        p = torch.empty(n, dtype=torch.int64, device=device)
        off = torch.empty(n, dtype=torch.int64, device=device)
    else:
        _require(dev.sampled_sa, "sampled_sa", torch.int32, device)
        hits = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return (p, off) if on_disk else hits
    rc = _library().awfm_k3_backtrace_resolve(
        device.index, ctypes.byref(tables), positions.data_ptr(), n,
        int(dev.ratio), int(dev.bwt_length),
        None if on_disk else dev.sampled_sa.data_ptr(),
        None if on_disk else hits.data_ptr(),
        p.data_ptr() if on_disk else None,
        off.data_ptr() if on_disk else None,
        _stream(device),
    )
    _check(rc, "awfm_k3_backtrace_resolve")
    K3.launches += 1
    return (p, off) if on_disk else hits


def k4_ngram_ranges(dev, ng, mat: torch.Tensor, kmer_len: int):
    """K4: final (start, end) BWT ranges of a uniform-length clean batch
    through the n-gram table ``ng``, (b,) int64 each, as u32."""
    tables = _tables(dev)
    device = dev.packed.device
    _require(dev.seed_table, "seed_table", torch.int32, device)
    _require(ng.packed, "ngram packed", torch.uint8, device)
    _require(ng.cn, "ngram cn", torch.int32, device)
    _require(mat, "mat", torch.uint8, device)
    if ng.packed.data_ptr() % 16 or dev.packed_pair.data_ptr() % 16:
        raise ValueError("row tables must be 16-byte aligned")
    if ng.n not in (2, 3) or ng.cn.shape != (4**ng.n,):
        raise ValueError(f"unsupported n-gram table (n={ng.n})")
    if ng.packed.shape[0] != dev.packed.shape[0]:
        raise ValueError("n-gram table and index have different block counts")
    if dev.n_planes != 3:
        raise ValueError("K4 takes nucleotide indexes only")
    k = int(dev.kmer_length_in_seed_table)
    if mat.dim() != 2 or not k < kmer_len <= mat.shape[1]:
        raise ValueError(f"need (b, l) letters with k={k} < kmer_len={kmer_len} <= l")
    b, l_pad = mat.shape
    start = torch.empty(b, dtype=torch.int64, device=device)
    end = torch.empty(b, dtype=torch.int64, device=device)
    if b == 0:
        return start, end
    ngt = _NgramTables(
        packed=ng.packed.data_ptr(), cn=ng.cn.data_ptr(),
        nb=int(ng.packed.shape[0]), row_bytes=int(ng.packed.shape[1]),
        n=int(ng.n), biased=int(bool(ng.biased)),
    )
    rc = _library().awfm_k4_ngram_ranges(
        device.index, ctypes.byref(tables), ctypes.byref(ngt),
        dev.seed_table.data_ptr(), int(dev.seed_table.shape[0]), k,
        mat.data_ptr(), b, l_pad, int(kmer_len),
        start.data_ptr(), end.data_ptr(), _stream(device),
    )
    _check(rc, "awfm_k4_ngram_ranges")
    K4.launches += 1
    return start, end

"""The hand-written CUDA kernels: build, ctypes bindings, launch counts.

The sources are ``avxwindowfmindex_tpu_torch/csrc/*.cu`` (with the
header ``awfm_common.cuh`` they share) and nothing else. At first use
each is compiled to an object, all at once, with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -c

and the objects are linked (``nvcc -shared``) into
``avxwindowfmindex_tpu_torch/build/kernels/<hash of the sources>/``
(ignored by git); the shared library is loaded with ctypes. Each C
entry point launches on PyTorch's current stream and returns
``cudaGetLastError()``; the launchers below raise when it is nonzero.
The one exception is ``awfm_read_back``: K1's single-query modes
(``k1_step``, ``k1_lf_at``) return their 16 B result through it, a copy
to pinned host memory on the current stream and that stream's
synchronisation, so such a call is one launch and one readback with the
checked tables and the buffers kept per view (``_view_state``).
Nothing here falls back to the plain torch versions: those are chosen
by the dispatch wrappers (``ops/rank.py``, ``search.py``,
``ops/probes.py``) only for tensors that lie on the CPU.

Each kernel keeps a plain integer count of its launches
(``K1.launches`` ...), incremented right after a launch and nowhere
else, so a run can show that its main path went through the kernels;
K1's forms also count by mode (``K1.modes``: occ, letter_lf, step,
lf_at; ``launch_counts``), and K1X's forms their BFS mode (``bfs``:
``k1_seed_table``, the seed table's shallow depths or all of them in one
launch).

Each launch's C call, and nothing else of its wrapper, runs inside the
span ``awfm.launch.<name>`` of the kernel's form (``_launch``;
``utils/metrics.span``: a ``torch.profiler`` range while a profiler
records, else a flag check), so a trace tells the wrapper's host time
from the launch's.

The forms over block rows, ``K2_BLOCK`` and ``K4_BLOCK``'s tail, count
their steps by class on the card while a profiler records
(``ROW_STEPS``, ``utils/metrics.device_counts``): the steps with both
ends in one block row and those read over two. Otherwise they are handed
a null counter and launch the code they launched before; the pair-row
forms take none.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
import weakref
from typing import Optional

import torch

from ..models.index import (
    device_pair_row_bytes, device_row_bytes, device_row_bytes64, kernel_letter_tables,
)
from ..utils import metrics
from .ngram import _geometry_k4

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "build", "kernels")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class Kernel:
    """One hand-written kernel: its name, where it lives, what TPU code
    it replaces, and how many times it was launched. ``prefix`` names its
    C entry points, ``awfm_<prefix>_<mode>`` (default: the name's first
    word)."""

    def __init__(self, name: str, source: str, replaces: str, prefix: Optional[str] = None):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.prefix = prefix or name.split("_")[0]
        self.span = f"launch.{name}"  # the span of its launches (``_launch``)
        self.launches = 0
        # K1's forms: launches by mode ("occ", "letter_lf", "step", "lf_at");
        # K1X's: the BFS mode ("bfs")
        self.modes = {}

    def count(self, mode: str) -> None:
        """One launch in ``mode``: the total and the mode's count."""
        self.launches += 1
        self.modes[mode] = self.modes.get(mode, 0) + 1


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
K5 = Kernel(
    "k5_gather_reduce", "avxwindowfmindex_tpu_torch/csrc/awfm_probes.cu",
    "experiments/pallas_gather_bench.py:89",
)
K6 = Kernel(
    "k6_slab_gather", "avxwindowfmindex_tpu_torch/csrc/awfm_probes.cu",
    "experiments/ab_r5_pallas_gather.py:85",
)
# the 64-bit instantiations of K1-K3, for a wide view (positions >= 2^32);
# the JAX package's counterpart is XLA code over (hi, lo) u32 pairs
K1W = Kernel(
    "k1w_rank", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/ops/rank64.py:410",
)
K2W = Kernel(
    "k2w_ranges", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/ops/rank64.py:447",
)
K3W = Kernel(
    "k3w_backtrace_resolve", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/search64.py:473",
)
# K1's level-extend form, one launch a depth of the seed-table BFS, with
# launch counts of its own (the BFS's rows apart from the occ mode's); its
# BFS mode, the whole table or its shallow depths in one launch, counts as
# the mode "bfs" (``k1w_extend_compact.bfs``)
K1X = Kernel(
    "k1_extend", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/ops/rank_pallas.py:40 under avxwindowfmindex_tpu/ops/seed_table.py:49",
)
K1WX = Kernel(
    "k1w_extend", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/ops/rank_pallas.py:40 under avxwindowfmindex_tpu/search64.py:564",
)
# K1 over one shard of the range-sharded engine (parallel/range_sharded.py),
# narrow block rows and compact wide rows: the masked rank the JAX package
# computes in XLA with P1's arithmetic, run on the lanes the route hands the
# shard; the route stands for the psum that assembles it there
K1R_ROUTE = Kernel(
    "k1r_route", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/parallel/range_sharded.py:78",
)
K1R = Kernel(
    "k1r_rank", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/parallel/range_sharded.py:54",
)
K1RW = Kernel(
    "k1rw_rank", "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu",
    "avxwindowfmindex_tpu/parallel/range_sharded.py:54",
)
# the forms for a view without pair rows (to_device(pair_rows=False)): K2
# and K4's tail step the first-block class over the block row and every
# wider range over two block rows; K1w, K1WX, K2w and K3w read the compact
# wide rows (planes 32 B apart). The JAX package takes its classic step
# there, P1's rank over the block rows.
_SRC = "avxwindowfmindex_tpu_torch/csrc/awfm_kernels.cu"
K2_BLOCK = Kernel(
    "k2_ranges_block", _SRC,
    "avxwindowfmindex_tpu/ops/rank_pallas.py:40 under avxwindowfmindex_tpu/ops/rank.py:285",
    prefix="k2_block",
)
K4_BLOCK = Kernel(
    "k4_ngram_ranges_block", _SRC,
    "experiments/ab_r5_pallas_gather.py:119, its tail: avxwindowfmindex_tpu/ops/rank_pallas.py:40 "
    "under avxwindowfmindex_tpu/search.py:1671",
    prefix="k4_block",
)
# the block-row steps of K2_BLOCK and K4_BLOCK's tail by class, counted on
# the card while a profiler records (_row_steps): both ends in one block
# row (the first-block class), read over two block rows
ROW_STEPS = ("awfm.blockrows.one_row", "awfm.blockrows.two_rows")
K1W_COMPACT = Kernel("k1w_rank_compact", _SRC, "avxwindowfmindex_tpu/ops/rank64.py:410",
                     prefix="k1w_compact")
K1WX_COMPACT = Kernel(
    "k1w_extend_compact", _SRC,
    "avxwindowfmindex_tpu/ops/rank_pallas.py:40 under avxwindowfmindex_tpu/search64.py:564",
    prefix="k1w_compact",
)
K2W_COMPACT = Kernel("k2w_ranges_compact", _SRC, "avxwindowfmindex_tpu/ops/rank64.py:416",
                     prefix="k2w_compact")
K3W_COMPACT = Kernel("k3w_backtrace_resolve_compact", _SRC, "avxwindowfmindex_tpu/search64.py:473",
                     prefix="k3w_compact")
KERNELS = (K1, K2, K3, K4, K5, K6, K1W, K2W, K3W, K1X, K1WX, K1R, K1RW, K1R_ROUTE,
           K2_BLOCK, K4_BLOCK, K1W_COMPACT, K1WX_COMPACT, K2W_COMPACT, K3W_COMPACT)
# the form of a kernel a view takes: by its width, then, without pair
# rows, by its layout (a narrow view's K1, K1X and K3 read its block rows
# either way)
_WIDE = {K1: K1W, K2: K2W, K3: K3W, K1X: K1WX, K1R: K1RW}
_WITHOUT_PAIR_ROWS = {K2: K2_BLOCK, K4: K4_BLOCK, K1W: K1W_COMPACT, K1WX: K1WX_COMPACT,
                      K2W: K2W_COMPACT, K3W: K3W_COMPACT}


def reset_launch_counts() -> None:
    for k in KERNELS:
        k.launches = 0
        k.modes = {}


def launch_counts() -> dict:
    """Every kernel's launches by name and, for a kernel with modes, by
    ``name.mode`` too (``k1_rank.step``)."""
    out = {}
    for k in KERNELS:
        out[k.name] = k.launches
        out.update({f"{k.name}.{mode}": c for mode, c in k.modes.items()})
    return out


class _Tables(ctypes.Structure):
    """Mirror of ``struct AwfmTables`` in csrc/awfm_kernels.cu."""

    _fields_ = [
        ("packed", ctypes.c_void_p),
        ("packed_pair", ctypes.c_void_p),
        ("prefix_sums", ctypes.c_void_p),
        ("code_masks", ctypes.c_void_p),
        ("nb", ctypes.c_int64),
        ("row_bytes", ctypes.c_int32),
        ("pair_row_bytes", ctypes.c_int32),
        ("card", ctypes.c_int32),
        ("n_planes", ctypes.c_int32),
        ("letter_code", ctypes.c_uint64 * 4),
        ("code_letter", ctypes.c_uint64 * 4),
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
            objs = [f"{tmp}.{os.path.basename(src)}.o" for src in cu]
            # one nvcc per source, all started together, then the link
            cmds = [[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, src] for src, o in zip(cu, objs)]
            procs = [
                subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for c in cmds
            ]
            results = [(c, p.communicate()[0], p.returncode) for c, p in zip(cmds, procs)]
            if all(rc == 0 for _, _, rc in results):
                link = [_nvcc(), "-shared", "-o", tmp, *objs]
                done = subprocess.run(link, capture_output=True, text=True)
                results.append((link, done.stdout + done.stderr, done.returncode))
            BUILD_LOG = "".join(out for _, out, _ in results)
            for o in objs:
                if os.path.exists(o):
                    os.remove(o)
            for cmd, _, rc in results:
                if rc != 0:
                    raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{BUILD_LOG}")
            os.replace(tmp, path)
        lib = ctypes.CDLL(path)
        tables_p = ctypes.POINTER(_Tables)
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        lib.awfm_k1_occ.argtypes = [i32, tables_p, vp, vp, i64, vp, vp]
        lib.awfm_k1_letter_lf.argtypes = [i32, tables_p, vp, i64, vp, vp, vp]
        lib.awfm_k1_step.argtypes = [
            i32, tables_p, ctypes.c_uint64, ctypes.c_uint64, ctypes.c_uint32, vp, vp,
        ]
        lib.awfm_k1_lf_at.argtypes = [i32, tables_p, ctypes.c_uint64, vp, vp]
        lib.awfm_read_back.argtypes = [i32, vp, vp, i64, vp]
        lib.awfm_empty.argtypes = [i32, vp]
        lib.awfm_k1_extend.argtypes = [i32, tables_p, vp, i64, vp, vp]
        lib.awfm_k1r_route.argtypes = [
            i32, i32, vp, i64, i32, i32, ctypes.c_uint64, i64, vp, vp, vp, vp, vp, vp, vp,
        ]
        lib.awfm_k1r_occ.argtypes = [i32, tables_p, i32, vp, vp, vp, i32, i64, i64, vp, vp, vp]
        lib.awfm_k1r_lf.argtypes = lib.awfm_k1r_occ.argtypes
        lib.awfm_k1rw_occ.argtypes = lib.awfm_k1r_occ.argtypes
        lib.awfm_k1rw_lf.argtypes = lib.awfm_k1r_occ.argtypes
        lib.awfm_k2_ranges.argtypes = [
            i32, tables_p, vp, i64, i32, vp, i64, i64, vp, vp, vp, vp, vp,
        ]
        lib.awfm_k3_backtrace_resolve.argtypes = [
            i32, tables_p, vp, i64, ctypes.c_uint32, ctypes.c_uint32, vp,
            vp, vp, vp, vp,
        ]
        u64 = ctypes.c_uint64
        lib.awfm_k1w_occ.argtypes = lib.awfm_k1_occ.argtypes
        lib.awfm_k1w_letter_lf.argtypes = lib.awfm_k1_letter_lf.argtypes
        lib.awfm_k1w_extend.argtypes = lib.awfm_k1_extend.argtypes
        lib.awfm_k2w_ranges.argtypes = lib.awfm_k2_ranges.argtypes
        lib.awfm_k3w_backtrace_resolve.argtypes = [
            i32, tables_p, vp, i64, u64, u64, vp, vp, vp, vp, vp,
        ]
        lib.awfm_k3w_compact_backtrace_resolve.argtypes = lib.awfm_k3w_backtrace_resolve.argtypes
        lib.awfm_k1w_compact_occ.argtypes = lib.awfm_k1_occ.argtypes
        lib.awfm_k1w_compact_letter_lf.argtypes = lib.awfm_k1_letter_lf.argtypes
        for form in ("k1w", "k1w_compact"):
            getattr(lib, f"awfm_{form}_step").argtypes = lib.awfm_k1_step.argtypes
            getattr(lib, f"awfm_{form}_lf_at").argtypes = lib.awfm_k1_lf_at.argtypes
        lib.awfm_k1w_compact_extend.argtypes = lib.awfm_k1_extend.argtypes
        lib.awfm_k1_seed_table.argtypes = [i32, tables_p, i32, vp, i64, vp, vp]
        lib.awfm_k1w_seed_table.argtypes = lib.awfm_k1_seed_table.argtypes
        lib.awfm_k1w_compact_seed_table.argtypes = lib.awfm_k1_seed_table.argtypes
        lib.awfm_seed_table_scratch_bytes.argtypes = [i64, i32, i64]
        lib.awfm_seed_table_scratch_bytes.restype = i64
        # the block-row forms take their step counter (null: none) before the stream
        lib.awfm_k2_block_ranges.argtypes = [*lib.awfm_k2_ranges.argtypes[:-1], vp, vp]
        lib.awfm_k2w_compact_ranges.argtypes = lib.awfm_k2_ranges.argtypes
        lib.awfm_k4_ngram_ranges.argtypes = [
            i32, tables_p, ctypes.POINTER(_NgramTables), vp, i64, i32, vp,
            i64, i64, i32, vp, vp, vp,
        ]
        lib.awfm_k4_block_ngram_ranges.argtypes = [*lib.awfm_k4_ngram_ranges.argtypes[:-1], vp, vp]
        lib.awfm_k5_gather_reduce.argtypes = [i32, vp, i64, i32, vp, i64, i32, i32, i32, vp, vp]
        lib.awfm_k5_gather_walk.argtypes = [
            i32, vp, i64, i32, vp, i64, i32, ctypes.c_uint32, i32, vp, vp,
        ]
        lib.awfm_k6_slab_gather.argtypes = [i32, vp, i64, vp, i64, vp, vp]
        lib.awfm_k6_slab_chain.argtypes = [i32, vp, i64, vp, i64, i32, vp, vp]
        for fn in (
            lib.awfm_k1_occ, lib.awfm_k1_letter_lf, lib.awfm_k1_extend, lib.awfm_k2_ranges,
            lib.awfm_k3_backtrace_resolve, lib.awfm_k4_ngram_ranges,
            lib.awfm_k1w_occ, lib.awfm_k1w_letter_lf, lib.awfm_k1w_extend, lib.awfm_k2w_ranges,
            lib.awfm_k3w_backtrace_resolve, lib.awfm_k3w_compact_backtrace_resolve,
            lib.awfm_k1w_compact_occ, lib.awfm_k1w_compact_letter_lf, lib.awfm_k1w_compact_extend,
            lib.awfm_k1_seed_table, lib.awfm_k1w_seed_table, lib.awfm_k1w_compact_seed_table,
            lib.awfm_k2_block_ranges, lib.awfm_k2w_compact_ranges, lib.awfm_k4_block_ngram_ranges,
            lib.awfm_k1r_route, lib.awfm_k1r_occ, lib.awfm_k1r_lf, lib.awfm_k1rw_occ,
            lib.awfm_k1rw_lf, lib.awfm_k1_step, lib.awfm_k1w_step, lib.awfm_k1w_compact_step,
            lib.awfm_k1_lf_at, lib.awfm_k1w_lf_at, lib.awfm_k1w_compact_lf_at,
            lib.awfm_read_back, lib.awfm_empty,
            lib.awfm_k5_gather_reduce, lib.awfm_k5_gather_walk,
            lib.awfm_k6_slab_gather, lib.awfm_k6_slab_chain,
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


def _pos_dtype(dev):
    """The dtype a view stores positions in: u32 in int32, u64 in int64."""
    return torch.int64 if dev.wide else torch.int32


def _check_shard(dev, shard: bool) -> None:
    if shard != dev.shard:
        raise ValueError(
            "K1R and K1Rw take the shards of a range-sharded engine (no pair "
            "rows, compact wide rows); the other kernels take whole views"
        )


def _tables(dev, shard: bool = False) -> _Tables:
    """The tables of a whole view, or with ``shard`` of one shard of the
    range-sharded engine (``dev.shard``), for K1R and K1Rw only. The row
    tables are checked against the layout the view names: narrow block
    rows and, where it has them, pair rows; wide pair-fused rows (one
    table for both roles) or compact rows. A view without pair rows
    passes a null pair table, so that no form reads one."""
    device = dev.packed.device
    _check_shard(dev, shard)
    pair = dev.packed_pair
    if dev.wide:
        want = device_row_bytes64(dev.alphabet, dev.pair_fused)
        # one table serves both roles; its 16 B loads need aligned rows
        if (pair is not None) != dev.pair_fused or (pair is not None and pair is not dev.packed):
            raise ValueError("a wide view has one row table: packed is packed_pair when "
                             "pair-fused, and packed_pair is None over compact rows")
    else:
        want = device_row_bytes(dev.alphabet)
    if shard and dev.pair_rows:
        raise ValueError("a shard has no pair rows")
    if dev.packed.dim() != 2 or dev.packed.shape[1] != want:
        raise ValueError(f"rows must be {want} B, got {tuple(dev.packed.shape)}")
    if pair is not None and not dev.wide:
        if pair.shape != (dev.packed.shape[0], device_pair_row_bytes(dev.alphabet)):
            raise ValueError(f"pair rows must be ({dev.packed.shape[0]}, "
                             f"{device_pair_row_bytes(dev.alphabet)}), got {tuple(pair.shape)}")
        _require(pair, "packed_pair", torch.uint8, device)
    for name, t, dtype in (
        ("packed", dev.packed, torch.uint8),
        ("prefix_sums", dev.prefix_sums, _pos_dtype(dev)),
        ("code_masks", dev.code_masks, torch.uint8),
    ):
        _require(t, name, dtype, device)
    if dev.packed.data_ptr() % 16 or (pair is not None and pair.data_ptr() % 16):
        raise ValueError("row tables must be 16-byte aligned")
    if dev.prefix_sums.shape != (dev.cardinality + 2,):
        raise ValueError("prefix_sums must hold cardinality + 2 entries")
    letter_code, code_letter = _letter_tables(dev.alphabet)
    return _Tables(
        packed=dev.packed.data_ptr(),
        packed_pair=None if pair is None else pair.data_ptr(),
        prefix_sums=dev.prefix_sums.data_ptr(),
        code_masks=dev.code_masks.data_ptr(),
        nb=int(dev.packed.shape[0]),
        row_bytes=int(dev.packed.shape[1]),
        pair_row_bytes=0 if pair is None else int(pair.shape[1]),
        card=int(dev.cardinality),
        n_planes=int(dev.n_planes),
        letter_code=letter_code, code_letter=code_letter,
    )


class _ViewState:
    """What the wrappers keep of one view between calls: its checked
    tables and the key they were built under (:func:`_view_state`), the C
    entries of its form of K1 by mode, and the single-query buffers. Those are
    a 16 B output on the view's device that every call's launch writes and
    a pinned host copy that ``awfm_read_back`` fills and syncs; a call
    holds ``lock`` from its launch until it has read the copy, so a reused
    buffer is never read before the launch that fills it has finished."""

    def __init__(self, key, tables: _Tables):
        self.key = key
        self.tables = tables
        self.ref = ctypes.pointer(tables)
        self.entries = {}
        self.lock = threading.Lock()
        self.out = self.host = self.words = None

    def entry(self, dev, suffix: str):
        """``_entry(dev, K1, suffix)``, looked up once: the view's form of
        K1 in mode ``suffix``."""
        hit = self.entries.get(suffix)
        if hit is None:
            hit = self.entries[suffix] = _entry(dev, K1, suffix)
        return hit

    def buffers(self, device):
        """(device output pointer, pinned host pointer, the host copy as
        two c_uint64), made at the view's first single-query call."""
        if self.out is None:
            self.out = torch.empty(2, dtype=torch.int64, device=device)
            self.host = torch.empty(2, dtype=torch.int64, pin_memory=True)
            self.words = (ctypes.c_uint64 * 2).from_address(self.host.data_ptr())
        return self.out.data_ptr(), self.host.data_ptr(), self.words


_VIEW_STATE = {}  # id(view) -> (weakref to it, its _ViewState)


def _view_key(dev):
    """What a view's tables are made of: the data pointer and shape of each
    tensor they point into, and the layout."""
    return tuple(None if t is None else (t.data_ptr(), t.shape)
                 for t in (dev.packed, dev.packed_pair, dev.prefix_sums, dev.code_masks)) + (
        dev.alphabet, dev.wide, dev.pair_fused, dev.shard)


def _view_state(dev, shard: bool = False) -> _ViewState:
    """The view's :class:`_ViewState`, its tables checked once (``_tables(dev,
    shard)``) and built again whenever a tensor they point into or the
    layout has changed since: a view made anew (``attach_seed_table``,
    ``densify_device_sa``, a ``to_device`` rebuild or layout swap) has no
    state yet, and one whose fields were replaced in place fails the key."""
    _check_shard(dev, shard)
    key = _view_key(dev)
    hit = _VIEW_STATE.get(id(dev))
    if hit is not None and hit[0]() is dev and hit[1].key == key:
        return hit[1]
    state = _ViewState(key, _tables(dev, shard))
    vid = id(dev)
    _VIEW_STATE[vid] = (weakref.ref(dev, lambda _: _VIEW_STATE.pop(vid, None)), state)
    return state


@functools.lru_cache(maxsize=None)
def _letter_tables(alphabet):
    """``kernel_letter_tables`` of an alphabet as the ctypes arrays of
    ``_Tables``."""
    return tuple((ctypes.c_uint64 * 4)(*t.view("<u8").tolist())
                 for t in kernel_letter_tables(alphabet))


def _stream(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def form_of(dev, kernel: Kernel) -> Kernel:
    """The form of K1, K1X, K2, K3, K4 or K1R that the view takes: its
    64-bit form for a wide view, and without pair rows the form that
    reads the block rows (``K2_BLOCK``, ``K4_BLOCK``) or the compact wide
    rows (``K1W_COMPACT`` ...)."""
    if dev.wide:
        kernel = _WIDE.get(kernel, kernel)
    if not dev.pair_rows and not dev.shard:
        kernel = _WITHOUT_PAIR_ROWS.get(kernel, kernel)
    return kernel


def _entry(dev, kernel: Kernel, suffix: str):
    """(C entry point, its name, its Kernel) of the view's form of
    ``kernel`` (:func:`form_of`): ``awfm_k1_occ`` and K1, ``awfm_k1w_occ``
    and K1W, ``awfm_k2_block_ranges`` and K2_BLOCK ..."""
    kernel = form_of(dev, kernel)
    name = f"awfm_{kernel.prefix}_{suffix}"
    return getattr(_library(), name), name, kernel


def _row_steps(kernel: Kernel, device) -> tuple:
    """The step counter a form over block rows takes before its stream: a
    pointer to ``ROW_STEPS``' counts on ``device`` while a profiler
    records (``metrics.device_counts``), else null; no argument for any
    other form."""
    if kernel is not K2_BLOCK and kernel is not K4_BLOCK:
        return ()
    counts = metrics.device_counts(ROW_STEPS, device)
    return (None if counts is None else counts.data_ptr(),)


def _launch(kernel: Kernel, fn, *args) -> int:
    """``fn(*args)``, a C entry point of ``kernel`` (a form's), inside the
    span ``awfm.launch.<kernel.name>``; its return code."""
    with metrics.span(kernel.span):
        return fn(*args)


def k1_occurrence(dev, positions: torch.Tensor, letters: torch.Tensor) -> torch.Tensor:
    """K1, occ mode: (n,) int64 occ(letter, position mod 2^32), as u32.
    K1w for a wide view: positions and counts are u64 in int64."""
    state = _view_state(dev)
    device = dev.packed.device
    _require(positions, "positions", torch.int64, device)
    _require(letters, "letters", torch.int32, device)
    if positions.shape != letters.shape or positions.dim() != 1:
        raise ValueError("positions and letters must be 1-D of one length")
    n = positions.shape[0]
    out = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return out
    fn, name, kernel = state.entry(dev, "occ")
    rc = _launch(
        kernel, fn, device.index, state.ref, positions.data_ptr(),
        letters.data_ptr(), n, out.data_ptr(), _stream(device),
    )
    _check(rc, name)
    kernel.count("occ")
    return out


def k1_letter_and_lf(dev, positions: torch.Tensor):
    """K1 (K1w for a wide view), LF mode: ((n,) int32 letters, (n,) int64
    LF positions)."""
    state = _view_state(dev)
    device = dev.packed.device
    _require(positions, "positions", torch.int64, device)
    if positions.dim() != 1:
        raise ValueError("positions must be 1-D")
    n = positions.shape[0]
    letters = torch.empty(n, dtype=torch.int32, device=device)
    lf = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return letters, lf
    fn, name, kernel = state.entry(dev, "letter_lf")
    rc = _launch(
        kernel, fn, device.index, state.ref, positions.data_ptr(), n,
        letters.data_ptr(), lf.data_ptr(), _stream(device),
    )
    _check(rc, name)
    kernel.count("letter_lf")
    return letters, lf


def _single(dev, suffix: str, *args):
    """One single-query launch of K1's form ``suffix`` with ``args`` by
    value, then its 16 B readback: ``(word 0, word 1)`` as u64 ints. No
    host-to-device copy; one launch, one device-to-host copy and one
    synchronisation of the current stream. A view on the CPU is refused
    (``_tables``) before anything is built."""
    state = _view_state(dev)
    device = dev.packed.device
    fn, name, kernel = state.entry(dev, suffix)
    with state.lock:
        out, host, words = state.buffers(device)
        stream = _stream(device)
        _check(_launch(kernel, fn, device.index, state.ref, *args, out, stream), name)
        kernel.count(suffix)
        _check(_library().awfm_read_back(device.index, host, out, 16, stream), "awfm_read_back")
        return words[0], words[1]


def k1_step(dev, start: int, end: int, letter: int):
    """K1's step mode (K1w's for a wide view, over compact rows without
    pair rows): the unconditional backward step of one range, ``(newStart,
    newEnd)``. ``start`` and ``end`` are u32 (u64) values, ``letter`` a
    u32 that the launcher clamps to 255, as ``rank.step_args`` packs them."""
    return _single(dev, "step", start, end, letter)


def k1_lf_at(dev, position: int):
    """K1's LF mode for one position (a u32 or u64 value): ``(letter at
    it, LF)``, the sentinel's LF 0."""
    return _single(dev, "lf_at", position)


def empty_call(dev) -> None:
    """The floor of a single-query call on the view: an empty launch, then
    the 16 B readback, through the view's buffers and the current stream.
    Counted on no kernel."""
    state = _view_state(dev)
    device = dev.packed.device
    with state.lock:
        out, host, _ = state.buffers(device)
        stream = _stream(device)
        lib = _library()
        _check(lib.awfm_empty(device.index, stream), "awfm_empty")
        _check(lib.awfm_read_back(device.index, host, out, 16, stream), "awfm_read_back")


def _first_block(dev, first_block: int) -> int:
    if not (0 <= first_block and first_block + dev.packed.shape[0] < 2**31):
        raise ValueError("need 0 <= first_block and first_block + the shard's rows < 2^31")
    return int(first_block)


MAX_SHARDS = 128  # shards the route counts a block (kRouteMaxShards)


def _optional(t: Optional[torch.Tensor], name: str, dtype, device, n: int):
    """The data pointer of an optional (n,) tensor, or None."""
    if t is None:
        return None
    _require(t, name, dtype, device)
    if t.shape != (n,):
        raise ValueError(f"{name} must be ({n},), got {tuple(t.shape)}")
    return t.data_ptr()


def k1r_route(positions: torch.Tensor, out: torch.Tensor, n_shards: int,
              blocks_per_shard: int, wide: bool, unowned: int, counts: torch.Tensor,
              ratio: int = 0, off: Optional[torch.Tensor] = None,
              letters: Optional[torch.Tensor] = None):
    """The route of a range-sharded step (K1R's and K1Rw's): each of the n
    ``positions`` goes to the shard that owns its block, or to none.
    Returns ``(slot_pos, slot_lane)``, (n,) int64 and int32: shard s's
    slice is ``[sum(counts[:s]), sum(counts[:s + 1]))`` of both, each
    entry a routed lane's position (as u32 when narrow) and its lane
    index, in an order that varies from run to run. ``counts`` ((n_shards
    + 1,) int32) receives the totals; its last entry is the route's
    barrier. A lane no shard owns gets ``unowned`` in ``out`` and, when
    ``letters`` is given, 0 there. ``ratio`` > 0 is the LF mode's done
    rule: a lane with ``position % ratio == 0`` is not routed and keeps
    its ``out`` and ``off``; every other lane gets ``off + 1``. ``out``
    may be ``positions`` (the LF step in place). Lane indices are int32,
    so a batch holds fewer than 2^31 lanes."""
    device = positions.device
    _require(positions, "positions", torch.int64, device)
    if positions.dim() != 1:
        raise ValueError("positions must be 1-D")
    n = positions.shape[0]
    if n >= 2**31:
        raise ValueError(f"the route takes fewer than 2^31 lanes, got {n}")
    if not (1 <= n_shards <= MAX_SHARDS and blocks_per_shard >= 1
            and n_shards * blocks_per_shard < 2**31):
        raise ValueError(f"need 1 <= n_shards <= {MAX_SHARDS} and n_shards * "
                         f"blocks_per_shard < 2^31")
    if not 0 <= ratio < (2**64 if wide else 2**32):
        raise ValueError("ratio must be a position value >= 0")
    out_p = _optional(out, "out", torch.int64, device, n)
    _require(counts, "counts", torch.int32, device)
    if counts.shape != (n_shards + 1,):
        raise ValueError(f"counts must be ({n_shards + 1},)")
    off_p = _optional(off, "off", torch.int64, device, n)
    letters_p = _optional(letters, "letters", torch.int32, device, n)
    slot_pos = torch.empty(n, dtype=torch.int64, device=device)
    slot_lane = torch.empty(n, dtype=torch.int32, device=device)
    rc = _launch(
        K1R_ROUTE, _library().awfm_k1r_route,
        device.index, int(bool(wide)), positions.data_ptr(), n, int(n_shards),
        int(blocks_per_shard), int(ratio), int(unowned), out_p, off_p, letters_p,
        slot_pos.data_ptr(), slot_lane.data_ptr(), counts.data_ptr(), _stream(device))
    _check(rc, "awfm_k1r_route")
    if n:
        K1R_ROUTE.launches += 1
    return slot_pos, slot_lane


def _slice(dev, slot_pos, slot_lane, counts, shard: int, count: int):
    """Checks a shard's slice: the route's buffers and totals (``slot_lane``
    and ``counts`` given; ``shard`` names the slice), or a slice copied to
    the shard's device (both None; its ``count`` entries)."""
    device = dev.packed.device
    _require(slot_pos, "slot_pos", torch.int64, device)
    if slot_pos.dim() != 1:
        raise ValueError("slot_pos must be 1-D")
    n = slot_pos.shape[0]
    if (slot_lane is None) != (counts is None):
        raise ValueError("slot_lane and counts go together (None: a copied slice)")
    if slot_lane is None:
        if count != n:
            raise ValueError(f"a copied slice holds count = {n} entries, got {count}")
        return None, None, 0, n
    _optional(slot_lane, "slot_lane", torch.int32, device, n)
    _require(counts, "counts", torch.int32, device)
    if counts.dim() != 1 or not 0 <= shard < counts.shape[0] - 1:
        raise ValueError("counts must be the route's (n_shards + 1,) totals and shard one of them")
    return slot_lane.data_ptr(), counts.data_ptr(), int(shard), 0


def k1r_occurrence(dev, first_block: int, slot_pos: torch.Tensor,
                   slot_lane: Optional[torch.Tensor], counts: Optional[torch.Tensor],
                   shard: int, letters: torch.Tensor, out: torch.Tensor,
                   count: int = 0) -> None:
    """K1R (K1Rw for a wide shard), occ mode over shard ``shard``'s slice of
    the route's buffers: ``out[lane] = occ(letters[lane], position)`` for
    each of its lanes, the shard's rows being global blocks ``first_block
    ..``. For a slice copied to the shard's device (``slot_lane`` and
    ``counts`` None), entry j takes ``letters[j]`` and goes to ``out[j]``.
    ``letters`` and ``out`` have ``slot_pos``'s shape."""
    tables = _view_state(dev, shard=True).tables
    device = dev.packed.device
    first_block = _first_block(dev, first_block)
    lane_p, counts_p, shard, count = _slice(dev, slot_pos, slot_lane, counts, shard, count)
    n = slot_pos.shape[0]
    _optional(letters, "letters", torch.int32, device, n)
    _optional(out, "out", torch.int64, device, n)
    if n == 0:
        return
    fn, name, kernel = _entry(dev, K1R, "occ")
    rc = _launch(kernel, fn, device.index, ctypes.byref(tables), first_block,
                 slot_pos.data_ptr(), lane_p, counts_p, shard, count, n,
                 letters.data_ptr(), out.data_ptr(), _stream(device))
    _check(rc, name)
    kernel.launches += 1


def k1r_lf(dev, first_block: int, slot_pos: torch.Tensor, slot_lane: Optional[torch.Tensor],
           counts: Optional[torch.Tensor], shard: int, p: torch.Tensor,
           letters: Optional[torch.Tensor] = None, count: int = 0) -> None:
    """K1R (K1Rw for a wide shard), LF mode over shard ``shard``'s slice:
    ``p[lane]`` = LF of the lane's position (C[l] + occ(min(l, ambiguity
    letter), pos) - 1 wrapped to the width, the sentinel -> 0) and
    ``letters[lane]`` = l when given. Lanes and copied slices as
    ``k1r_occurrence``."""
    tables = _view_state(dev, shard=True).tables
    device = dev.packed.device
    first_block = _first_block(dev, first_block)
    lane_p, counts_p, shard, count = _slice(dev, slot_pos, slot_lane, counts, shard, count)
    n = slot_pos.shape[0]
    _optional(p, "p", torch.int64, device, n)
    letters_p = _optional(letters, "letters", torch.int32, device, n)
    if n == 0:
        return
    fn, name, kernel = _entry(dev, K1R, "lf")
    rc = _launch(kernel, fn, device.index, ctypes.byref(tables), first_block,
                 slot_pos.data_ptr(), lane_p, counts_p, shard, count, n,
                 p.data_ptr(), letters_p, _stream(device))
    _check(rc, name)
    kernel.launches += 1


def k1_extend(dev, table: torch.Tensor) -> torch.Tensor:
    """K1X (K1WX for a wide view): one depth of the seed-table BFS. The
    (card * n, 2) children of the (n, 2) parent ranges ``table``, in the
    view's storage type (u32 in int32, u64 in int64): child ``l * n + i``
    is parent i stepped by letter l, unconditionally."""
    tables = _view_state(dev).tables
    device = dev.packed.device
    _require(table, "table", _pos_dtype(dev), device)
    if table.dim() != 2 or table.shape[1] != 2:
        raise ValueError(f"table must be (n, 2), got {tuple(table.shape)}")
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    card = dev.cardinality
    if card != {3: 4, 5: 20}.get(dev.n_planes):
        raise ValueError(f"K1X takes 4 letters over 3 planes or 20 over 5, "
                         f"not {card} over {dev.n_planes}")
    n = table.shape[0]
    nxt = torch.empty((card * n, 2), dtype=table.dtype, device=device)
    if n == 0:
        return nxt
    fn, name, kernel = _entry(dev, K1X, "extend")
    rc = _launch(kernel, fn, device.index, ctypes.byref(tables), table.data_ptr(), n,
                 nxt.data_ptr(), _stream(device))
    _check(rc, name)
    kernel.launches += 1
    return nxt


def k1_seed_table(dev, levels: int) -> torch.Tensor:
    """K1X's BFS mode (K1WX's for a wide view, over compact rows without
    pair rows): level ``levels`` of the seed-table BFS, the (card**levels,
    2) ranges in the view's storage type, in ONE cooperative launch. The
    depth-1 ranges are formed in the kernel from the view's C[] ([C[l],
    C[l + 1] - 1], wrapped to the width), then ``levels - 1`` depths of
    K1X's warp body run with a grid barrier between two; levels 2 ..
    ``levels - 1`` and the barriers' counters lie in one scratch
    allocation. No host table, no host-to-device copy: the output and the
    scratch are allocated once each and the library is called once. A view
    on the CPU is refused (``_tables``) before anything is built or
    launched, and a refused launch raises; nothing falls back."""
    state = _view_state(dev)
    device = dev.packed.device
    card = dev.cardinality
    if card != {3: 4, 5: 20}.get(dev.n_planes):
        raise ValueError(f"K1X takes 4 letters over 3 planes or 20 over 5, "
                         f"not {card} over {dev.n_planes}")
    if levels < 1 or card**levels >= 2**31:
        raise ValueError(f"need 1 <= levels and card**levels < 2^31, got levels={levels}")
    out = torch.empty((card**levels, 2), dtype=_pos_dtype(dev), device=device)
    fn, name, kernel = _entry(dev, K1X, "seed_table")
    nbytes = _library().awfm_seed_table_scratch_bytes(card, levels, out.element_size())
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=device) if nbytes else None
    rc = _launch(kernel, fn, device.index, state.ref, int(levels),
                 None if scratch is None else scratch.data_ptr(), nbytes, out.data_ptr(),
                 _stream(device))
    _check(rc, name)
    kernel.count("bfs")
    return out


def k2_ranges(dev, mat: torch.Tensor, lengths: torch.Tensor, seeded: torch.Tensor):
    """K2: final (start, end) BWT ranges, (b,) int64 each, as u32; K2w
    for a wide view, as u64; over block rows (compact wide rows) for a
    view without pair rows."""
    tables = _tables(dev)
    device = dev.packed.device
    _require(dev.seed_table, "seed_table", _pos_dtype(dev), device)
    if dev.seed_table.dim() != 2 or dev.seed_table.shape[1] != 2:
        raise ValueError("seed_table must be (rows, 2)")
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
    fn, name, kernel = _entry(dev, K2, "ranges")
    rc = _launch(
        kernel, fn, device.index, ctypes.byref(tables), dev.seed_table.data_ptr(),
        int(dev.seed_table.shape[0]), int(dev.kmer_length_in_seed_table),
        mat.data_ptr(), b, l_pad, lengths.data_ptr(), seeded.data_ptr(),
        start.data_ptr(), end.data_ptr(), *_row_steps(kernel, device), _stream(device),
    )
    _check(rc, name)
    kernel.launches += 1
    return start, end


def k3_backtrace_resolve(dev, positions: torch.Tensor):
    """K3 (K3w for a wide view, over compact rows for a view without pair
    rows): hits (n,) int64 when the sampled SA is resident, else the
    sampled positions and walk offsets ((n,) int64 each), each at its
    hit's own index whatever lane walked it."""
    return _backtrace(dev, positions, _tables(dev), lambda: _entry(dev, K3, "backtrace_resolve"))


def _backtrace(dev, positions: torch.Tensor, tables, entry):
    """K3's launch; ``entry()`` gives (C entry point, its name, its
    Kernel), asked for only after the tensors are checked, so a CPU
    tensor is refused before any build."""
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
        _require(dev.sampled_sa, "sampled_sa", _pos_dtype(dev), device)
        if dev.sampled_sa.dim() != 1:
            raise ValueError("sampled_sa must be 1-D")
        hits = torch.empty(n, dtype=torch.int64, device=device)
    if n == 0:
        return (p, off) if on_disk else hits
    if dev.ratio < 1 or (not dev.wide and dev.bwt_length >= 2**32):
        raise ValueError("need ratio >= 1, and a wide view for bwtLength >= 2^32")
    fn, name, kernel = entry()
    rc = _launch(
        kernel, fn, device.index, ctypes.byref(tables), positions.data_ptr(), n,
        int(dev.ratio), int(dev.bwt_length),
        None if on_disk else dev.sampled_sa.data_ptr(),
        None if on_disk else hits.data_ptr(),
        p.data_ptr() if on_disk else None,
        off.data_ptr() if on_disk else None,
        _stream(device),
    )
    _check(rc, name)
    kernel.launches += 1
    return (p, off) if on_disk else hits


def k4_ngram_ranges(dev, ng, mat: torch.Tensor, kmer_len: int):
    """K4: final (start, end) BWT ranges of a uniform-length clean batch
    through the n-gram table ``ng``, (b,) int64 each, as u32; its tail
    steps over the block rows for a view without pair rows. K4 reads
    ``ng.k4``, the rows in its own layout (``ops/ngram.py:k4_rows``); an
    index without it is refused."""
    if dev.wide:
        raise ValueError("K4 takes narrow views only")
    tables = _tables(dev)
    device = dev.packed.device
    _require(dev.seed_table, "seed_table", torch.int32, device)
    if ng.n not in (2, 3) or ng.cn.shape != (4**ng.n,):
        raise ValueError(f"unsupported n-gram table (n={ng.n})")
    rows = ng.k4
    if rows is None:
        raise ValueError("K4 reads the n-gram rows in its layout (NgramIndex.k4, made by "
                         "ops/ngram.k4_rows when the index is placed on the card)")
    _require(rows, "ngram k4 rows", torch.uint8, device)
    _require(ng.cn, "ngram cn", torch.int32, device)
    _require(mat, "mat", torch.uint8, device)
    if rows.data_ptr() % 16:
        raise ValueError("row tables must be 16-byte aligned")
    want = (dev.packed.shape[0], _geometry_k4(ng.n)[3])
    if tuple(rows.shape) != want or tuple(ng.packed.shape) != want:
        raise ValueError(f"n={ng.n} n-gram rows must be {want} (the index's blocks), got "
                         f"{tuple(rows.shape)} and packed {tuple(ng.packed.shape)}")
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
        packed=rows.data_ptr(), cn=ng.cn.data_ptr(),
        nb=int(rows.shape[0]), row_bytes=int(rows.shape[1]),
        n=int(ng.n), biased=int(bool(ng.biased)),
    )
    fn, name, kernel = _entry(dev, K4, "ngram_ranges")
    rc = _launch(
        kernel, fn, device.index, ctypes.byref(tables), ctypes.byref(ngt),
        dev.seed_table.data_ptr(), int(dev.seed_table.shape[0]), k,
        mat.data_ptr(), b, l_pad, int(kmer_len),
        start.data_ptr(), end.data_ptr(), *_row_steps(kernel, device), _stream(device),
    )
    _check(rc, name)
    kernel.launches += 1
    return start, end


def _probe_table(table: torch.Tensor, name: str, dtype, widths) -> torch.device:
    """Checks a K5/K6 table: a contiguous 2-D CUDA tensor of ``dtype``,
    16-byte aligned, with a row width the kernel is built for and fewer
    than 2^31 rows; returns its device."""
    _require(table, name, dtype, table.device)
    if table.dim() != 2 or table.shape[1] * table.element_size() not in widths:
        raise ValueError(f"{name} must be 2-D with rows of {widths} bytes, got {tuple(table.shape)}")
    if table.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")
    if not 0 < table.shape[0] < 2**31:
        raise ValueError(f"{name} must have 1 .. 2^31 - 1 rows")
    return table.device


def _probe_idx(idx: torch.Tensor, device) -> int:
    _require(idx, "idx", torch.int32, device)
    if idx.dim() != 1:
        raise ValueError("idx must be 1-D")
    return int(idx.shape[0])


def k5_gather_reduce(table: torch.Tensor, idx: torch.Tensor, sum_bytes: int,
                     chunk: int, ring: int) -> torch.Tensor:
    """K5: (ceil(n / chunk),) int32 partial sums of the first ``sum_bytes``
    bytes of each index's row, ``ring`` 16 B pieces in flight per lane
    (``probes.gather_reduce``)."""
    from .probes import K5_RING_DEPTHS, K5_ROW_BYTES

    device = _probe_table(table, "table", torch.uint8, K5_ROW_BYTES)
    n = _probe_idx(idx, device)
    row_bytes = int(table.shape[1])
    if sum_bytes % 16 or not 16 <= sum_bytes <= row_bytes:
        raise ValueError(f"sum_bytes must be a multiple of 16 in [16, {row_bytes}]")
    if chunk < 1 or ring not in K5_RING_DEPTHS:
        raise ValueError(f"need chunk >= 1 and ring in {K5_RING_DEPTHS}")
    out = torch.empty((n + chunk - 1) // chunk, dtype=torch.int32, device=device)
    if n == 0:
        return out
    rc = _launch(
        K5, _library().awfm_k5_gather_reduce,
        device.index, table.data_ptr(), int(table.shape[0]), row_bytes,
        idx.data_ptr(), n, int(sum_bytes), int(chunk), int(ring),
        out.data_ptr(), _stream(device),
    )
    _check(rc, "awfm_k5_gather_reduce")
    K5.launches += 1
    return out


def k5_gather_walk(table: torch.Tensor, idx: torch.Tensor, seg: int,
                   sector_mask: int = 0xFFFFFFFF, lanes: int = 1) -> torch.Tensor:
    """K5's walk entry: (n,) int32 indices after ``seg`` dependent steps,
    each reading and summing the row's 32 B sectors set in ``sector_mask``;
    ``lanes`` (1 or 4) neighbouring lanes walk each chain."""
    from .probes import K5_WALK_LANES, K5_WALK_ROW_BYTES

    device = _probe_table(table, "table", torch.uint8, K5_WALK_ROW_BYTES)
    n = _probe_idx(idx, device)
    if seg < 0 or not 0 <= sector_mask <= 0xFFFFFFFF or lanes not in K5_WALK_LANES:
        raise ValueError(f"need seg >= 0, a 32-bit sector_mask and lanes in {K5_WALK_LANES}")
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    rc = _launch(
        K5, _library().awfm_k5_gather_walk,
        device.index, table.data_ptr(), int(table.shape[0]), int(table.shape[1]),
        idx.data_ptr(), n, int(seg), int(sector_mask), int(lanes), out.data_ptr(),
        _stream(device),
    )
    _check(rc, "awfm_k5_gather_walk")
    K5.launches += 1
    return out


def k6_slab_gather(slab: torch.Tensor, idx: torch.Tensor,
                   out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K6: (n, 128) int32 rows ``slab[idx]`` of a (S, 128) u32 slab;
    written into ``out`` when given (a caller that may not allocate, as
    under CUDA-graph capture)."""
    device = _probe_table(slab, "slab", torch.int32, (512,))
    n = _probe_idx(idx, device)
    if out is None:
        out = torch.empty((n, slab.shape[1]), dtype=torch.int32, device=device)
    else:
        _require(out, "out", torch.int32, device)
        if out.shape != (n, slab.shape[1]) or out.data_ptr() % 16:
            raise ValueError(f"out must be ({n}, {slab.shape[1]}) and 16-byte aligned")
    if n == 0:
        return out
    rc = _launch(
        K6, _library().awfm_k6_slab_gather,
        device.index, slab.data_ptr(), int(slab.shape[0]), idx.data_ptr(), n,
        out.data_ptr(), _stream(device),
    )
    _check(rc, "awfm_k6_slab_gather")
    K6.launches += 1
    return out


def k6_slab_chain(slab: torch.Tensor, idx: torch.Tensor, seg: int) -> torch.Tensor:
    """K6's chained entry: (n,) int32 indices after ``seg`` steps of
    ``idx <- (row[0] + row[37]) mod S``."""
    device = _probe_table(slab, "slab", torch.int32, (512,))
    n = _probe_idx(idx, device)
    if seg < 0:
        raise ValueError("seg must be >= 0")
    out = torch.empty(n, dtype=torch.int32, device=device)
    if n == 0:
        return out
    rc = _launch(
        K6, _library().awfm_k6_slab_chain,
        device.index, slab.data_ptr(), int(slab.shape[0]), idx.data_ptr(), n,
        int(seg), out.data_ptr(), _stream(device),
    )
    _check(rc, "awfm_k6_slab_chain")
    K6.launches += 1
    return out

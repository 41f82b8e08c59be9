"""The gather-rate probes P2-P5, run through K5 and K6 on one card.

    python -m avxwindowfmindex_tpu_torch.tools.gather_probe [--device cuda:0]
        [--table-bytes 1073741824] [--batch 524288]

Each experiment's own protocol, with the plain torch gather (the
kernel's plain version) timed beside the kernel, as the experiments timed
their XLA references beside their Pallas kernels:

  P2 (experiments/pallas_gather_bench.py)  2^19 random indices over a
      1 GiB table of 128 B and of 512 B rows, ring depths 8 and 16, CHUNK
      512, every row byte summed into one wrapping int32 (K5);
  P3 (experiments/pallas_aligned_bench.py)  the same over (2^20, 8, 128)
      1 KB rows, the first 128 B of each summed, (K, CHUNK) in (8, 512),
      (16, 512), (32, 1024) (K5, sum_bytes 128);
  P4 (experiments/gather_pair_bench.py)  the P2 ring with one partial sum
      per CHUNK, (row bytes, K) in (128, 8), (512, 8), (128, 16) (K5);
  P5 (experiments/ab_r5_pallas_gather.py)  a chained gather out of a
      (S, 128) u32 slab, S in 2048 and 8192, idx <- (row[0] + row[37])
      mod S, the rate taken by differencing 8-step and 2-step chains
      (K6).

P2-P4: each timing is the median over 5 repetitions of 6 launches and a
one-value readback (``sec_per_iter``, ``Mfetch_s``). Every probe checks
the kernel's result against the plain version's (``equal``). One JSON
line per probe on stdout, progress on stderr. Each 1 GiB table is freed
before the next is made.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

ITERS = 6
REPS = 5
SEG_LO, SEG_HI = 2, 8

P2_CONFIGS = ((128, 8, 512), (128, 16, 512), (512, 8, 512), (512, 16, 512))
P3_CONFIGS = ((8, 512), (16, 512), (32, 1024))
P4_CONFIGS = ((128, 8, 512), (512, 8, 512), (128, 16, 512))
P5_SLAB_ROWS = (2048, 8192)


def _log(msg: str) -> None:
    print(f"[probe] {msg}", file=sys.stderr, flush=True)


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _timeit(fn, readback, iters: int, reps: int) -> float:
    """Median seconds of ``iters`` calls plus one readback (warm-up first)."""
    readback(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        r = None
        for _ in range(iters):
            r = fn()
        readback(r)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rates(name: str, sec: float, batch: int, iters: int) -> dict:
    per_iter = sec / iters
    return {f"{name}_sec_per_iter": per_iter, f"{name}_Mfetch_s": batch / per_iter / 1e6}


def _random_table(nb: int, row_bytes: int, device, seed: int):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (nb, row_bytes), dtype=torch.uint8, device=device, generator=gen)


def _random_idx(n: int, hi: int, device, seed: int):
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, hi, (n,), dtype=torch.int32, device=device, generator=gen)


def run_k5(probe: str, table, idx, *, sum_bytes: int, ring: int, chunk: int,
           iters: int, reps: int) -> dict:
    """One K5 configuration against its plain version: P4's partials are
    compared, P2's and P3's scalar is their wrapped sum."""
    from ..ops import probes

    got = probes.gather_reduce(table, idx, sum_bytes=sum_bytes, chunk=chunk, ring=ring)
    want = probes.gather_reduce_plain(table, idx, sum_bytes, chunk)
    readback = probes.wrapped_total
    k = _timeit(lambda: probes.gather_reduce(table, idx, sum_bytes=sum_bytes, chunk=chunk, ring=ring),
                readback, iters, reps)
    pl = _timeit(lambda: probes.gather_reduce_plain(table, idx, sum_bytes, chunk), readback, iters, reps)
    return {
        "probe": probe, "kernel": "k5_gather_reduce",
        "exp": f"u8x{table.shape[1]}_sum{sum_bytes}_K{ring}_C{chunk}",
        "rows": int(table.shape[0]), "row_bytes": int(table.shape[1]), "batch": int(idx.shape[0]),
        "equal": bool((got == want).all()),
        "total": probes.wrapped_total(got),
        **_rates("kernel", k, idx.shape[0], iters), **_rates("plain", pl, idx.shape[0], iters),
    }


def run_p5(slab_rows: int, device, reps: int) -> dict:
    """P5: K6's chained gather against the plain chain, seg-differenced."""
    import torch

    from ..ops import probes
    from ..utils.roofline import difference_rate

    gen = torch.Generator(device=device).manual_seed(slab_rows)
    slab = torch.randint(-(2**31), 2**31, (slab_rows, probes.SLAB_LANES), dtype=torch.int32,
                         device=device, generator=gen)
    idx0 = _random_idx(slab_rows, slab_rows, device, 11)
    equal = bool(torch.equal(probes.slab_gather(slab, idx0), probes.slab_gather_plain(slab, idx0)))
    equal &= bool(torch.equal(probes.slab_chain(slab, idx0, SEG_HI),
                              probes.slab_chain_plain(slab, idx0, SEG_HI)))

    def rate(chain):
        def run(seg):
            return int(chain(slab, idx0, seg).to(torch.int64).sum())

        return difference_rate(run, slab_rows, reps, SEG_LO, SEG_HI)

    return {
        "probe": "P5", "kernel": "k6_slab_gather", "exp": f"slab_S{slab_rows}_chain",
        "rows": slab_rows, "row_bytes": 4 * probes.SLAB_LANES, "equal": equal,
        "kernel_Mrows_s": rate(probes.slab_chain) / 1e6,
        "plain_Mrows_s": rate(probes.slab_chain_plain) / 1e6,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Gather-rate probes P2-P5 through K5/K6")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--table-bytes", type=int, default=1 << 30)
    ap.add_argument("--batch", type=int, default=1 << 19)
    ap.add_argument("--iters", type=int, default=ITERS)
    ap.add_argument("--reps", type=int, default=REPS)
    args = ap.parse_args(argv)

    import torch

    from .bench import device_line, resolve_device

    device = resolve_device(args.device)
    line = device_line(device)
    _log(line)
    failed = []

    def emit(rec):
        _emit({**rec, "device": line})
        if not rec["equal"]:
            failed.append(rec["exp"])

    def by_width(configs, width_of):
        widths = sorted({width_of(c) for c in configs})
        for r in widths:
            table = _random_table(args.table_bytes // r, r, device, 7)
            idx = _random_idx(args.batch, table.shape[0], device, 8)
            for c in configs:
                if width_of(c) == r:
                    yield table, idx, c
            del table, idx
            if device.type == "cuda":
                torch.cuda.empty_cache()

    for probe, configs in (("P2", P2_CONFIGS), ("P4", P4_CONFIGS)):
        for table, idx, (r, ring, chunk) in by_width(configs, lambda c: c[0]):
            emit(run_k5(probe, table, idx, sum_bytes=r, ring=ring, chunk=chunk,
                        iters=args.iters, reps=args.reps))
    p3 = [(1024, ring, chunk) for ring, chunk in P3_CONFIGS]
    for table, idx, (_, ring, chunk) in by_width(p3, lambda c: c[0]):
        emit(run_k5("P3", table, idx, sum_bytes=128, ring=ring, chunk=chunk,
                    iters=args.iters, reps=args.reps))
    for s in P5_SLAB_ROWS:
        emit(run_p5(s, device, args.reps))
    if failed:
        raise AssertionError(f"kernel and plain version disagree: {failed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

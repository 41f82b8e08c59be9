"""Scaling report: queries/s across device lists and process counts.

The counterpart of ``avxwindowfmindex_tpu/tools/scaling_report.py``,
with its arguments and its JSON row keys. It measures the query-parallel
engine (``parallel/dist.py``) at each rung:

  - one device                         (1 card)
  - a list of 2/4/8 devices            (1 host, data-parallel queries)
  - N ``torch.distributed`` processes  (N "hosts", all-gather count merge)

``--platform cuda`` (the default) runs on the cards and raises without
CUDA; a rung of n devices takes cards 0..n-1 where there are that many,
else the one card n times, and its label says so. ``--platform cpu``
runs every kernel's plain version on ``["cpu"] * n``: it checks the
structure and the shape of the scaling, not a device's throughput. The
multi-process rung's workers (torch and the port only) build the same
index and each runs ``count_allgather`` on its slice of the batch: over
NCCL, one card a worker, where there are enough cards; over gloo, sharing
cuda:0 with the collective through host memory, where there are not; over
gloo on the CPU with ``--platform cpu``. The rung's label names the
backend. A worker that fails or hangs skips the rung with a printed line.

Usage:
    python -m avxwindowfmindex_tpu_torch.tools.scaling_report \\
        [--bases 1048576] [--queries 8192] [--kmer-len 25] [--seed-k 8] \\
        [--devices 1,2,4,8] [--mode strong|weak] [--hosts 2] \\
        [--platform cpu|cuda] [--json out.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
WORKER_TIMEOUT_S = 300


def _parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bases", type=int, default=1 << 20)
    ap.add_argument("--queries", type=int, default=8192,
                    help="total queries (strong) / per-device (weak)")
    ap.add_argument("--kmer-len", type=int, default=25)
    ap.add_argument("--seed-k", type=int, default=8)
    ap.add_argument("--sa-ratio", type=int, default=8)
    ap.add_argument("--devices", type=str, default="1,2,4,8",
                    help="comma-separated device-list sizes")
    ap.add_argument("--mode", choices=["strong", "weak"], default="strong")
    ap.add_argument("--hosts", type=int, default=2,
                    help="process count for the multi-process rung (0 = skip)")
    ap.add_argument("--platform", choices=["cpu", "cuda"], default="cuda")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--json", type=str, default=None)
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def _build(args, device):
    import numpy as np
    from avxwindowfmindex_tpu_torch import AlphabetType, IndexConfiguration, create_index

    rng = np.random.default_rng(args.seed)
    seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=args.bases).tobytes()
    cfg = IndexConfiguration(
        args.sa_ratio, args.seed_k, AlphabetType.DNA, keep_suffix_array_in_memory=True,
    )
    return seq, create_index(seq, cfg, device=device), rng


def _make_queries(rng, seq: bytes, n: int, k: int):
    pos = rng.integers(0, len(seq) - k, size=n)
    return [seq[p : p + k] for p in pos]


def _timed(fn, repeats: int):
    fn()  # warm-up
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        fn()  # every call ends in a host readback of its answers
        best = min(best, time.perf_counter() - t0)
    return best


def _rung_devices(platform: str, n_dev: int):
    """(device list, rung label) for a rung of ``n_dev`` devices."""
    import torch

    if platform == "cpu":
        return ["cpu"] * n_dev, f"1 host x {n_dev} dev"
    if torch.cuda.device_count() >= n_dev:
        return [f"cuda:{i}" for i in range(n_dev)], f"1 host x {n_dev} dev"
    return ["cuda:0"] * n_dev, f"1 host x {n_dev} parts on 1 card"


def _single_host_rows(args, index, rng, seq):
    import numpy as np
    from avxwindowfmindex_tpu_torch.parallel.dist import DistributedSearchEngine

    rows = []
    for n_dev in [int(s) for s in args.devices.split(",")]:
        n_q = args.queries * (n_dev if args.mode == "weak" else 1)
        kmers = _make_queries(rng, seq, n_q, args.kmer_len)
        devices, label = _rung_devices(args.platform, n_dev)
        eng = DistributedSearchEngine(index, devices)
        t_count = _timed(lambda: eng.count(kmers), args.repeats)
        t_rep = _timed(lambda: eng.count_replicated(kmers), args.repeats)
        t_locate = _timed(lambda: np.concatenate(eng.locate(kmers) or [np.empty(0)]),
                          args.repeats)
        rows.append({
            "rung": label,
            "devices": n_dev, "hosts": 1, "queries": n_q,
            "count_qps": n_q / t_count,
            "count_allgather_qps": n_q / t_rep,
            "locate_qps": n_q / t_locate,
        })
        print(f"[scaling] {label}: count {rows[-1]['count_qps']:.0f} q/s, "
              f"all-gather {rows[-1]['count_allgather_qps']:.0f} q/s, "
              f"locate {rows[-1]['locate_qps']:.0f} q/s")
    return rows


_HOST_WORKER = r"""
import json, sys, time
import numpy as np
import torch
from avxwindowfmindex_tpu_torch import AlphabetType, IndexConfiguration, create_index
from avxwindowfmindex_tpu_torch.parallel import dist

cfgj, init, rank = json.loads(sys.argv[1]), sys.argv[2], int(sys.argv[3])
n_procs, device = cfgj["hosts"], cfgj["devices"][rank]
if device == "cpu":
    torch.set_num_threads(1)
dist.init_process_group(n_procs, rank, init, device, backend=cfgj["backend"])
rng = np.random.default_rng(cfgj["seed"])
seq = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=cfgj["bases"]).tobytes()
index = create_index(
    seq, IndexConfiguration(cfgj["sa_ratio"], cfgj["seed_k"], AlphabetType.DNA), device=device)
engine = dist.DistributedSearchEngine(index, [device])
k = cfgj["kmer_len"]
pos = rng.integers(0, len(seq) - k, size=cfgj["queries"])
kmers = [seq[p : p + k] for p in pos]
local = kmers[rank * len(kmers) // n_procs : (rank + 1) * len(kmers) // n_procs]
engine.count_allgather(local)  # warm-up
best = float("inf")
for _ in range(cfgj["repeats"]):
    torch.distributed.barrier()
    t0 = time.perf_counter()
    counts = engine.count_allgather(local)
    best = min(best, time.perf_counter() - t0)
torch.distributed.destroy_process_group()
print("RESULT " + json.dumps({"proc": rank, "seconds": best, "queries": len(counts)}))
"""


def _multihost_plan(args):
    """(per-worker devices, backend, rung label) of the multi-process rung."""
    import torch

    hosts = args.hosts
    if args.platform == "cpu":
        return ["cpu"] * hosts, "gloo", f"{hosts} hosts x 1 dev (all-gather merge, gloo)"
    if torch.cuda.device_count() >= hosts:
        return ([f"cuda:{i}" for i in range(hosts)], "nccl",
                f"{hosts} hosts x 1 card (all-gather merge, nccl)")
    return (["cuda:0"] * hosts, "gloo",
            f"{hosts} hosts sharing 1 card (all-gather merge, gloo through host memory)")


def _multihost_row(args, tmpdir: str):
    """N-process rung: every worker counts its slice, all-gather merge."""
    from avxwindowfmindex_tpu_torch.parallel.dist import spawn_ranks

    devices, backend, label = _multihost_plan(args)
    script = os.path.join(tmpdir, "scaling_worker.py")
    with open(script, "w") as f:
        f.write(_HOST_WORKER)
    cfgj = json.dumps({
        "bases": args.bases, "queries": args.queries,
        "kmer_len": args.kmer_len, "seed_k": args.seed_k,
        "sa_ratio": args.sa_ratio, "repeats": args.repeats,
        "seed": args.seed, "hosts": args.hosts, "devices": devices, "backend": backend,
    })
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    try:
        outs = spawn_ranks(
            [sys.executable, script, cfgj, f"file://{os.path.join(tmpdir, 'rendezvous')}"],
            args.hosts, timeout=WORKER_TIMEOUT_S, env=env)
    except RuntimeError as exc:
        # a failed or hung worker must not take down the measured
        # single-host rows; spawn_ranks has killed every worker
        print(f"[scaling] multi-process rung skipped: {exc}")
        return None
    recs = [json.loads(line[len("RESULT "):]) for out in outs
            for line in out.splitlines() if line.startswith("RESULT ")]
    if len(recs) != args.hosts:
        print(f"[scaling] multi-process rung skipped: {len(recs)} of {args.hosts} results")
        return None
    secs = max(r["seconds"] for r in recs)
    n_q = recs[0]["queries"]
    row = {
        "rung": label,
        "devices": args.hosts, "hosts": args.hosts, "queries": n_q,
        "count_allgather_qps": n_q / secs,
    }
    print(f"[scaling] {row['rung']}: {row['count_allgather_qps']:.0f} q/s")
    return row


def main(argv=None) -> int:
    args = _parse_args(argv)
    try:
        sizes = [int(s) for s in args.devices.split(",")]
        if not sizes or any(s < 1 for s in sizes):
            raise ValueError(sizes)
    except ValueError:
        print(f"error: --devices must be a comma-separated list of "
              f"positive device counts, got {args.devices!r}", file=sys.stderr)
        return 2
    from avxwindowfmindex_tpu_torch.models.index import resolve_device

    device = resolve_device(args.platform)  # raises for cuda without CUDA

    print(f"[scaling] platform={args.platform} bases={args.bases} "
          f"queries={args.queries} k={args.kmer_len} mode={args.mode}")
    seq, index, rng = _build(args, device)
    rows = _single_host_rows(args, index, rng, seq)
    if args.hosts >= 2:
        with tempfile.TemporaryDirectory() as td:
            row = _multihost_row(args, td)
        if row is not None:
            rows.append(row)

    hdr = ("| rung | devices | queries | count q/s | all-gather count q/s "
           "| locate q/s |")
    print()
    print(hdr)
    print("|" + "---|" * 6)
    for r in rows:
        print("| {} | {} | {} | {} | {:.0f} | {} |".format(
            r["rung"], r["devices"], r["queries"],
            ("%.0f" % r["count_qps"]) if "count_qps" in r else "-",
            r["count_allgather_qps"],
            ("%.0f" % r["locate_qps"]) if "locate_qps" in r else "-",
        ))
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"config": vars(args), "rows": rows}, f, indent=2)
        print(f"[scaling] wrote {args.json}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

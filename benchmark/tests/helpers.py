"""Shared pieces of the benchmark's tests: a tiny copy of the
benchmark's data files in a temporary directory, and one tiny run."""

import json
import os
import shutil
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

COMPOSITION = {"A": 8.25, "R": 5.53, "N": 4.06, "D": 5.45, "C": 1.37, "Q": 3.93, "E": 6.75,
               "G": 7.07, "H": 2.27, "I": 5.96, "L": 9.66, "K": 5.84, "M": 2.42, "F": 3.86,
               "P": 4.70, "S": 6.56, "T": 5.34, "W": 1.08, "Y": 2.92, "V": 6.87}

TINY_CONFIGS = {
    "nt-tiny": {"name": "nt-tiny", "alphabet": "dna",
                "text": {"generator": "uniform", "bases": 20000, "letters": "ACGT", "data_seed": 5},
                "seed_k": 6, "sa_ratio": 8, "device_sa_ratio": None, "wide": False,
                "pair_rows": True, "ngram_n": 2, "build_from": "sequence"},
    "aa-tiny": {"name": "aa-tiny", "alphabet": "amino",
                "text": {"generator": "proteins", "proteins": 60, "mean_length": 300,
                         "length_sigma": 0.6, "min_length": 2, "max_length": 3000,
                         "composition": COMPOSITION, "data_seed": 7},
                "seed_k": 3, "sa_ratio": 8, "device_sa_ratio": None, "wide": False,
                "pair_rows": True, "ngram_n": None, "build_from": "fasta"},
}
TINY_TRAFFIC = {
    "l10": {"op": "locate", "source": "text_kmers", "length": 10, "batch": 256, "pool": 3},
    "c10": {"op": "count", "source": "text_kmers", "length": 10, "batch": 256, "pool": 3},
    "l5": {"op": "locate", "source": "text_kmers", "length": 5, "batch": 128, "pool": 3},
    "pep": {"op": "locate", "source": "tryptic_peptides", "cleave_after": "KR", "not_before": "P",
            "min_length": 4, "max_length": 25, "columns": 28, "batch": 128, "pool": 3},
}
TINY_CELLS = [("nt-tiny.l10", "nt-tiny", "l10"), ("nt-tiny.c10", "nt-tiny", "c10"),
              ("nt-tiny.l5", "nt-tiny", "l5"), ("aa-tiny.pep", "aa-tiny", "pep")]


def tiny_manifest(bench_root: str) -> dict:
    """The real manifest's metrics over the tiny cells and files
    written under ``bench_root``/benchmark."""
    with open(os.path.join(ROOT, "BENCHMARK.json")) as fh:
        real = json.load(fh)
    d = os.path.join(bench_root, "benchmark")
    for sub, items in (("configs", TINY_CONFIGS), ("traffic", TINY_TRAFFIC)):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
        for name, body in items.items():
            with open(os.path.join(d, sub, name + ".json"), "w") as fh:
                json.dump(body, fh)
    if not os.path.exists(os.path.join(d, "metrics")):
        shutil.copytree(os.path.join(BENCH, "metrics"), os.path.join(d, "metrics"))
    locate = [c for c, _, t in TINY_CELLS if TINY_TRAFFIC[t]["op"] == "locate"]
    count = [c for c, _, t in TINY_CELLS if TINY_TRAFFIC[t]["op"] == "count"]
    every = locate + count
    cells_of = {"locate_qps": locate, "count_qps": count}
    e2e = [dict(e, workloads=cells_of.get(e["name"], every)) for e in real["end_to_end"]]
    layers = [dict(p, workloads=locate if p["moves"] == "locate_qps" else count)
              for p in real["per_layer"]]
    return {
        "command": real["command"], "paths": real["paths"], "run_seconds": real["run_seconds"],
        "configs": [{"name": n, "source": "tiny", "file": f"benchmark/configs/{n}.json",
                     "reduced": [], "why": "tiny"} for n in TINY_CONFIGS],
        "workloads": [{"name": c, "config": cfg, "traffic": t, "chips": 1, "why": "tiny"}
                      for c, cfg, t in TINY_CELLS],
        "end_to_end": e2e, "per_layer": layers,
    }


def run_tiny(tiny, cell: str, seed: int = 2**31 + 11, seconds: float = 0.05, control=None,
             device="cpu", trace_on: bool = False):
    """One run of a tiny cell with the harness; (result, checks)."""
    import time

    import torch

    from benchmark.harness import main

    m, root = tiny
    res, checks = main.run_cell(
        m, cell, seed, seconds, trace_on, device=torch.device(device), t0=time.perf_counter(),
        control=control, root=root, bench=os.path.join(root, "benchmark"),
        cache_root=os.path.join(root, "cache-" + str(device).replace(":", "")),
    )
    res["correct"] = all(v <= lim for _, v, lim in checks)
    return res, checks

"""One run of one cell: set-up, the measured window, the comparison with
the plain reference, and the result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The request (closed loop, one client, back to back): the next batch of
the pool, already encoded and on the card, goes through the port's
public functions as a pipeline calls them. ``search.ngram_ranges`` (a
uniform nucleotide batch longer than the seed, where the configuration
has an n-gram table) or ``search.search_ranges``; ``range_counts``; for
a locate, the total read back as one scalar and
``locate_flat_device`` at a capacity rounded up from it; then the
answers (the counts, and the hits grouped by query) are copied into
page-locked host buffers that set-up allocated, and the host waits for
them. A request's latency runs from its dispatch to that wait's end.

The last request of each pool batch leaves its answers in that batch's
buffers (cleared before the window); after the window every one of
them, and every request's scalar total, is compared with the reference.

``--control`` (not a run of the benchmark; see README.md) swaps a path
that breaks the configuration's guarantee into the request, to show the
comparison fails: ``first_hit``, the port's ``locate_first_hit`` (one
hit a query); ``seed_count``, the port's ``initial_ranges`` (the range
of the seed alone, no backward step).
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
import types

import numpy as np

from . import index_cache, manifest, textgen, trace, traffic, yardstick

BANNED = ("jax", "jaxlib", "flax", "avxwindowfmindex_tpu")
CAPACITY_GRAIN = 1 << 16  # a locate's capacity: its total rounded up to this
CONTROLS = ("first_hit", "seed_count")
TRACE_WINDOW_S = 3.0


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def parse_args(argv):
    ap = argparse.ArgumentParser(description="One run of one benchmark cell on cuda:0")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=CONTROLS, default=None,
                    help="run a control in place of the program's path (not a benchmark run)")
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    return args


def loaded_banned() -> list:
    return sorted({name.split(".")[0] for name in list(sys.modules)} & set(BANNED))


class _Batch:
    """One pool batch encoded on the device, with what the yardstick needs."""

    def __init__(self, b, lut, dev, ng):
        import torch

        k = dev.kmer_length_in_seed_table
        card = dev.cardinality
        n, cols = b.ascii.shape
        letters = torch.empty_like(b.ascii)
        for j in range(cols):  # the port's own encoding, a column at a time
            letters[:, j] = lut[b.ascii[:, j].long()]
        arange = torch.arange(cols, device=letters.device)
        letters.masked_fill_(arange[None, :] >= b.lengths[:, None], 0)
        lengths = b.lengths.long()
        idx = (lengths[:, None] - k + arange[None, :k]).clamp(0, cols - 1)
        seeded = (lengths >= k) & (letters.gather(1, idx) < card).all(dim=1)
        self.length = int(lengths[0]) if n else 0
        self.ngram = bool(
            ng is not None and n and bool((lengths == self.length).all()) and self.length > k
            and bool((letters[:, :self.length] < 4).all())
        )
        self.queries = n
        self.seeded_count = int(seeded.sum())
        self.steps = int(torch.where(seeded, lengths - k, (lengths - 1).clamp(min=0)).sum())
        self.input_bytes = n * cols + (0 if self.ngram else 5 * n)
        self.mat = letters
        self.lengths = b.lengths.to(torch.int32)
        self.seeded = seeded.to(torch.uint8)


class Client:
    """The one client of the closed loop."""

    def __init__(self, dev, ng, pool, op: str, device, spans, control=None):
        import torch

        from avxwindowfmindex_tpu_torch import search
        from avxwindowfmindex_tpu_torch.models import alphabet as alpha

        self.torch, self.search = torch, search
        lut = alpha.AA_ASCII_TO_INDEX if dev.cardinality == 20 else alpha.NT_ASCII_TO_INDEX
        lut = torch.from_numpy(lut.astype(np.uint8)).to(device)
        self.dev, self.ng, self.op = dev, ng, op
        self.device, self.spans, self.control = device, spans, control
        self.cuda = device.type == "cuda"
        self.batches = []
        for b in pool:
            self.batches.append(_Batch(b, lut, dev, ng))
            b.ascii, b.lengths = b.ascii.cpu(), b.lengths.cpu()
        self.out = [{} for _ in pool]

    def _buffer(self, slot: int, name: str, n: int, allocate: bool):
        buf = self.out[slot].get(name)
        if buf is None or buf.shape[0] < n:
            if not allocate:
                raise RuntimeError(f"the {name} buffer of batch {slot} is too small in the window")
            size = -(-max(n, 1) // CAPACITY_GRAIN) * CAPACITY_GRAIN
            buf = self.torch.empty(size, dtype=self.torch.int64, pin_memory=self.cuda)
            self.out[slot][name] = buf
        return buf

    def request(self, slot: int, allocate: bool = False):
        """One request; returns the total read back (None for a count)."""
        torch, search, dev, sp = self.torch, self.search, self.dev, self.spans
        b = self.batches[slot]
        with sp.layer("ranges"):
            if self.control == "seed_count":
                s, e, _ = search.initial_ranges(dev, b.mat.long(), b.lengths.long(), b.seeded.bool())
            elif b.ngram:
                s, e = search.ngram_ranges(dev, self.ng, b.mat, b.length)
            else:
                s, e = search.search_ranges(dev, b.mat, b.lengths, b.seeded)
        with sp.layer("counts"):
            counts = search.range_counts(s, e, dev.wide)
        total = None
        if self.op == "locate":
            with sp.layer("total"):
                total = int(counts.sum())
            with sp.layer("hits"):
                if self.control == "first_hit":
                    hits, n_out = search.locate_first_hit(dev, s, e), b.queries
                else:
                    cap = -(-total // CAPACITY_GRAIN) * CAPACITY_GRAIN
                    hits, _, _ = search.locate_flat_device(dev, s, e, capacity=cap)
                    n_out = total
        with sp.layer("readback"):
            out = self._buffer(slot, "counts", b.queries, allocate)
            out[:b.queries].copy_(counts, non_blocking=True)
            if total is not None:
                hb = self._buffer(slot, "hits", n_out, allocate)
                hb[:n_out].copy_(hits[:n_out], non_blocking=True)
                self.out[slot]["n_hits"] = n_out
            if self.cuda:
                torch.cuda.synchronize(self.device)
        return total

    def clear(self) -> None:
        for o in self.out:
            for name in ("counts", "hits"):
                if name in o:
                    o[name].fill_(-1)
            o["n_hits"] = 0


def _check(client, pool, text, alphabet: str, device, totals):
    """The numbers compared with the reference, each with its limit (the
    window serves every batch of the pool at least once)."""
    import torch

    from ..reference import MAX_PREFIX, WindowTable, compare_answers

    t0 = time.perf_counter()
    prefix = min(min(int(lengths.min()) for _, lengths in pool), MAX_PREFIX[alphabet])
    table = WindowTable(torch.from_numpy(text.ascii).to(device), alphabet, prefix)
    count_wrong = hits_wrong = 0
    ref_totals = []
    locate = client.op == "locate"
    for slot, (queries, lengths) in enumerate(pool):
        ref_counts, ref_hits = table.answer(torch.from_numpy(queries), torch.from_numpy(lengths))
        ref_totals.append(int(ref_counts.sum()))
        out = client.out[slot]
        counts = out["counts"][:len(lengths)].to(device)
        count_wrong += int((counts != ref_counts).sum())
        if locate:
            hits = out["hits"][:out["n_hits"]].to(device)
            hit_counts = counts.clamp(min=0)
            if client.control == "first_hit":
                hits, hit_counts = hits[counts > 0], hit_counts.clamp(max=1)
            if int(hit_counts.sum()) != hits.shape[0]:
                hits_wrong += len(lengths)  # the hits do not add up to the counts
            else:
                hits_wrong += compare_answers(ref_counts, ref_hits, counts, hits, hit_counts)[1]
    _log(f"reference answered {len(pool)} batches in {time.perf_counter() - t0:.3f}s "
         f"(prefix {prefix}); totals {ref_totals}")
    checks = [("count_wrong", count_wrong, 0)]
    if locate:
        checks.append(("hits_wrong", hits_wrong, 0))
        checks.append(("totals_wrong", sum(t != ref_totals[s] for s, t in totals), 0))
    return checks


def run_cell(m: dict, cell_name: str, seed: int, seconds: float, trace_on: bool, *, device,
             t0: float, prof=None, control=None, root=None, bench=None, cache_root=None):
    """(result without ``correct`` decided by the caller's checks, checks)."""
    import torch

    root = root or manifest.ROOT
    bench = bench or manifest.BENCH_DIR
    cache_root = cache_root or os.path.join(bench, ".cache")
    cell = manifest.cell(m, cell_name)
    config = manifest.config(m, cell["config"], root)
    spec = manifest.traffic(cell["traffic"], bench)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)
    _log(f"process start to a ready device: {time.perf_counter() - t0:.3f}s")

    t = time.perf_counter()
    text = textgen.generate(config["text"])
    _log(f"text: {len(text.ascii)} letters in {time.perf_counter() - t:.3f}s")
    index, dev, ng = index_cache.prepare(config, text, device, cache_root)
    t = time.perf_counter()
    text_dev = torch.from_numpy(text.ascii).to(device)
    pool = traffic.make_pool(spec, text_dev, text.ends, seed)
    del text_dev
    spans = trace.Spans(trace_on)
    client = Client(dev, ng, pool, spec["op"], device, spans, control)
    # the reference's copy of the queries waits on the host
    pool = [(b.ascii.cpu().numpy(), b.lengths.cpu().numpy()) for b in pool]
    _log(f"pool: {len(pool)} batches of {spec['batch']} in {time.perf_counter() - t:.3f}s; "
         f"ranges by {'K4 n-gram steps' if client.batches[0].ngram else 'K2 steps'}")
    t = time.perf_counter()
    for _ in range(2):
        for slot in range(len(pool)):
            client.request(slot, allocate=True)
    spans.calls.clear()
    client.clear()
    _log(f"warm-up: {2 * len(pool)} requests in {time.perf_counter() - t:.3f}s")
    setup_s = time.perf_counter() - t0

    # the peak is the window's: the resident index, the pool and what the
    # requests allocate, not the set-up's passing generation of the pool
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    lat, served = [], []
    queries = 0
    # a traced window need not be long: its per-layer shares settle within
    # a few hundred requests, and a long trace is slow to export and read
    if trace_on:
        seconds = min(seconds, TRACE_WINDOW_S)
    gc.collect()
    gc.disable()  # no collector pause inside the window; requests free by refcount
    window = torch.profiler.record_function("bench.window") if trace_on else None
    if window:
        window.__enter__()
    t_start = time.perf_counter()
    i = 0
    while True:
        slot = i % len(pool)
        r0 = time.perf_counter()
        with spans.layer("request"):
            total = client.request(slot)
        r1 = time.perf_counter()
        lat.append(r1 - r0)
        queries += client.batches[slot].queries
        served.append((slot, total))
        i += 1
        if r1 - t_start >= seconds and i >= len(pool):
            break
    t_end = time.perf_counter()
    gc.enable()
    if window:
        window.__exit__(None, None, None)
    window_s = t_end - t_start
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    summary = trace.stop_and_read(prof) if prof is not None else None
    totals = [(slot, total) for slot, total in served if total is not None]
    _log(f"window: {i} requests, {queries} queries in {window_s:.4f}s; "
         f"hits/request {totals[-1][1] if totals else 0}; peak {peak} B")

    values = {"setup_s": setup_s, "request_p95_ms": float(np.percentile(lat, 95)) * 1e3,
              ("locate_qps" if spec["op"] == "locate" else "count_qps"): queries / window_s}
    metrics = {}
    if not trace_on:
        for e in manifest.metrics_of(m, cell_name, "end_to_end"):
            metrics[e["name"]] = {"value": values[e["name"]], "unit": e["unit"]}
    else:
        layers = _layers(summary, spans, served, client.batches, config, dev, control)
        ctx = types.SimpleNamespace(layers=layers, trace=summary, cell=cell, config=config,
                                    traffic=spec)
        for p in manifest.metrics_of(m, cell_name, "per_layer"):
            v = manifest.load_reader(p["name"], bench)(ctx)
            if v is not None:
                metrics[p["name"]] = {"value": v, "unit": p["unit"]}
        _log(f"layers: {json.dumps(layers)}")
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": None, "attempted": i, "failed": 0, "metrics": metrics,
              "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
        _log(f"trace: {summary['device_events']} device events in the window, "
             f"{summary['unattributed']} with no launch found; device s a layer "
             f"{json.dumps(summary['layers_s'])}; per request: host {1e3 * window_s / i:.4f} ms, "
             f"device busy {1e3 * summary['busy_s'] / i:.4f} ms")

    del client.batches, dev, ng, index
    client.dev = client.ng = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = _check(client, pool, text, config["alphabet"], device, totals)
    return result, checks


def _layers(summary, spans, served, batches, config, dev, control) -> dict:
    """Each traced layer's device and least milliseconds over the
    window's requests, and what bounds its least time."""
    least = {"ranges": [0.0, {}], "hits": [0.0, {}]}
    alphabet = config["alphabet"]
    for slot, total in served:
        b = batches[slot]
        parts = []
        if control != "seed_count":
            parts.append(("ranges", yardstick.ranges_least_ms(
                alphabet=alphabet, bwt_length=dev.bwt_length,
                seed_k=dev.kmer_length_in_seed_table, queries=b.queries, seeded=b.seeded_count,
                steps=b.steps, input_bytes=b.input_bytes)))
        if total is not None and control != "first_hit":
            parts.append(("hits", yardstick.hits_least_ms(
                alphabet=alphabet, bwt_length=dev.bwt_length, sa_ratio=dev.ratio,
                queries=b.queries, hits=total)))
        for name, (ms, by) in parts:
            least[name][0] += ms
            least[name][1][by] = least[name][1].get(by, 0) + 1
    device_s = (summary or {}).get("layers_s", {})
    return {name: {"device_ms": 1e3 * device_s.get(name, 0.0), "least_ms": lms, "bound_by": by}
            for name, (lms, by) in least.items() if spans.calls.get(name)}


def finish(result: dict, checks: list) -> int:
    """Decide ``correct``, refuse a process that loaded JAX, print the
    numbers compared and the result line; the exit code."""
    banned = loaded_banned()
    if banned:
        print(f"[bench] refused: modules loaded in this process: {', '.join(banned)}",
              file=sys.stderr, flush=True)
        return 3
    result["correct"] = all(v <= lim for _, v, lim in checks)
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    for n, v, lim in checks:
        print(f"check {n} {v} limit {lim}", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


def main(argv, t0: float) -> int:
    args = parse_args(argv)
    m = manifest.load()
    cell = manifest.cell(m, args.workload)
    import torch

    _log(f"torch {torch.__version__} imported at {time.perf_counter() - t0:.3f}s")
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"[bench] refused: cell {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}",
              file=sys.stderr, flush=True)
        return 2
    prof = trace.start_profiler() if args.trace else None
    result, checks = run_cell(m, args.workload, args.seed, args.seconds, bool(args.trace),
                              device=torch.device("cuda:0"), t0=t0, prof=prof,
                              control=args.control)
    return finish(result, checks)

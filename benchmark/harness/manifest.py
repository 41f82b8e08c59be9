"""``BENCHMARK.json``: loading, the contract's rules, and finding the
files of a cell by name.

A cell (``workloads`` entry) names a configuration, whose file the
``configs`` entry gives, and a traffic mix, found at
``<bench>/traffic/<traffic>.json``. A per-layer metric is read by
``<bench>/metrics/<name>.py``, or, where no such file exists, by the
reader of its stem (the name up to its first dot): ``ranges_roofline``
reads ``ranges_roofline.locate`` and ``ranges_roofline.count``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
CONFIG_KEYS = {"name", "source", "file", "reduced", "why"}
CELL_KEYS = {"name", "config", "traffic", "chips", "why"}
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def load(path: str = None) -> dict:
    path = path or os.path.join(ROOT, "BENCHMARK.json")
    with open(path) as fh:
        return json.load(fh)


def _line(text, what: str, errors: list) -> None:
    if not isinstance(text, str) or not 1 <= len(text) <= 200 or "\n" in text or "\t" in text:
        errors.append(f"{what}: 1 to 200 characters on one line, no tab")


def _keys(entry: dict, need: set, optional: set, what: str, errors: list) -> None:
    keys = set(entry)
    if not need <= keys or keys - need - optional:
        errors.append(f"{what}: keys must be {sorted(need)} (+ {sorted(optional)})")


def reports(m: dict, cell: str, e2e_name: str) -> bool:
    """Whether ``cell`` reports the end-to-end metric ``e2e_name``."""
    for e in m["end_to_end"]:
        if e["name"] == e2e_name:
            return cell in e.get("workloads", [c["name"] for c in m["workloads"]])
    return False


def validate(m: dict, root: str = None, raw_size: int = 0) -> list:
    """The contract's rules that can be checked from the manifest and the
    files it names; returns the faults found (empty: none)."""
    root = root or ROOT
    bench = os.path.join(root, "benchmark")
    errors = []
    if set(m) != TOP_KEYS:
        return [f"top-level keys must be exactly {sorted(TOP_KEYS)}"]
    if raw_size > 64 * 1024:
        errors.append("BENCHMARK.json is over 64 KiB")
    if not (isinstance(m["command"], list) and 1 <= len(m["command"]) <= 32):
        errors.append("command: a list of 1 to 32 strings")
    for w in m["command"]:
        _line(w, "command word", errors)
    if not 1 <= len(m["paths"]) <= 16:
        errors.append("paths: 1 to 16 directories")
    for p in m["paths"]:
        if not PATH.match(p) or p.startswith("/") or ".." in p.split("/"):
            errors.append(f"path {p!r}")
    rs = m["run_seconds"]
    if not (isinstance(rs, int) and 1 <= rs <= 51):
        errors.append("run_seconds: a whole number from 1 to 51")
    names = {}
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in m[section]:
            n = e.get("name", "")
            if not NAME.match(n):
                errors.append(f"{section}: bad name {n!r}")
            if n in names:
                errors.append(f"name {n!r} used twice")
            names[n] = section
    configs = {c["name"]: c for c in m["configs"]}
    if not 1 <= len(m["configs"]) <= 24:
        errors.append("configs: 1 to 24")
    for c in m["configs"]:
        _keys(c, CONFIG_KEYS, set(), f"config {c['name']}", errors)
        _line(c.get("source"), f"config {c['name']} source", errors)
        _line(c.get("why"), f"config {c['name']} why", errors)
        if len(c.get("reduced", [])) > 16 or not all(NAME.match(k) for k in c.get("reduced", [])):
            errors.append(f"config {c['name']}: reduced keys")
        f = c.get("file", "")
        if not any(f.startswith(p.rstrip("/") + "/") for p in m["paths"]):
            errors.append(f"config {c['name']}: file not under paths")
        elif not os.path.exists(os.path.join(root, f)):
            errors.append(f"config {c['name']}: {f} missing")
    if len({c.get("file") for c in m["configs"]}) != len(m["configs"]):
        errors.append("two configurations share a file")
    cells = m["workloads"]
    if not 1 <= len(cells) <= 24:
        errors.append("workloads: 1 to 24")
    pairs = set()
    for w in cells:
        _keys(w, CELL_KEYS, set(), f"cell {w['name']}", errors)
        _line(w.get("why"), f"cell {w['name']} why", errors)
        if w.get("config") not in configs:
            errors.append(f"cell {w['name']}: unknown config")
        if not NAME.match(str(w.get("traffic", ""))):
            errors.append(f"cell {w['name']}: bad traffic name")
        elif not os.path.exists(os.path.join(bench, "traffic", w["traffic"] + ".json")):
            errors.append(f"cell {w['name']}: traffic file missing")
        else:
            from . import traffic as traffic_gen

            try:
                traffic_gen.check(traffic(w["traffic"], bench))
            except ValueError as err:
                errors.append(f"cell {w['name']}: {err}")
        if w.get("chips") not in (1, 4):
            errors.append(f"cell {w['name']}: chips must be 1 or 4")
        pair = (w.get("config"), w.get("traffic"))
        if pair in pairs:
            errors.append(f"cell {w['name']}: configuration and traffic used twice")
        pairs.add(pair)
    used = {w.get("config") for w in cells}
    for c in configs:
        if c not in used:
            errors.append(f"config {c} used by no cell")
    four = sum(w.get("chips") == 4 for w in cells)
    if four > max(1, len(cells) // 4):
        errors.append("too many four-chip cells")
    cell_names = {w["name"] for w in cells}
    e2e = {e["name"]: e for e in m["end_to_end"]}
    if not 1 <= len(e2e) <= 16:
        errors.append("end_to_end: 1 to 16")
    if "setup_s" not in e2e:
        errors.append("end_to_end must have setup_s")
    for e in m["end_to_end"]:
        _keys(e, E2E_KEYS, {"workloads"}, f"metric {e['name']}", errors)
        if not UNIT.match(str(e.get("unit", ""))):
            errors.append(f"metric {e['name']}: bad unit")
        if e.get("better") not in ("lower", "higher"):
            errors.append(f"metric {e['name']}: better")
        if e.get("source") not in ("host_clock", "device_trace"):
            errors.append(f"metric {e['name']}: source")
        b = e.get("bound")
        if not isinstance(b, (int, float)) or not 0.01 <= b <= 0.25:
            errors.append(f"metric {e['name']}: bound in [0.01, 0.25]")
        if not set(e.get("workloads", [])) <= cell_names:
            errors.append(f"metric {e['name']}: unknown cell")
    if not 1 <= len(m["per_layer"]) <= 128:
        errors.append("per_layer: 1 to 128")
    for p in m["per_layer"]:
        _keys(p, LAYER_KEYS, {"workloads"}, f"metric {p['name']}", errors)
        if not UNIT.match(str(p.get("unit", ""))):
            errors.append(f"metric {p['name']}: bad unit")
        if p.get("better") not in ("lower", "higher"):
            errors.append(f"metric {p['name']}: better")
        if p.get("source") not in ("device_trace", "program_span", "program_counter", "host_clock"):
            errors.append(f"metric {p['name']}: source")
        _line(p.get("layer"), f"metric {p['name']} layer", errors)
        if p.get("moves") not in e2e:
            errors.append(f"metric {p['name']}: moves no end-to-end metric")
        for c in p.get("workloads", sorted(cell_names)):
            if c not in cell_names:
                errors.append(f"metric {p['name']}: unknown cell {c}")
            elif not reports(m, c, p.get("moves")):
                errors.append(f"metric {p['name']}: cell {c} does not report {p.get('moves')}")
        if reader_path(p["name"], bench) is None:
            errors.append(f"metric {p['name']}: no reader")
    for w in cell_names:
        own = [e for e in e2e if reports(m, w, e)]
        if "setup_s" not in own or len(own) < 2:
            errors.append(f"cell {w}: needs setup_s and another end-to-end metric")
        if not any(w in p.get("workloads", cell_names) for p in m["per_layer"]):
            errors.append(f"cell {w}: needs a per-layer metric")
    return errors


def cell(m: dict, name: str) -> dict:
    for w in m["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def config(m: dict, name: str, root: str = None) -> dict:
    for c in m["configs"]:
        if c["name"] == name:
            with open(os.path.join(root or ROOT, c["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r}")


def traffic(name: str, bench: str = None) -> dict:
    with open(os.path.join(bench or BENCH_DIR, "traffic", name + ".json")) as fh:
        return json.load(fh)


def metrics_of(m: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` metrics a cell reports."""
    cells = [w["name"] for w in m["workloads"]]
    return [e for e in m[kind] if cell_name in e.get("workloads", cells)]


def reader_path(name: str, bench: str = None):
    d = os.path.join(bench or BENCH_DIR, "metrics")
    for stem in (name, name.split(".")[0]):
        p = os.path.join(d, stem + ".py")
        if os.path.exists(p):
            return p
    return None


def load_reader(name: str, bench: str = None):
    """The ``read(ctx)`` function of a per-layer metric's reader."""
    path = reader_path(name, bench)
    if path is None:
        raise FileNotFoundError(f"no reader for metric {name!r}")
    mod_name = "_bench_metric_" + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read

"""What the harness and the reference load, each in a fresh process.

Top-level module names are compared whole: the port's name begins with
the JAX package's."""

import json
import os
import subprocess
import sys

from benchmark.tests.helpers import ROOT

JAX_SIDE = {"jax", "jaxlib", "flax", "avxwindowfmindex_tpu"}

HARNESS = """
import glob, json, os, sys, time, importlib
import torch
from benchmark.harness import main, manifest
import benchmark.tests.helpers as cf
for name in ("index_cache", "manifest", "textgen", "trace", "traffic", "yardstick"):
    importlib.import_module("benchmark.harness." + name)
for path in glob.glob(os.path.join(cf.BENCH, "metrics", "*.py")):
    manifest.load_reader(os.path.basename(path)[:-3])
root = sys.argv[1]
m = cf.tiny_manifest(root)
res, checks = cf.run_tiny((m, root), "nt-tiny.l10")
assert res["correct"], checks
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""

REFERENCE = """
import json, sys
import numpy as np, torch
from benchmark.reference import WindowTable, compare_answers
t = WindowTable(torch.from_numpy(np.frombuffer(b"ACGTACGTTT", dtype=np.uint8).copy()), "dna", 3)
c, h = t.answer(torch.from_numpy(np.frombuffer(b"ACGT", dtype=np.uint8).copy())[None], torch.tensor([4]))
assert c.tolist() == [2] and h.tolist() == [0, 4]
print(json.dumps(sorted({n.split(".")[0] for n in sys.modules})))
"""


def _loaded(code: str, *args) -> set:
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code, *args], cwd=ROOT, capture_output=True,
                       text=True, timeout=600, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return set(json.loads(r.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax_after_a_run(tmp_path):
    loaded = _loaded(HARNESS, str(tmp_path))
    assert "avxwindowfmindex_tpu_torch" in loaded  # the run did load the port
    assert not loaded & JAX_SIDE, loaded & JAX_SIDE


def test_the_reference_loads_nothing_of_the_program():
    loaded = _loaded(REFERENCE)
    assert not loaded & (JAX_SIDE | {"avxwindowfmindex_tpu_torch"})

"""Port parity: the multi-process front of parallel/dist.py.

Both workers of tests/test_multihost.py run on the port: two processes
form a gloo world over a ``file://`` rendezvous under ``tmp_path`` (no
TCP port to race for under xdist), each builds the same index (seed 5,
2,000 bases, ratio 4, k = 3), feeds its contiguous slice of the 64
12-mers at stride 7, and merges by all-gather. The workers import torch
and the port only and write their merged arrays as ``.npy`` files; this
process holds every rank's arrays to the JAX package's
``SearchEngine.count`` / ``resolve_positions`` on the same index, with
tolerance 0. Added: one-process worlds (the backend follows the device,
NCCL where there is none raises, a world of 1 gathers to the identity),
and a rank that fails or hangs.
"""

import os
import sys

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch.parallel import dist as pdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 2

multihost = pytest.mark.skipif(
    os.environ.get("AWFM_SKIP_MULTIHOST") == "1",
    reason="multi-process test disabled",
)

_COMMON = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch.parallel import dist

out, init, rank = sys.argv[1], sys.argv[2], int(sys.argv[3])
world = %WORLD%
assert dist.init_process_group(world, rank, init, "cpu") == "gloo"
rng = np.random.default_rng(5)
seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2000).tobytes())
index = pt.create_index(seq, pt.IndexConfiguration(4, 3, pt.AlphabetType.DNA), device="cpu")
kmers = [seq[i * 7 : i * 7 + 12] for i in range(64)]


def part(items):
    return items[rank * len(items) // world : (rank + 1) * len(items) // world]


def save(name, arr):
    np.save(f"{out}/{name}{rank}.npy", arr)
"""

_END = r"""
torch.distributed.destroy_process_group()
assert not any(m == "jax" or m.startswith(("jax.", "avxwindowfmindex_tpu."))
               or m == "avxwindowfmindex_tpu" for m in sys.modules), "the JAX package was imported"
print(f"rank {rank} OK")
"""

# count by all-gather; 61 kmers split 30 / 31 take the padded merge
_WORKER = _COMMON + r"""
eng = dist.DistributedSearchEngine(index, ["cpu"] * 4)
save("count", eng.count_allgather(part(kmers)))
save("count_odd", eng.count_allgather(part(kmers[:61])))
""" + _END

# narrow resolve, then the forced-wide view's count and resolve, in the
# same processes; the positions are the JAX engine's ranges' starts
_WORKER_LOCATE = _COMMON + r"""
pos = np.load(f"{out}/pos.npy")
eng = dist.DistributedSearchEngine(index, ["cpu"] * 4)
save("hits", eng.resolve_allgather(part(pos)))
weng = dist.DistributedSearchEngine(index.to_device("cpu", wide=True), ["cpu"] * 4)
assert weng.wide
save("wide_count", weng.count_allgather(part(kmers)))
save("wide_hits", weng.resolve_allgather(part(pos)))
""" + _END


@pytest.fixture(scope="module")
def reference():
    """The JAX index of the workers' text, its engine and the kmers."""
    rng = np.random.default_rng(5)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2000).tobytes())
    index = jx.create_index(seq, jx.IndexConfiguration(4, 3, jx.AlphabetType.DNA))
    kmers = [seq[i * 7 : i * 7 + 12] for i in range(64)]
    return jx.SearchEngine(index), kmers


def _run_world(tmp_path, worker_src):
    script = tmp_path / "worker.py"
    script.write_text(worker_src.replace("%WORLD%", str(WORLD)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    outs = pdist.spawn_ranks(
        [sys.executable, str(script), str(tmp_path), f"file://{tmp_path}/rendezvous"],
        WORLD, timeout=240, env=env)
    for r, out in enumerate(outs):
        assert f"rank {r} OK" in out, out


def _every_rank(tmp_path, name):
    return [np.load(tmp_path / f"{name}{r}.npy") for r in range(WORLD)]


@multihost
def test_two_process_allgather_count(tmp_path, reference):
    engine, kmers = reference
    _run_world(tmp_path, _WORKER)
    for got in _every_rank(tmp_path, "count"):
        assert got.dtype == np.uint64
        np.testing.assert_array_equal(got, engine.count(kmers))
    for got in _every_rank(tmp_path, "count_odd"):
        np.testing.assert_array_equal(got, engine.count(kmers[:61]))


@multihost
def test_two_process_locate_and_wide(tmp_path, reference):
    engine, kmers = reference
    ranges = engine.find_ranges(kmers)
    s, e = ranges[:, 0], ranges[:, 1]
    pos = np.where(s <= e, s, 0).astype(np.uint64)
    np.save(tmp_path / "pos.npy", pos)
    _run_world(tmp_path, _WORKER_LOCATE)
    want_hits = engine.resolve_positions(pos)
    for name, want in (("hits", want_hits), ("wide_count", engine.count(kmers)),
                       ("wide_hits", want_hits)):
        for got in _every_rank(tmp_path, name):
            assert got.dtype == np.uint64
            np.testing.assert_array_equal(got, want, err_msg=name)


# ---------------------------------------------------------------------------
# one-process worlds
# ---------------------------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    backend = pdist.init_process_group(1, 0, f"file://{tmp_path}/rendezvous", "cpu")
    try:
        yield backend
    finally:
        torch.distributed.destroy_process_group()


def test_backend_follows_the_cpu(world_of_one):
    assert world_of_one == "gloo" == torch.distributed.get_backend()


def test_process_allgather_world_of_one_is_the_identity(world_of_one):
    for t in (torch.arange(7, dtype=torch.int64) * 3, torch.tensor([2**40 + 5, 0, -1])):
        got = pdist.process_allgather(t)
        assert got.dtype == t.dtype and torch.equal(got, t)


def test_world_of_one_merges_to_the_engine(world_of_one, reference):
    engine, kmers = reference
    rng = np.random.default_rng(5)
    seq = bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8), size=2000).tobytes())
    eng = pdist.DistributedSearchEngine(
        pt.create_index(seq, pt.IndexConfiguration(4, 3, pt.AlphabetType.DNA), device="cpu"),
        ["cpu"] * 3)
    np.testing.assert_array_equal(eng.count_allgather(kmers), engine.count(kmers))
    pos = np.arange(0, 2001, 37, dtype=np.uint64)
    np.testing.assert_array_equal(eng.resolve_allgather(pos), engine.resolve_positions(pos))


def test_nccl_never_falls_back(tmp_path):
    if torch.distributed.is_nccl_available():
        pytest.skip("this build has NCCL; the refusal is for builds without it")
    with pytest.raises(RuntimeError, match="is_nccl_available"):
        pdist.init_process_group(1, 0, f"file://{tmp_path}/rendezvous", "cpu", backend="nccl")
    with pytest.raises(ValueError, match="backend must be"):
        pdist.init_process_group(1, 0, f"file://{tmp_path}/rendezvous", "cpu", backend="mpi")
    assert not torch.distributed.is_initialized()


def test_a_failed_or_hung_rank_raises(tmp_path):
    fail = [sys.executable, "-c", "import sys; sys.exit(3 if sys.argv[1] == '1' else 0)"]
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited 3"):
        pdist.spawn_ranks(fail, 2, timeout=60)
    hang = [sys.executable, "-c", "import sys, time; time.sleep(60 * int(sys.argv[1]))"]
    with pytest.raises(RuntimeError, match="rank 1 of 2 outlasted"):
        pdist.spawn_ranks(hang, 2, timeout=2)

"""Port parity: shard retry and index reload (parallel/reliability.py).

Every case of tests/test_reliability.py runs through both packages — JAX
on the CPU, the port on ``device="cpu"`` — and the answers and the retry
statistics are compared. Added: the split the port's kernel launchers
give, a CUDA error (``RuntimeError``) retried, a tensor on the wrong
device or of the wrong dtype (``ValueError`` / ``TypeError``) failing
fast.
"""

import functools
import types

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.parallel import reliability as jrel
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.parallel import reliability as prel

from oracle import random_kmer, random_sequence
from torch_helpers import assert_locates_equal, configs

DNA = jx.AlphabetType.DNA


def _flaky(base):
    """A subclass of ``base`` that fails while ``failures_remaining`` > 0."""

    class Flaky(base):
        failures_remaining = 0

        def _maybe_fail(self):
            if type(self).failures_remaining > 0:
                type(self).failures_remaining -= 1
                raise RuntimeError("injected fault")

        def count(self, kmers):
            self._maybe_fail()
            return super().count(kmers)

        def locate(self, kmers):
            self._maybe_fail()
            return super().locate(kmers)

    return Flaky


class Pair:
    """The same scenario in both packages: an index built from one
    sequence and written to its own .awfmi, a flaky engine class each."""

    def __init__(self, seq, tmp_path):
        jcfg, pcfg = configs(4, 3, DNA)
        self.j = jx.create_index(seq, jcfg, file_src=str(tmp_path / "j.awfmi"))
        self.p = pt.create_index(seq, pcfg, file_src=str(tmp_path / "p.awfmi"), device="cpu")
        self.jflaky = _flaky(jx.SearchEngine)
        self.pflaky = _flaky(pt.SearchEngine)

    def fail(self, n):
        self.jflaky.failures_remaining = n
        self.pflaky.failures_remaining = n

    def engines(self, shard_size=100, factory=None, **policy):
        """(JAX ReliableSearchEngine, port ReliableSearchEngine) over the
        flaky engines (or the given factory class of each package)."""
        jf, pf = factory or (self.jflaky, self.pflaky)
        return (
            jrel.ReliableSearchEngine(self.j, shard_size=shard_size,
                                      policy=jrel.RetryPolicy(**policy), engine_factory=jf),
            prel.ReliableSearchEngine(self.p, shard_size=shard_size,
                                      policy=prel.RetryPolicy(**policy),
                                      engine_factory=functools.partial(pf, device="cpu")),
        )


@pytest.fixture
def pair(rng, tmp_path):
    return Pair(random_sequence(rng, 1200, DNA), tmp_path)


def test_retry_recovers_and_matches(pair, rng):
    kmers = [random_kmer(rng, 5, DNA) for _ in range(300)]
    want = jx.SearchEngine(pair.j).count(kmers)
    pair.fail(2)
    jeng, peng = pair.engines(max_attempts=3, backoff_seconds=0.0)
    np.testing.assert_array_equal(jeng.count(kmers), want)
    pair.fail(2)
    np.testing.assert_array_equal(peng.count(kmers), want)
    assert peng.stats == jeng.stats == {"shards": 3, "retries": 2, "reloads": 2}
    assert peng.index is not pair.p and peng.index.file_path == pair.p.file_path  # reloaded


def test_retry_exhaustion_raises(pair):
    for eng in pair.engines(max_attempts=2, backoff_seconds=0.0, reload_index_on_failure=False):
        pair.fail(99)
        with pytest.raises(RuntimeError, match="injected fault"):
            eng.count([b"ACGT"] * 10)


def test_locate_through_retry(pair, rng):
    kmers = [random_kmer(rng, 4, DNA) for _ in range(50)]
    want = jx.SearchEngine(pair.j).locate(kmers)
    jeng, peng = pair.engines(shard_size=25, max_attempts=2, backoff_seconds=0.0)
    pair.fail(1)
    assert_locates_equal(jeng.locate(kmers), want)
    pair.fail(1)
    assert_locates_equal(peng.locate(kmers), want)
    assert peng.stats == jeng.stats


def test_empty_kmer_list(pair):
    jeng = jrel.ReliableSearchEngine(pair.j)
    peng = prel.ReliableSearchEngine(pair.p, device="cpu")
    assert len(peng.count([])) == len(jeng.count([])) == 0
    assert peng.count([]).dtype == np.uint64
    assert peng.locate([]) == jeng.locate([]) == []
    assert type(peng.engine) is pt.SearchEngine and peng.engine.device == torch.device("cpu")


def test_reload_failure_does_not_abort_retries(pair, rng, monkeypatch):
    """A transient reload error must not consume the retry budget or
    mask the shard error."""
    kmers = [random_kmer(rng, 5, DNA) for _ in range(50)]
    want = jx.SearchEngine(pair.j).count(kmers)
    for eng in pair.engines(max_attempts=3, backoff_seconds=0.0):
        attempts = []

        def broken_reload():
            attempts.append(1)
            raise OSError("injected reload fault")

        monkeypatch.setattr(eng, "_reload_index", broken_reload)
        pair.fail(1)
        np.testing.assert_array_equal(eng.count(kmers), want)
        assert attempts == [1]


def test_no_recovery_work_after_final_attempt(pair):
    """The last failed attempt raises at once: no reload or backoff for
    a result that is discarded."""
    for eng in pair.engines(max_attempts=2, backoff_seconds=0.0):
        pair.fail(99)
        with pytest.raises(RuntimeError, match="injected fault"):
            eng.count([b"ACGT"])
        assert eng.stats["reloads"] == 1  # between attempts only


def test_retry_policy_validates_attempts():
    for mod in (prel, jrel):
        with pytest.raises(ValueError, match="max_attempts"):
            mod.RetryPolicy(max_attempts=0)


def _bad_input(base):
    class BadInput(base):
        calls = 0

        def count(self, kmers):
            type(self).calls += 1
            raise ValueError("bad kmer")

    return BadInput


def test_deterministic_error_fails_fast(pair):
    """A ValueError (bad input) consumes no retry, reloads nothing and
    does not back off: it is raised on the first attempt."""
    factory = (_bad_input(jx.SearchEngine), _bad_input(pt.SearchEngine))
    for eng, cls in zip(pair.engines(factory=factory, max_attempts=5, backoff_seconds=10.0),
                        factory):
        with pytest.raises(ValueError, match="bad kmer"):
            eng.count([b"ACGT"])
        assert cls.calls == 1
        assert eng.stats == {"shards": 1, "retries": 0, "reloads": 0}


def test_custom_retryable_predicate(pair):
    """The policy's retryable callback decides, so users can opt specific
    errors in or out."""
    factory = (_bad_input(jx.SearchEngine), _bad_input(pt.SearchEngine))
    for eng, cls in zip(pair.engines(factory=factory, max_attempts=3, backoff_seconds=0.0,
                                     reload_index_on_failure=False, retryable=lambda e: True),
                        factory):
        with pytest.raises(ValueError, match="bad kmer"):
            eng.count([b"ACGT"])
        assert cls.calls == 3
        assert eng.stats["retries"] == 3


# ---------------------------------------------------------------------------
# the errors the port's kernel launchers raise
# ---------------------------------------------------------------------------

def _launcher_errors():
    """The three errors of ops/kernels.py, raised by its own checks where
    they can run without a card: a CPU view handed to a launcher
    (ValueError), a CUDA tensor of the wrong dtype (TypeError), and the
    RuntimeError ``_check`` raises for a nonzero CUDA status."""
    cuda0 = torch.device("cuda", 0)
    wrong_dtype = types.SimpleNamespace(is_cuda=True, device=cuda0, dtype=torch.int32,
                                        is_contiguous=lambda: True)
    out = {}
    try:
        kernels._require(torch.zeros(1, dtype=torch.uint8), "mat", torch.uint8, cuda0)
    except ValueError as err:
        out["wrong device"] = err
    try:
        kernels._require(wrong_dtype, "mat", torch.uint8, cuda0)
    except TypeError as err:
        out["wrong dtype"] = err
    out["cuda error"] = RuntimeError(
        "awfm_k2_ranges: CUDA error 700 (an illegal memory access was encountered)")
    return out


@pytest.mark.parametrize("case,retried", [
    ("cuda error", True), ("wrong device", False), ("wrong dtype", False),
])
def test_launcher_errors_retry_or_fail_fast(pair, rng, case, retried):
    """A CUDA error is an environmental fault: retried (with a reload)
    until the shard succeeds. A tensor on the wrong device or of the wrong
    dtype is a usage error: raised on the first attempt, as is_retryable
    of both packages says."""
    err = _launcher_errors()[case]
    assert prel.is_retryable(err) is jrel.is_retryable(err) is retried

    class Failing(pt.SearchEngine):
        left = 1

        def count(self, kmers):
            if Failing.left:
                Failing.left -= 1
                raise err
            return super().count(kmers)

    kmers = [random_kmer(rng, 6, DNA) for _ in range(40)]
    eng = prel.ReliableSearchEngine(
        pair.p, shard_size=64, policy=prel.RetryPolicy(max_attempts=2, backoff_seconds=0.0),
        engine_factory=functools.partial(Failing, device="cpu"),
    )
    if retried:
        np.testing.assert_array_equal(eng.count(kmers), jx.SearchEngine(pair.j).count(kmers))
        assert eng.stats == {"shards": 1, "retries": 1, "reloads": 1}
        assert type(eng.engine) is Failing and eng.engine.device == torch.device("cpu")
    else:
        with pytest.raises(type(err)):
            eng.count(kmers)
        assert eng.stats == {"shards": 1, "retries": 0, "reloads": 0}


def test_default_engine_targets_the_card(pair):
    """With no factory the engine is SearchEngine on ``device``; with no
    device that is the card, and without one it raises naming device=."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None would use it")
    with pytest.raises(RuntimeError, match="device="):
        prel.ReliableSearchEngine(pair.p)
    assert prel.logger.name == "avxwindowfmindex_tpu_torch.reliability"
    assert prel.NON_RETRYABLE == jrel.NON_RETRYABLE

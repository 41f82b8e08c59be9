"""Port parity: the plain rank primitives against ops/rank.py and P1.

``occurrence``, ``backward_step`` (with and without ``check_valid``),
``backward_step_pair`` and ``letter_and_lf_at`` of the port run on the
CPU (the plain versions K1/K2/K3 are held to on the card) and must equal
the JAX package's functions and the Pallas kernel run in interpret mode,
as tests/test_rank_pallas.py runs it. Exact comparison: tolerance 0.
Includes the u32 wrap of ``start - 1`` at 0 and the clamped gather.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
from avxwindowfmindex_tpu.ops import rank as jrank
from avxwindowfmindex_tpu.ops import rank_pallas
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.ops import rank as prank

from oracle import random_sequence
from torch_helpers import build_both

ALPHABETS = [jx.AlphabetType.DNA, jx.AlphabetType.AMINO]


@pytest.fixture(scope="module", params=ALPHABETS, ids=lambda a: a.name)
def devs(request):
    rng = np.random.default_rng(0xA3F1)
    seq = random_sequence(rng, 1800, request.param)
    j, p = build_both(seq, 4, 2, request.param)
    return j.to_device(), p.to_device("cpu")


def _u32(x):
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


def _edge_positions(n, nb):
    return np.array([0, 7, 8, 255 % n, n - 1, n, nb * 256 - 1, nb * 256, 0xFFFFFFFF])


def test_occurrence_matches_jax_and_pallas(devs):
    jd, pd = devs
    n = jd.bwt_length
    rng = np.random.default_rng(5)
    positions = np.concatenate([rng.integers(0, n, size=300), [0, 7, 8, 255 % n, n - 1]])
    for lett in range(jd.cardinality + 1):
        letters = np.full(positions.shape[0], lett, dtype=np.int32)
        want = np.asarray(jrank.occurrence(jd, jnp.asarray(_u32(positions)), jnp.asarray(letters)))
        pallas = np.asarray(rank_pallas.occurrence(
            jd, jnp.asarray(_u32(positions)), jnp.asarray(letters), interpret=True
        ))
        got = prank.occurrence(pd, torch.from_numpy(positions), torch.from_numpy(letters))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64), err_msg=f"letter {lett}")
        np.testing.assert_array_equal(got.numpy(), pallas.astype(np.int64), err_msg=f"letter {lett}")


def test_occurrence_non_tile_batch(devs):
    jd, pd = devs
    rng = np.random.default_rng(77)
    positions = rng.integers(0, jd.bwt_length, size=77)
    letters = rng.integers(0, jd.cardinality + 1, size=77).astype(np.int32)
    want = np.asarray(rank_pallas.occurrence(
        jd, jnp.asarray(_u32(positions)), jnp.asarray(letters), interpret=True
    ))
    got = prank.occurrence(pd, torch.from_numpy(positions), torch.from_numpy(letters))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_occurrence_wraps_and_clamps_like_xla(devs):
    jd, pd = devs
    positions = _edge_positions(jd.bwt_length, pd.num_blocks)
    # every letter including the sentinel and one past it (one-hot: code 0)
    for lett in range(jd.cardinality + 3):
        letters = np.full(positions.shape[0], lett, dtype=np.int32)
        want = np.asarray(jrank.occurrence(jd, jnp.asarray(_u32(positions)), jnp.asarray(letters)))
        got = prank.occurrence_plain(pd, torch.from_numpy(positions), torch.from_numpy(letters))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64), err_msg=f"letter {lett}")


def _ranges(rng, n, b):
    start = rng.integers(0, n, size=b)
    width = rng.integers(-3, 600, size=b)
    end = np.clip(start + width, 0, n - 1)
    # explicit edges: start 0 (start - 1 wraps), empty ranges, full range
    start = np.concatenate([start, [0, 0, 1, 5, 1]])
    end = np.concatenate([end, [0, 300, 0, 4, n - 1]])
    return start, end


@pytest.mark.parametrize("check_valid", [True, False])
def test_backward_step_matches_jax(devs, check_valid):
    jd, pd = devs
    rng = np.random.default_rng(11)
    start, end = _ranges(rng, jd.bwt_length, 200)
    b = len(start)
    letters = rng.integers(0, jd.cardinality + 2, size=b).astype(np.int32)
    active = rng.integers(0, 2, size=b).astype(bool)
    for act in (None, active):
        ws, we = jrank.backward_step(
            jd, jnp.asarray(_u32(start)), jnp.asarray(_u32(end)), jnp.asarray(letters),
            None if act is None else jnp.asarray(act), check_valid=check_valid,
        )
        gs, ge = prank.backward_step(
            pd, torch.from_numpy(start), torch.from_numpy(end), torch.from_numpy(letters),
            None if act is None else torch.from_numpy(act), check_valid=check_valid,
        )
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we).astype(np.int64))


def test_backward_step_pair_matches_jax(devs):
    jd, pd = devs
    rng = np.random.default_rng(12)
    start, end = _ranges(rng, jd.bwt_length, 300)
    b = len(start)
    letters = rng.integers(0, jd.cardinality + 1, size=b).astype(np.int32)
    active = rng.integers(0, 2, size=b).astype(bool)
    bad = np.zeros(b, dtype=bool)
    ws, we, wbad = jrank.backward_step_pair(
        jd, jnp.asarray(_u32(start)), jnp.asarray(_u32(end)), jnp.asarray(letters),
        jnp.asarray(bad), jnp.asarray(active),
    )
    gs, ge, gbad = prank.backward_step_pair(
        pd, torch.from_numpy(start), torch.from_numpy(end), torch.from_numpy(letters),
        torch.from_numpy(bad), torch.from_numpy(active),
    )
    np.testing.assert_array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))
    np.testing.assert_array_equal(ge.numpy(), np.asarray(we).astype(np.int64))
    np.testing.assert_array_equal(gbad.numpy(), np.asarray(wbad))
    assert gbad.any() and not gbad.all()  # both window outcomes exercised


def test_letter_and_lf_matches_jax(devs):
    jd, pd = devs
    n = jd.bwt_length
    positions = np.concatenate([np.arange(n), _edge_positions(n, pd.num_blocks)])
    wl, wf = jrank.letter_and_lf_at(jd, jnp.asarray(_u32(positions)))
    gl, gf = prank.letter_and_lf_at(pd, torch.from_numpy(positions))
    np.testing.assert_array_equal(gl.numpy(), np.asarray(wl).astype(np.int64))
    np.testing.assert_array_equal(gf.numpy(), np.asarray(wf).astype(np.int64))


def test_wrappers_reject_other_devices(devs):
    _, pd = devs
    meta = torch.empty(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        prank.occurrence(pd, meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        prank.letter_and_lf_at(pd, meta)


def test_kernel_launchers_take_only_cuda_tensors(devs):
    # the launchers never fall back: CPU tensors are refused before any
    # build is attempted, and nothing is counted as launched
    _, pd = devs
    pos = torch.zeros(4, dtype=torch.int64)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k1_occurrence(pd, pos, torch.zeros(4, dtype=torch.int32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k3_backtrace_resolve(pd, pos)
    assert all(k.launches == 0 for k in kernels.KERNELS)

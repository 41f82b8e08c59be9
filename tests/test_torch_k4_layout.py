"""K4's n-gram row layout against the reference pair rows.

K4 reads ``NgramIndex.k4``: the n-gram pair rows with each row's bytes
permuted (``ops/ngram.py:_geometry_k4``, ``k4_rows``) so that a
first-block visit reads adjacent 64 B pieces. The host build, the cache
and ``NgramIndex.packed`` keep the JAX package's bytes. Here: the
permutation is a bijection; undoing it gives the port's and the JAX
package's pair rows byte for byte; a plain torch statement of K4's reads
over the new rows (the planes' first halves at 32 i, the milestones after
them, the second halves at ``hi_offset``) equals the reference first-block
step and the JAX exact step on the class-edge ranges; and the first-block
read depends on no byte outside the sectors ``roofline.k4_word_masks``
names. Exact: tolerance 0. The CUDA kernel is held to the same on the
card (``chip_smoke.py`` phases 3, 4 and 4p).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
from avxwindowfmindex_tpu.ops import ngram as jngram
from avxwindowfmindex_tpu_torch.models.index import MASK32
from avxwindowfmindex_tpu_torch.ops import ngram as pngram
from avxwindowfmindex_tpu_torch.ops.rank import _gather_rows, _inclusive_mask, _popcount_sum
from avxwindowfmindex_tpu_torch.utils import roofline

from oracle import random_sequence
from test_torch_window_classes import _edge_ranges, _random_ranges
from torch_helpers import build_both

DNA = jx.AlphabetType.DNA
CASES = pytest.mark.parametrize(
    "n,biased", [(n, b) for n in (2, 3) for b in (True, False)],
    ids=[f"n{n}-{'biased' if b else 'unbiased'}" for n in (2, 3) for b in (True, False)])


@pytest.fixture(scope="module")
def dna():
    """(JAX FmIndex, port FmIndex) of one 3,000-base DNA text, k = 3."""
    rng = np.random.default_rng(0x4A7)
    return build_both(random_sequence(rng, 3000, DNA), 4, 3, DNA)


@pytest.fixture(scope="module")
def tables(dna):
    j, p = dna
    return {
        (n, b): (jngram.build_ngram_device(j, n, bias_cn=b),
                 pngram.build_ngram_device(p, n, device="cpu", bias_cn=b))
        for n in (2, 3) for b in (True, False)
    }


def _u32(x):
    return np.asarray(x, dtype=np.uint64).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _ranges(rng, n_positions):
    """``test_torch_window_classes``' ranges: widths 1..400 anywhere (every
    class), then its class-edge ranges, start == 0 and an invalid range."""
    s1, e1 = _random_ranges(rng, n_positions)
    s2, e2 = _edge_ranges(n_positions)
    return np.concatenate([s1, s2]), np.concatenate([e1, e2])


# ---------------------------------------------------------------------------
# a plain torch statement of K4's reads over its rows (csrc: NgramRow,
# ngram_match_words, ngram_milestone, ngram_occ_at, ngram_step)
# ---------------------------------------------------------------------------

def _k4_match(rows, n, v, window: bool):
    """(B, 32) match bytes of words 0-7 (the first block), or (B, 64) of
    words 0-15 (the window) for word v."""
    n_planes, _, hi_offset, _ = pngram._geometry_k4(n)
    diff = None
    for i in range(n_planes):
        x = rows[:, 32 * i : 32 * i + 32]
        if window:
            x = torch.cat([x, rows[:, hi_offset + 32 * i : hi_offset + 32 * i + 32]], dim=1)
        if i < n_planes - 1:  # the value planes; the dirty plane is ORed in as it is
            x = x ^ (((v >> i) & 1) * 0xFF).to(torch.uint8)[:, None]
        diff = x if diff is None else diff | x
    return torch.bitwise_not(diff)


def _k4_milestone(rows, n, v):
    _, ms_offset, _, _ = pngram._geometry_k4(n)
    idx = ms_offset + 4 * v[:, None] + torch.arange(4)[None, :]
    return (rows.gather(1, idx).to(torch.int64) << torch.tensor([0, 8, 16, 24])).sum(dim=1)


def _word(letters):
    v = torch.zeros_like(letters[0], dtype=torch.int64)
    for lett in letters:
        v = v * 4 + lett.to(torch.int64)
    return v


def k4_step(ng, rows, start, end, letters, classes=(0, 1, 2)):
    """K4's n-gram step over K4's rows, by window class; a range of a class
    not in ``classes``, or invalid, keeps its value."""
    n = ng.n
    start, end = start & MASK32, end & MASK32
    v = _word(letters)
    cn = 0 if ng.biased else (ng.cn.to(torch.int64) & MASK32)[v]
    pos_s = (start - 1) & MASK32
    delta = (end - (pos_s & ~0xFF)) & MASK32
    row_s, local_s = _gather_rows(rows, pos_s)
    ms_s = _k4_milestone(row_s, n, v)
    first = _k4_match(row_s, n, v, False)
    window = _k4_match(row_s, n, v, True)
    row_e, local_e = _gather_rows(rows, end)
    occ = {
        0: (ms_s + _popcount_sum(first & _inclusive_mask(local_s, 32)),
            ms_s + _popcount_sum(first & _inclusive_mask(delta.clamp(max=255), 32))),
        1: (ms_s + _popcount_sum(window & _inclusive_mask(local_s, 64)),
            ms_s + _popcount_sum(window & _inclusive_mask(delta.clamp(max=511), 64))),
        2: (ms_s + _popcount_sum(first & _inclusive_mask(local_s, 32)),
            _k4_milestone(row_e, n, v)
            + _popcount_sum(_k4_match(row_e, n, v, False) & _inclusive_mask(local_e, 32))),
    }
    cls = torch.where(delta < 256, 0, torch.where(delta < 512, 1, 2))
    new_s, new_e = start.clone(), end.clone()
    for c in classes:
        take = (cls == c) & (start <= end)
        new_s = torch.where(take, (cn + occ[c][0]) & MASK32, new_s)
        new_e = torch.where(take, (cn + occ[c][1] - 1) & MASK32, new_e)
    return new_s, new_e


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------

@CASES
def test_k4_row_order_is_a_bijection(tables, n, biased):
    order = pngram.k4_row_order(n)
    _, png = tables[(n, biased)]
    n_planes, ms_offset, hi_offset, row_bytes = pngram._geometry_k4(n)
    assert len(order) == row_bytes == png.packed.shape[1] == (384 if n == 2 else 768)
    np.testing.assert_array_equal(np.sort(order), np.arange(row_bytes))
    assert (ms_offset, hi_offset) == ((160, 224) if n == 2 else (224, 480))
    # the permutation, written out: plane halves, milestones, plane halves
    _, _, _, pair_ms, _ = pngram._geometry_pair(n)
    for i in range(n_planes):
        assert order[32 * i] == 64 * i and order[hi_offset + 32 * i] == 64 * i + 32
    assert order[ms_offset] == pair_ms and hi_offset + 32 * n_planes <= row_bytes
    k4 = pngram.k4_rows(png.packed, n)
    assert k4.shape == png.packed.shape and k4.dtype == torch.uint8 and k4.is_contiguous()
    # every byte of every row lands once: the rows' byte counts agree
    for r in (0, k4.shape[0] // 2, k4.shape[0] - 1):
        assert sorted(k4[r].tolist()) == sorted(png.packed[r].tolist())


@CASES
def test_undoing_k4_rows_gives_the_reference_rows(dna, tables, n, biased):
    """The inverse permutation of K4's table is the port's host pair rows
    and the JAX package's ``packed``, byte for byte; the host and cache
    layout did not move."""
    _, p = dna
    jng, png = tables[(n, biased)]
    k4 = pngram.k4_rows(png.packed, n)
    back = k4[:, torch.from_numpy(np.argsort(pngram.k4_row_order(n)))]
    host, _ = pngram.build_ngram_pair_rows(p, n, biased)
    assert back.numpy().tobytes() == host.tobytes() == np.asarray(jng.packed).tobytes()
    assert png.packed.numpy().tobytes() == np.asarray(jng.packed).tobytes()
    # on the CPU the index carries no K4 table; a K4 table made from the
    # JAX package's rows is the same bytes
    assert png.k4 is None
    assert torch.equal(pngram.k4_rows(torch.from_numpy(np.array(jng.packed)), n), k4)


@CASES
def test_k4_first_block_read_equals_the_reference_first_block_step(dna, tables, n, biased):
    j, _ = dna
    _, png = tables[(n, biased)]
    k4 = pngram.k4_rows(png.packed, n)
    rng = np.random.default_rng(100 * n + biased)
    start, end = _ranges(rng, j.bwt_length)
    letters = [torch.from_numpy(rng.integers(0, 4, size=len(start))) for _ in range(n)]
    ws, we, first = pngram.ngram_backward_step_first_block(png, _t(start), _t(end), letters)
    gs, ge = k4_step(png, k4, _t(start), _t(end), letters, classes=(0,))
    assert 50 < int(first.sum()) < len(start) - 50
    assert torch.equal(gs, ws) and torch.equal(ge, we)


@CASES
def test_k4_step_on_class_edges_equals_jax_exact_step(dna, tables, n, biased):
    """All three classes over K4's rows against the step the JAX engine
    takes: the one-row step, and the exact two-row step where that one
    flags the range."""
    j, _ = dna
    jng, png = tables[(n, biased)]
    k4 = pngram.k4_rows(png.packed, n)
    rng = np.random.default_rng(n + 7 * biased)
    start, end = _ranges(rng, j.bwt_length)
    for _ in range(3):
        letters = [rng.integers(0, 4, size=len(start)).astype(np.int32) for _ in range(n)]
        js, je, jl = jnp.asarray(_u32(start)), jnp.asarray(_u32(end)), [jnp.asarray(x) for x in letters]
        ws, we, flag = jngram.ngram_backward_step_pair(jng, js, je, jl, jnp.zeros(len(start), bool))
        xs, xe = jngram.ngram_backward_step(jng, js, je, jl)
        ws, we = jnp.where(flag, xs, ws), jnp.where(flag, xe, we)
        gs, ge = k4_step(png, k4, _t(start), _t(end), [torch.from_numpy(x) for x in letters])
        np.testing.assert_array_equal(gs.numpy(), np.asarray(ws).astype(np.int64))
        np.testing.assert_array_equal(ge.numpy(), np.asarray(we).astype(np.int64))
        assert bool(np.asarray(flag).any()) and not bool(np.asarray(flag).all())


@CASES
def test_k4_first_block_read_touches_only_its_pieces(dna, tables, n, biased):
    """A first-block visit of word v depends on the planes' first halves,
    bytes [0, 32 planes), and v's milestone word alone: every other byte
    of K4's table may change and the step gives the same. Those bytes lie
    in the sectors of ``roofline.k4_word_masks``: 3 or 4 64 B pieces at
    n = 2, 4 or 5 at n = 3, where the pair layout's first-block sectors
    lie in 6 and 8."""
    j, _ = dna
    _, png = tables[(n, biased)]
    k4 = pngram.k4_rows(png.packed, n)
    n_planes, ms_offset, _, row_bytes = pngram._geometry_k4(n)
    rng = np.random.default_rng(n + 2 * biased)
    start, end = _ranges(rng, j.bwt_length)
    masks = roofline.k4_word_masks(n)
    for v in range(4**n):
        word = [(v >> (2 * (n - 1 - i))) & 3 for i in range(n)]
        letters = [torch.full((len(start),), x, dtype=torch.int64) for x in word]
        keep = list(range(32 * n_planes)) + list(range(ms_offset + 4 * v, ms_offset + 4 * v + 4))
        other = torch.from_numpy(rng.integers(0, 256, size=tuple(k4.shape), dtype=np.uint8))
        other[:, keep] = k4[:, keep]
        want = k4_step(png, k4, _t(start), _t(end), letters, classes=(0,))
        got = k4_step(png, other, _t(start), _t(end), letters, classes=(0,))
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        mask = roofline.first_block_sector_mask(n_planes, 32, ms_offset + 4 * v)
        assert mask in masks and all(mask >> (b // 32) & 1 for b in keep)
        pieces = {b // 64 for b in keep}
        # the planes' halves fill pieces 0 .. from the row's start; the
        # milestone word adds at most one piece
        assert {b // 64 for b in range(32 * n_planes)} == set(range(-(-32 * n_planes // 64)))
        assert len(pieces) == {2: 3 if v < 8 else 4, 3: 4 if v < 8 else 5}[n]
    assert sum(masks.values()) == pytest.approx(1.0)
    # the whole window does read the second halves
    full = k4_step(png, k4, _t(start), _t(end), letters, classes=(1,))
    scrambled = k4.clone()
    scrambled[:, 32 * n_planes + 4 * 4**n : row_bytes] ^= 0xFF
    assert not torch.equal(k4_step(png, scrambled, _t(start), _t(end), letters, classes=(1,))[1],
                           full[1])


def test_ngram_index_on_the_cpu_has_no_k4_table_and_keeps_it_derived(tables):
    """``k4`` is derived state: made only for an index on a CUDA device,
    never passed in, and made again by ``dataclasses.replace``."""
    _, png = tables[(2, True)]
    assert png.k4 is None
    with pytest.raises(TypeError):
        pngram.NgramIndex(png.packed, png.cn, 2, True, k4=png.packed)
    other = dataclasses.replace(png, biased=False)
    assert other.k4 is None and other.packed is png.packed

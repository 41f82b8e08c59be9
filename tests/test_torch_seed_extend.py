"""Port parity: one depth of the seed-table BFS (``extend_level``).

The port's ``extend_level_plain`` is held to the JAX package's
``_extend_all_letters`` (narrow) and ``search64._extend_level_chunked``
(wide) depth by depth and on crafted parent tables: ranges that start at
0 (``start - 1`` wraps and reads the last row), absent ranges (``start >
end``), ranges whose ``start - 1`` and ``end`` lie in one block or in two,
positions past the table and, for the wide view, positions no search
produces (bit 39 set, 2^64 - 1). The amino index's wide view without
pair rows (compact 384 B rows) is held to the JAX package's view under
``AWFM_PAIR_ROWS=0``. On the CPU ``extend_level`` and ``build_seed_table``
take the plain version and launch nothing; on the card they are K1X /
K1WX and the BFS mode (``kernels.k1_seed_table``, the whole table or its
shallow depths in one launch, by ``seed_table.bfs_depths``), which
``chip_smoke.py`` holds to the plain version. Exact: tolerance 0.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import avxwindowfmindex_tpu as jx
from avxwindowfmindex_tpu import search64
from avxwindowfmindex_tpu.ops import rank64 as r64
from avxwindowfmindex_tpu.ops import seed_table as jseed
from avxwindowfmindex_tpu_torch.models.index import u32_tensor, u64_tensor, widen_u32
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.ops import rank
from avxwindowfmindex_tpu_torch.ops import seed_table

from oracle import random_sequence
from torch_helpers import build_both

DNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.AMINO
# (alphabet, seed k, bases): four or five BFS depths, a few hundred parents
# at the deepest
SIZES = {DNA: (5, 3000), AMINO: (3, 2500)}
# the layouts of a view; "wide-compact": an amino wide view without pair
# rows (the JAX package's AWFM_PAIR_ROWS=0)
CASES = [(a, w) for a in (DNA, AMINO) for w in ("narrow", "wide")] + [(AMINO, "wide-compact")]


def _ids(case):
    alphabet, layout = case
    return f"{alphabet.name}-{layout}"


@pytest.fixture(scope="module", params=CASES, ids=_ids)
def built_views(request):
    """(alphabet, layout, JAX index, JAX view, port index, port view)."""
    alphabet, layout = request.param
    k, n = SIZES[alphabet]
    wide, compact = layout != "narrow", layout == "wide-compact"
    rng = np.random.default_rng(0x5E7 + n + int(wide))
    j, p = build_both(random_sequence(rng, n, alphabet), 4, k, alphabet)
    with pytest.MonkeyPatch.context() as mp:
        if compact:
            mp.setenv("AWFM_PAIR_ROWS", "0")
        jdev = j.to_device(refresh=True, wide=wide)
    j._device_cache = None  # later users see the narrow default
    pdev = p.to_device("cpu", wide=wide, pair_rows=False if compact else None)
    if compact:
        assert not jdev.pair_fused and jdev.packed.shape[1] == 384
        assert not pdev.pair_fused and pdev.packed.shape[1] == 384
    return alphabet, layout, j, jdev, p, pdev


@pytest.fixture
def views(built_views, monkeypatch):
    """(alphabet, wide, JAX index, JAX view, port index, port view); for the
    compact layout the JAX side runs under ``AWFM_PAIR_ROWS=0``."""
    alphabet, layout, j, jdev, p, pdev = built_views
    if layout == "wide-compact":
        monkeypatch.setenv("AWFM_PAIR_ROWS", "0")
    return alphabet, layout != "narrow", j, jdev, p, pdev


def _table(values: np.ndarray, wide: bool) -> torch.Tensor:
    """(n, 2) uint64 ranges as a port table in the view's storage type
    (u32 values wrap mod 2^32)."""
    return (u64_tensor if wide else u32_tensor)(values, "cpu")


def _values(table: torch.Tensor, wide: bool) -> np.ndarray:
    """A port table as (n, 2) uint64."""
    if wide:
        return table.numpy().view(np.uint64)
    return table.numpy().view(np.uint32).astype(np.uint64)


def _jax_extend(jdev, parents: np.ndarray, card: int, wide: bool) -> np.ndarray:
    """The JAX package's level extend of (n, 2) uint64 parents, as
    (card * n, 2) uint64, child ``letter * n + i``."""
    if not wide:
        s, e = jseed._extend_all_letters(
            jdev, jnp.asarray(parents[:, 0].astype(np.uint32)),
            jnp.asarray(parents[:, 1].astype(np.uint32)))
        return np.stack([np.asarray(s), np.asarray(e)], axis=1).astype(np.uint64)
    s_hi, s_lo = r64.split_u64_host(parents[:, 0])
    e_hi, e_lo = r64.split_u64_host(parents[:, 1])
    out = search64._extend_level_chunked(
        jdev, jnp.asarray(s_hi), jnp.asarray(s_lo), jnp.asarray(e_hi), jnp.asarray(e_lo),
        card, 1 << 21)
    hi_lo = [np.asarray(x).astype(np.uint64) for x in out]
    return np.stack([(hi_lo[0] << np.uint64(32)) | hi_lo[1],
                     (hi_lo[2] << np.uint64(32)) | hi_lo[3]], axis=1)


def _first_level(index) -> np.ndarray:
    card = index.cardinality
    ps = np.asarray(index.prefix_sums, dtype=np.uint64)
    return np.stack([ps[:card], ps[1 : card + 1] - 1], axis=1)


def crafted_parents(rng, bwt_length: int, nb: int, wide: bool) -> np.ndarray:
    """(m, 2) uint64 parent ranges a BFS level may hold, and the edges of
    the block-index rule: narrow random ranges, ``start == 0`` (with
    ``start - 1`` on the last row), absent ``start > end`` ranges, ranges
    whose ``start - 1`` and ``end`` straddle a block boundary (valid and
    absent), both ends in one block, both on the last row, positions past
    the table, and for a wide view u64 positions no search produces."""
    n = bwt_length
    s = rng.integers(0, n + 1, size=300).astype(np.uint64)
    ranges = [np.stack([s, s + rng.integers(0, 4, size=300).astype(np.uint64)], axis=1)]
    fixed = [[0, 0], [0, 5], [0, n - 1], [1, 0], [n, n - 1], [256, 255], [255, 256],
             [257, 256], [n - 1, n - 1], [n, n], [nb * 256 - 1, nb * 256 + 7],
             [(nb - 1) * 256, n - 1], [7, 3], [300, 2], [2**31, 5], [2**32 - 1, 0],
             [1, 2**32 - 1]]
    if wide:
        fixed += [[2**64 - 1, 0], [0, 2**64 - 1], [2**39 + 77, 2**40 + 5], [2**40 + 5, 3],
                  [2**63, 2**63 + 255], [2**32 + 1, 2**32 + 200]]
    ranges.append(np.array(fixed, dtype=np.uint64))
    b = rng.integers(1, nb, size=40).astype(np.uint64) * np.uint64(256)
    ranges.append(np.stack([b - np.uint64(3), b + np.uint64(2)], axis=1))  # straddle, valid
    ranges.append(np.stack([b + np.uint64(10), b - np.uint64(40)], axis=1))  # straddle, absent
    return np.concatenate(ranges)


def _kinds(parents: np.ndarray, nb: int) -> dict:
    """How many parents of each kind the crafted table holds (narrow block rule)."""
    mask, last = np.uint64(2**32 - 1), np.uint64(nb - 1)
    s, e = parents[:, 0] & mask, parents[:, 1] & mask
    bs = np.minimum(((s - np.uint64(1)) & mask) >> np.uint64(8), last)
    be = np.minimum(e >> np.uint64(8), last)
    return {"start 0": int((s == 0).sum()), "absent": int((s > e).sum()),
            "two blocks": int((bs != be).sum()), "one block": int((bs == be).sum()),
            "last row": int(((bs == nb - 1) & (be == nb - 1)).sum())}


def test_extend_level_plain_equals_jax_at_every_depth(views):
    alphabet, wide, j, jdev, p, pdev = views
    card, k = pdev.cardinality, SIZES[alphabet][0]
    parents = _first_level(p)
    for depth in range(1, k):
        got = seed_table.extend_level_plain(pdev, _table(parents, wide))
        want = _jax_extend(jdev, parents, card, wide)
        assert got.shape == (card * len(parents), 2)
        np.testing.assert_array_equal(_values(got, wide), want, err_msg=f"depth {depth}")
        parents = want
    np.testing.assert_array_equal(parents, j.kmer_seed_table)


def test_extend_level_plain_equals_jax_on_crafted_parents(views):
    alphabet, wide, _, jdev, _, pdev = views
    rng = np.random.default_rng(0xC0FFEE + int(wide))
    parents = crafted_parents(rng, pdev.bwt_length, pdev.num_blocks, wide)
    kinds = _kinds(parents, pdev.num_blocks)
    assert min(kinds.values()) > 0, kinds
    got = seed_table.extend_level_plain(pdev, _table(parents, wide))
    want = _jax_extend(jdev, parents if wide else parents & np.uint64(2**32 - 1),
                       pdev.cardinality, wide)
    np.testing.assert_array_equal(_values(got, wide), want)
    # the dispatch takes the same plain version for a CPU table, in any chunk
    for chunk in (seed_table.CHUNK, 7):
        assert torch.equal(seed_table.extend_level(pdev, _table(parents, wide), chunk), got)


def test_build_seed_table_through_extend_level_equals_jax(views):
    alphabet, wide, j, jdev, p, pdev = views
    k = SIZES[alphabet][0]
    got = seed_table.build_seed_table(pdev, pdev.cardinality, k, p.prefix_sums)
    if wide:
        want = np.asarray(search64.build_seed_table_device64(jdev, pdev.cardinality, k,
                                                             j.prefix_sums))
        assert got.numpy().tobytes() == want.tobytes()
    else:
        np.testing.assert_array_equal(_values(got, wide), j.kmer_seed_table)
    assert torch.equal(got, pdev.seed_table)  # the wide view's was widened from the narrow one


def test_extend_level_on_the_cpu_launches_nothing(views):
    """A CPU view takes the plain loop: ``build_seed_table`` equals the
    plain BFS over ``occurrence_plain``, and nothing launches."""
    _, wide, _, _, p, pdev = views
    before = kernels.launch_counts()
    want = seed_table.build_seed_table(pdev, pdev.cardinality, 3, p.prefix_sums,
                                       occurrence_fn=rank.occurrence_plain)
    got = seed_table.build_seed_table(pdev, pdev.cardinality, 3, p.prefix_sums)
    assert torch.equal(got, want)
    seed_table.extend_level(pdev, _table(_first_level(p), wide))
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("alphabet", [DNA, AMINO], ids=lambda a: a.name)
def test_wide_extend_equals_narrow_widened(alphabet):
    """On ranges below 2^32 (every BFS level of an index below 2^32
    positions, and such crafted ones) the wide form is the narrow one with
    zero high words."""
    k, n = SIZES[alphabet]
    rng = np.random.default_rng(0x71DE + n)
    _, p = build_both(random_sequence(rng, n, alphabet), 4, k, alphabet)
    narrow = p.to_device("cpu")
    wide = p.to_device("cpu", wide=True)
    parents = np.concatenate([_first_level(p), crafted_parents(rng, p.bwt_length, narrow.num_blocks,
                                                               wide=False)])
    parents = parents[(parents < 2**32).all(axis=1)]
    # the amino index's compact rows too (a wide view without pair rows)
    wides = [wide] + ([p.to_device("cpu", wide=True, pair_rows=False)] if alphabet == AMINO
                      else [])
    for _ in range(2):
        got_n = seed_table.extend_level(narrow, _table(parents, False))
        for view in wides:
            got_w = seed_table.extend_level(view, _table(parents, True))
            assert torch.equal(got_w, widen_u32(got_n))
        parents = _values(got_n, False)


def test_k1_extend_takes_no_cpu_table(views):
    """The kernel wrapper has no plain route: a table or view off the card
    raises before anything launches."""
    _, wide, _, _, p, pdev = views
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k1_extend(pdev, _table(_first_level(p), wide))
    assert kernels.K1X.launches == 0 and kernels.K1WX.launches == 0


def test_k1_seed_table_takes_no_cpu_view(views):
    """The BFS mode's wrapper has no plain route either: a view off the card
    raises before anything is built or launched, at any level count."""
    _, _, _, _, _, pdev = views
    before = kernels.launch_counts()
    for levels in (1, 2, 3):
        with pytest.raises(ValueError, match="CUDA tensor"):
            kernels.k1_seed_table(pdev, levels)
    assert kernels.launch_counts() == before


# ---------------------------------------------------------------------------
# the depth split: which depths go into the BFS mode's one launch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k", range(2, 15))
@pytest.mark.parametrize("card", [4, 20])
def test_bfs_depths_rule(card, k):
    """Depths 1 .. s go into the one launch, s the number of leading depths
    whose card^d parents number at most the threshold; a threshold just
    below card^d stops before depth d, one at card^d takes it."""
    rule = seed_table.bfs_depths
    assert rule(card, k, 0) == 0
    assert rule(card, k, card - 1) == 0
    assert rule(card, k, 2**62) == k - 1
    for d in range(1, k):
        assert rule(card, k, card**d) == d
        assert rule(card, k, card**d - 1) == d - 1
        assert rule(card, k, card**d + 1) == d
    assert rule(card, k, card ** k) == k - 1  # a BFS has k - 1 depths
    for limit in (card**2, 2**22, 2**31):
        want = sum(1 for d in range(1, k) if card**d <= limit)
        assert rule(card, k, limit) == want


@pytest.mark.parametrize("layout", ["narrow", "wide", "wide-compact"])
def test_bfs_launches_by_form(layout):
    """Each form's launches a table on the card: one of the BFS mode and
    one a depth past its threshold; the compact amino form takes every
    depth of its k = 5 and k = 6 BFS in its one launch."""
    alphabet = AMINO if layout == "wide-compact" else DNA
    k, n = SIZES[alphabet]
    rng = np.random.default_rng(0xB75 + n)
    _, p = build_both(random_sequence(rng, n, alphabet), 4, k, alphabet)
    dev = p.to_device("cpu", wide=layout != "narrow",
                      pair_rows=False if layout == "wide-compact" else None)
    form = kernels.form_of(dev, kernels.K1X).name
    assert form == {"narrow": "k1_extend", "wide": "k1w_extend",
                    "wide-compact": "k1w_extend_compact"}[layout]
    limit = seed_table.BFS_MAX_PARENTS[form]
    assert seed_table.bfs_max_parents(dev) == limit
    card = dev.cardinality
    assert limit > 0
    for kk in range(2, 15 if card == 4 else 8):
        assert seed_table.bfs_launches(dev, kk) == kk - seed_table.bfs_depths(card, kk, limit)
    if layout == "wide-compact":
        assert seed_table.bfs_launches(dev, 5) == seed_table.bfs_launches(dev, 6) == 1

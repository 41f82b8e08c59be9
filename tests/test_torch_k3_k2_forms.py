"""Port parity for what K3's and K2's designs rest on: the warp
lane-occupancy of a walk, the letter tables the kernels stage in shared
memory, and the backtrace at SA ratios from 1 to 64.

The JAX package is the reference (pinned to the CPU by conftest.py); the
port runs on ``device="cpu"``, where K2 and K3 are their plain versions.
Exact: tolerance 0.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu import search as jsearch
from avxwindowfmindex_tpu_torch import search as psearch
from avxwindowfmindex_tpu_torch.models import index as pindex
from avxwindowfmindex_tpu_torch.utils import roofline

from oracle import random_sequence
from torch_helpers import build_both

DNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.AMINO


# -- (a) the lane-occupancy ratio of a walk ----------------------------------

def _occupancy_loop(off, warp=32):
    """32 x the longest walk of each warp over the steps walked, by a loop."""
    off = [int(x) for x in off]
    walked = sum(off)
    if walked == 0:
        return 1.0
    held = 0
    for lo in range(0, len(off), warp):
        held += warp * max(off[lo : lo + warp])
    return held / walked


def _geometric(seed, n, ratio):
    return np.random.default_rng(seed).geometric(1.0 / ratio, size=n) - 1


OFF_VECTORS = {
    "all-zero": np.zeros(96, np.int64),
    "one-long-walk": np.concatenate([np.zeros(40, np.int64), [977], np.zeros(23, np.int64)]),
    "one-lane": np.array([5]),
    "uniform": np.full(64, 7),
    "ratio8-x4096": _geometric(1, 4096, 8),
    "ratio4-x4096": _geometric(2, 4096, 4),
    "ragged-x1000": _geometric(3, 1000, 8),
    "ragged-x33": _geometric(4, 33, 64),
    "shorter-than-a-warp": _geometric(5, 19, 8),
}


@pytest.mark.parametrize("name", list(OFF_VECTORS))
def test_warp_lane_occupancy_equals_loop(name):
    off = OFF_VECTORS[name]
    got = roofline.warp_lane_occupancy(torch.from_numpy(np.asarray(off, np.int64)))
    assert got == _occupancy_loop(off)
    assert got >= 1.0


def test_warp_lane_occupancy_known_values():
    occ = roofline.warp_lane_occupancy
    assert occ(torch.zeros(0, dtype=torch.int64)) == 1.0
    assert occ(torch.full((64,), 7)) == 1.0  # every lane busy all the time
    assert occ(torch.tensor([8] + [0] * 31)) == 32.0  # one lane of a warp works
    assert occ(torch.tensor([8] + [0] * 32)) == 32.0  # the second warp holds nothing
    assert occ(torch.tensor([4, 2]), warp=2) == 8 / 6
    # geometric walks: the ratio barely depends on their mean
    r8 = occ(torch.from_numpy(_geometric(7, 1 << 16, 8)))
    r4 = occ(torch.from_numpy(_geometric(8, 1 << 16, 4)))
    assert 3.5 < r8 < 5.0 and 3.5 < r4 < 5.5


# -- (b) the letter tables the kernels stage ---------------------------------

@pytest.fixture(scope="module", params=[(DNA, 3), (AMINO, 2)], ids=lambda c: c[0].name)
def both(request):
    alphabet, k = request.param
    seq = random_sequence(np.random.default_rng(0xC0DE), 3000, alphabet)
    j, p = build_both(seq, 4, k, alphabet)
    return alphabet, j, p


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
def test_staged_tables_equal_jax_device_tables(both, wide):
    alphabet, j, p = both
    jdev = j.to_device(refresh=True, wide=wide)
    masks = np.asarray(jdev.code_masks)
    v2i = np.asarray(jdev.vec_to_index)
    j._device_cache = None
    pdev = p.to_device("cpu", wide=wide)
    card, n_planes = pdev.cardinality, pdev.n_planes
    letter_code, code_letter = pindex.kernel_letter_tables(pt.AlphabetType(int(alphabet)))
    assert letter_code.shape == code_letter.shape == (32,) and letter_code.dtype == np.uint8
    # a letter's code: its row of the JAX device_code_masks, one bit a plane
    folded = ((masks != 0).astype(np.int64) << np.arange(n_planes)).sum(axis=1)
    np.testing.assert_array_equal(letter_code[: card + 1], folded[: card + 1])
    assert not letter_code[card + 1 :].any()  # the sentinel and above match nothing
    np.testing.assert_array_equal(code_letter[: 1 << n_planes], v2i)
    assert not code_letter[1 << n_planes :].any()

    ps = pdev.numpy_u64(pdev.prefix_sums)
    consts = pindex.kernel_block_constants(pt.AlphabetType(int(alphabet)), ps)
    np.testing.assert_array_equal(consts["c"][: card + 2], ps)
    assert not consts["c"][card + 2 :].any()  # above the sentinel: C = 0
    np.testing.assert_array_equal(consts["has_milestone"], np.arange(32) <= card)
    # an LF step from a position whose planes spell code c, as
    # letter_and_lf_at takes it: the letter, clamped to the ambiguity
    # letter for C, match code and milestone column; the sentinel apart
    for c in range(1 << n_planes):
        lett = int(v2i[c])
        col = min(lett, card)
        assert consts["letter"][c] == lett
        assert consts["column"][c] == col
        assert consts["c_of_code"][c] == ps[col]
        assert consts["match_code"][c] == folded[col]
        assert consts["is_sentinel"][c] == (lett == card + 1)


def test_staged_tables_drive_the_plain_lf(both):
    """LF by the staged tables (code -> letter, C, match code, column) on
    the port's block rows equals the port's plain letter_and_lf and so the
    JAX package's, at every position, the sentinel's among them."""
    from avxwindowfmindex_tpu_torch.ops import rank as prank

    alphabet, _, p = both
    dev = p.to_device("cpu", wide=False)
    n, n_planes = dev.bwt_length, dev.n_planes
    consts = pindex.kernel_block_constants(pt.AlphabetType(int(alphabet)),
                                           dev.numpy_u64(dev.prefix_sums))
    packed = dev.packed.numpy()
    pos = np.arange(n)
    rows = packed[pos >> 8]
    local = pos & 255
    planes = np.stack([np.unpackbits(rows[:, i * 32 : (i + 1) * 32], axis=1, bitorder="little")
                       for i in range(n_planes)])  # (planes, n, 256)
    code = sum(planes[i][pos, local].astype(np.int64) << i for i in range(n_planes))
    all_codes = sum(planes[i].astype(np.int64) << i for i in range(n_planes))  # (n, 256)
    match = all_codes == consts["match_code"][code][:, None]
    count = (match & (np.arange(256)[None, :] <= local[:, None])).sum(axis=1)
    ms = rows[:, n_planes * 32 :].copy().view("<u4")[pos, consts["column"][code]]
    lf = np.where(consts["is_sentinel"][code], 0,
                  consts["c_of_code"][code].astype(np.int64) + ms + count - 1)
    want_letter, want_lf = prank.letter_and_lf_plain(dev, torch.from_numpy(pos))
    np.testing.assert_array_equal(consts["letter"][code], want_letter.numpy())
    np.testing.assert_array_equal(lf, want_lf.numpy())
    assert consts["is_sentinel"][code].sum() == 1


# -- (c) the backtrace at SA ratios 1 to 64 ----------------------------------

RATIOS = (1, 3, 4, 8, 64)


@pytest.fixture(scope="module")
def text():
    return random_sequence(np.random.default_rng(0xBAC7), 20_000, DNA)


@pytest.fixture(scope="module", params=RATIOS, ids=lambda r: f"ratio{r}")
def at_ratio(request, text):
    ratio = request.param
    j, p = build_both(text, ratio, 4, DNA)
    jdev = j.to_device()
    pdev = p.to_device("cpu")
    n = pdev.bwt_length
    rng = np.random.default_rng(ratio)
    sentinel_row = int(np.flatnonzero(p.bwt_letters == pdev.sentinel)[0])
    pos = np.concatenate([rng.integers(0, n, size=700), [sentinel_row, 0, n - 1],
                          np.arange(0, n, max(n // 64, 1))])
    return ratio, jdev, pdev, pos, sentinel_row


def test_backtrace_on_disk_form_equals_jax(at_ratio):
    ratio, jdev, pdev, pos, sentinel_row = at_ratio
    want_p, want_off = jsearch.backtrace_all(jdev, jnp.asarray(pos.astype(np.uint32)))
    disk = dataclasses.replace(pdev, sampled_sa=None)
    got_p, got_off = psearch.backtrace_resolve_plain(disk, torch.from_numpy(pos))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p).astype(np.int64))
    np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off).astype(np.int64))
    assert (got_p.numpy() % ratio == 0).all()
    # the sentinel's row, unless sampled itself, steps to position 0, which
    # every ratio samples
    at = int(np.flatnonzero(pos == sentinel_row)[0])
    if sentinel_row % ratio == 0:
        assert got_p[at] == sentinel_row and got_off[at] == 0
    else:
        assert got_p[at] == 0 and got_off[at] == 1
    if ratio == 1:
        assert not got_off.any() and (got_p.numpy() == pos).all()
    else:
        assert int(got_off.max()) >= ratio - 1
    # the dispatching wrapper takes the plain version for CPU tensors
    wp, woff = psearch.backtrace_resolve(disk, torch.from_numpy(pos))
    assert torch.equal(wp, got_p) and torch.equal(woff, got_off)


def test_backtrace_resolve_equals_jax(at_ratio):
    ratio, jdev, pdev, pos, _ = at_ratio
    p, off = jsearch.backtrace_all(jdev, jnp.asarray(pos.astype(np.uint32)))
    want = np.asarray(jsearch._resolve_samples(jdev, p, off)).astype(np.int64)
    got = psearch.backtrace_resolve_plain(pdev, torch.from_numpy(pos))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int64 and int(got.max()) < pdev.bwt_length


def test_backtrace_hits_are_suffix_positions(at_ratio, text):
    """The resolved hit of BWT row i is SA[i]: rows of a k-mer's range
    resolve to its occurrences in the text."""
    ratio, _, pdev, _, _ = at_ratio
    eng = pt.SearchEngine(pdev, device="cpu")
    kmer = text[777:785]
    (start, end), = eng.find_ranges([kmer])
    rows = torch.arange(int(start), int(end) + 1)
    hits = sorted(psearch.backtrace_resolve_plain(pdev, rows).tolist())
    want = [i for i in range(len(text) - len(kmer) + 1) if text[i : i + len(kmer)].upper() == kmer.upper()]
    assert hits == want and 777 in hits



@pytest.fixture(scope="module")
def wide_view(at_ratio, text):
    """The port's index at the fixture's ratio, as a wide view (u64
    positions over 256 B rows)."""
    ratio = at_ratio[0]
    p = pt.create_index(text, pt.IndexConfiguration(ratio, 4, pt.AlphabetType.DNA), device="cpu")
    return p.to_device("cpu", wide=True)


@pytest.mark.parametrize("output", ["resolve", "on-disk"])
@pytest.mark.parametrize("order", ["as-drawn", "shuffled"])
def test_wide_backtrace_equals_jax(at_ratio, wide_view, order, output):
    """The wide view's backtrace (K3w's plain version) at every ratio gives
    the JAX backtrace's answers, in the order drawn and shuffled."""
    ratio, jdev, _, pos, _ = at_ratio
    assert wide_view.wide and wide_view.ratio == ratio
    if order == "shuffled":
        pos = np.random.default_rng(ratio).permutation(pos)
    want_p, want_off = jsearch.backtrace_all(jdev, jnp.asarray(pos.astype(np.uint32)))
    if output == "on-disk":
        disk = dataclasses.replace(wide_view, sampled_sa=None)
        got_p, got_off = psearch.backtrace_resolve_plain(disk, torch.from_numpy(pos))
        np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p).astype(np.int64))
        np.testing.assert_array_equal(got_off.numpy(), np.asarray(want_off).astype(np.int64))
    else:
        want = np.asarray(jsearch._resolve_samples(jdev, want_p, want_off)).astype(np.int64)
        got = psearch.backtrace_resolve_plain(wide_view, torch.from_numpy(pos))
        np.testing.assert_array_equal(got.numpy(), want)

"""Port parity: K1's single-query modes (a step of one range, the LF of
one position, each passed by value) against the JAX package.

On the card ``iterative_step_backward_search`` is one launch of K1's
step mode and ``backtrace_return_previous_letter_index`` one launch of
its LF mode by value, each with its arguments packed by
``rank.step_args`` (positions wrapped to the view's width, the letter a
u32 of at most 255) and its 16 B result read back as two u64 words. On
the CPU the same packing feeds the plain versions, ``rank.step_plain``
and ``rank.lf_at_plain``, which the kernels are held to on the card.
Here those are held to ``jx.iterative_step_backward_search`` and
``jx.backtrace_return_previous_letter_index`` on the same index, for DNA
and amino, on the narrow view with pair rows and without (the JAX side
under ``AWFM_PAIR_ROWS=0``), the forced-wide view (pair-fused) and the
wide view without pair rows (pair-fused for nucleotides, the compact
rows for amino). Where the JAX function refuses an input (a position
outside its u32 / u64 type, a letter outside int32), the port is held
to the plain batched step on the same values instead. The per-view cache
of the kernels' tables is checked too. Inputs come from numpy seeds;
every quantity is an integer: tolerance 0.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu.models.index import FmIndex as JaxFmIndex
from avxwindowfmindex_tpu_torch import build as pbuild
from avxwindowfmindex_tpu_torch.ops import kernels
from avxwindowfmindex_tpu_torch.ops import rank as prank

from oracle import random_sequence
from torch_helpers import build_both

DNA, AMINO = jx.AlphabetType.DNA, jx.AlphabetType.AMINO
# (name, wide, pair_rows): the views a single-query call can take
VIEWS = [("narrow", False, True), ("narrow-pairless", False, False),
         ("wide", True, True), ("wide-pairless", True, False)]


@pytest.fixture(scope="module", params=[(DNA, 3000, 3), (AMINO, 2500, 2)],
                ids=["DNA", "AMINO"])
def built(request):
    """(alphabet, JAX FmIndex, port FmIndex) of one random text."""
    alphabet, n, k = request.param
    seq = random_sequence(np.random.default_rng(0x515 + n), n, alphabet)
    j, p = build_both(seq, 4, k, alphabet)
    return alphabet, j, p


@pytest.fixture(params=VIEWS, ids=[v[0] for v in VIEWS])
def views(request, built, monkeypatch):
    """(alphabet, JAX index handing out the view, the port's view, the
    port's keywords): the JAX side without pair rows through
    ``AWFM_PAIR_ROWS=0``, wide through its ``to_device(wide=True)``."""
    alphabet, j, p = built
    _, wide, pair_rows = request.param
    j._device_cache = None
    if not pair_rows:
        monkeypatch.setenv("AWFM_PAIR_ROWS", "0")
    if wide:
        orig = JaxFmIndex.to_device
        monkeypatch.setattr(
            JaxFmIndex, "to_device",
            lambda self, refresh=False, wide=None: orig(self, refresh=refresh, wide=True))
    kw = dict(device="cpu", wide=wide, pair_rows=pair_rows)
    view = p.to_device("cpu", wide=wide, pair_rows=pair_rows)
    assert view.wide == wide
    assert view.pair_rows == (pair_rows or (wide and alphabet == DNA))
    if wide and not pair_rows and alphabet == AMINO:
        assert view.packed.shape[1] == 384  # the compact rows
    yield alphabet, j, p, view, kw
    j._device_cache = None


def _refused(view, start, end, letter) -> bool:
    """Whether the JAX function refuses the input: a position outside its
    u32 (u64 when wide) array type, a letter outside int32."""
    top = 2**64 if view.wide else 2**32
    return not (0 <= start < top and 0 <= end < top and -2**31 <= letter < 2**31)


def _plain_batched(view, start, end, letter):
    """The plain batched step on the same values, unpacked as u32 / u64."""
    mask = prank.word_mask(view)
    one = lambda v: torch.tensor([prank.int64_of(v & mask)], dtype=torch.int64)
    s, e = prank.backward_step(view, one(start), one(end),
                               torch.tensor([letter], dtype=torch.int64), check_valid=False,
                               occurrence_fn=prank.occurrence_plain)
    return int(s[0]) & mask, int(e[0]) & mask


def _edge_calls(view, rng):
    """Crafted (start, end, letter) triples: start 0 (start - 1 wraps), end =
    bwtLength - 1, end < start, ends one block apart, positions past the
    table and beyond the view's width, every letter of the alphabet, the
    ambiguity and sentinel letters and letters beyond them."""
    n, card = view.bwt_length, view.cardinality
    starts = [0, 1, 7, 255, 256, 257, n - 2, n - 1, n, *rng.integers(0, n, 2).tolist()]
    letters = [*range(card + 2), card + 2, 31, 255, 256, 1000, -1]
    ranges = [(s, e) for s in starts for e in (s - 1, s, s + 255, s + 256, n - 1)]
    calls = [(s, e, letters[i % len(letters)]) for i, (s, e) in enumerate(ranges)]
    calls += [(s, e, lett) for s, e in ((0, n - 1), (5, 40), (300, 20)) for lett in letters]
    return calls


def test_step_equals_jax(views):
    """The plain step of one range, packed and unpacked as K1's step mode's
    wrapper does, equals ``jx.iterative_step_backward_search``; so does the
    port's API call on the view."""
    alphabet, j, p, view, kw = views
    rng = np.random.default_rng(0x57E)
    checked = 0
    for s, e, lett in _edge_calls(view, rng):
        if _refused(view, s, e, lett):
            continue
        args = prank.step_args(view, s, e, lett)
        got = prank.step_plain(view, *args)
        want = jx.iterative_step_backward_search(j, s, e, lett)
        assert got == want, (s, e, lett)
        assert pt.iterative_step_backward_search(p, s, e, lett, **kw) == want, (s, e, lett)
        checked += 1
    assert checked >= 60


def test_refused_inputs_equal_the_plain_batched_step(views):
    """Inputs the JAX function refuses (end = -1, positions at and past
    the view's width, letters outside int32): the port's packed step
    equals the plain batched step on the same values, the JAX function
    raising on each."""
    alphabet, j, p, view, kw = views
    n = view.bwt_length
    top = 2**64 if view.wide else 2**32
    calls = [(0, -1, 1), (5, -1, 0), (top, top + 40, 1), (top + 3, n - 1, 2), (-1, 40, 0),
             (2**70, 3, 1), (3, 40, 2**40), (0, n - 1, -2**31 - 1), (10, 300, 2**31)]
    for s, e, lett in calls:
        assert _refused(view, s, e, lett)
        with pytest.raises((OverflowError, ValueError)):
            jx.iterative_step_backward_search(j, s, e, lett)
        want = _plain_batched(view, s, e, lett)
        assert prank.step_plain(view, *prank.step_args(view, s, e, lett)) == want, (s, e, lett)
        assert pt.iterative_step_backward_search(p, s, e, lett, **kw) == want, (s, e, lett)


def test_lf_equals_jax(views):
    """The plain LF of one position, as K1's LF mode's wrapper packs and
    unpacks it (the sentinel's early-out keeping the position), equals
    ``jx.backtrace_return_previous_letter_index``; so does the API call."""
    alphabet, j, p, view, kw = views
    rng = np.random.default_rng(0x1F)
    n = view.bwt_length
    sentinel_pos = int(np.flatnonzero(p.bwt_letters == p.sentinel_index)[0])
    for pos in [0, 1, 255, 256, 257, n - 1, sentinel_pos, *rng.integers(0, n, 10).tolist()]:
        lett, lf = prank.lf_at_plain(view, pos & prank.word_mask(view))
        got = (0, pos) if lett == view.sentinel else (lett, lf)
        assert got == jx.backtrace_return_previous_letter_index(j, pos), pos
        assert pt.backtrace_return_previous_letter_index(p, pos, **kw) == got, pos
    assert prank.lf_at_plain(view, sentinel_pos) == (view.sentinel, 0)


@pytest.mark.parametrize("wide", [False, True], ids=["narrow", "wide"])
@pytest.mark.parametrize("letter", [0, 3, 20, 21, 255, 256, -1, 2**31, 2**62])
def test_step_args_fit_the_c_types(built, wide, letter):
    """What ``rank.step_args`` hands K1's step mode fits its C types
    unchanged (``c_uint64`` positions, a ``c_uint32`` letter of at most
    255), and a letter clamped to 255 steps as the letter itself does."""
    alphabet, j, p = built
    view = p.to_device("cpu", wide=wide)
    n = view.bwt_length
    for start, end in ((0, n - 1), (2**32 + 5, 2**40), (-1, -2), (2**64 + 7, 3)):
        s, e, lett = prank.step_args(view, start, end, letter)
        assert (s, e) == (start & prank.word_mask(view), end & prank.word_mask(view))
        assert ctypes.c_uint64(s).value == s and ctypes.c_uint64(e).value == e
        assert ctypes.c_uint32(lett).value == lett and 0 <= lett <= 255
        assert prank.step_plain(view, s, e, lett) == _plain_batched(view, start, end, letter)


@pytest.mark.parametrize("change", ["attach_seed_table", "layout_swap", "densify",
                                    "field_replaced", "wide_rebuild"])
def test_view_state_is_rebuilt(built, monkeypatch, change):
    """The kernels' per-view state (the checked tables a single-query call
    launches with) is built once a view and built again whenever the view
    is made anew or a tensor its tables point into is replaced: a view
    from ``attach_seed_table``, a ``to_device`` layout swap or width
    rebuild, ``densify_device_sa``, or a field set in place. The tables
    are checked here through a stand-in for ``_tables`` (the real one
    takes CUDA tensors only), which records what it was given."""
    alphabet, j, p = built
    made = []

    def tables(dev, shard=False):
        made.append(dev)
        return kernels._Tables(packed=dev.packed.data_ptr(),
                               prefix_sums=dev.prefix_sums.data_ptr())

    monkeypatch.setattr(kernels, "_tables", tables)
    p._device_cache = None
    view = p.to_device("cpu")
    state = kernels._view_state(view)
    assert kernels._view_state(view) is state and made == [view]
    if change == "attach_seed_table":
        pbuild.attach_seed_table(p, "cpu")
        new = p.to_device("cpu")
    elif change == "layout_swap":
        new = p.to_device("cpu", pair_rows=False)
    elif change == "wide_rebuild":
        new = p.to_device("cpu", wide=True)
    elif change == "densify":
        new = p.densify_device_sa(2, device="cpu")
    else:
        view.packed = view.packed.clone()
        new = view
    assert new is not view or change == "field_replaced"
    fresh = kernels._view_state(new)
    assert fresh is not state and made[-1] is new and len(made) == 2
    assert fresh.tables.packed == new.packed.data_ptr()
    assert fresh.tables.prefix_sums == new.prefix_sums.data_ptr()
    assert kernels._view_state(new) is fresh and len(made) == 2
    if new is not view:  # the old view keeps its own state
        assert kernels._view_state(view) is state and len(made) == 2
    p._device_cache = None


@pytest.mark.parametrize("call", ["step", "lf_at", "empty"])
def test_single_query_wrappers_take_only_card_views(built, call):
    """K1's single-query wrappers never fall back: a CPU view is refused
    before any build, and nothing is counted as launched."""
    alphabet, j, p = built
    view = p.to_device("cpu")
    kernels.reset_launch_counts()
    fn = {"step": lambda: kernels.k1_step(view, 0, 5, 1),
          "lf_at": lambda: kernels.k1_lf_at(view, 5),
          "empty": lambda: kernels.empty_call(view)}[call]
    with pytest.raises(ValueError, match="CUDA"):
        fn()
    assert all(k.launches == 0 and not k.modes for k in kernels.KERNELS)
    assert kernels.launch_counts()["k1_rank"] == 0


def test_launch_counts_by_mode():
    """A kernel with modes counts each launch in its total and its mode;
    ``launch_counts`` names the modes ``kernel.mode``; a reset clears both."""
    kernels.reset_launch_counts()
    kernels.K1W_COMPACT.count("step")
    kernels.K1W_COMPACT.count("step")
    kernels.K1W_COMPACT.count("lf_at")
    got = kernels.launch_counts()
    assert got["k1w_rank_compact"] == 3
    assert got["k1w_rank_compact.step"] == 2 and got["k1w_rank_compact.lf_at"] == 1
    assert "k1_rank.step" not in got and got["k1_rank"] == 0
    kernels.reset_launch_counts()
    assert kernels.launch_counts()["k1w_rank_compact"] == 0
    assert "k1w_rank_compact.step" not in kernels.launch_counts()


def test_single_step_is_the_step_of_a_batch(built):
    """On the CPU the single-query step is the batched step's row: a walk
    of one range letter by letter equals ``rank.backward_step`` over the
    same letters, and the view's state is never built (no kernel)."""
    alphabet, j, p = built
    view = p.to_device("cpu")
    rng = np.random.default_rng(9)
    s, e = 0, view.bwt_length - 1
    ts, te = torch.tensor([s]), torch.tensor([e])
    for lett in rng.integers(0, view.cardinality, 6).tolist():
        s, e = prank.single_step(view, s, e, lett)
        ts, te = prank.backward_step(view, ts, te, torch.tensor([lett]), check_valid=False)
        assert (s, e) == (int(ts[0]), int(te[0]))
    assert id(view) not in kernels._VIEW_STATE
    # a replaced view keeps nothing alive: its state goes with it
    copy = dataclasses.replace(view)
    assert copy is not view and id(copy) not in kernels._VIEW_STATE

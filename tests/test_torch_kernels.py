"""The launcher layer of ``ops/kernels.py`` on the CPU: its one list of C
signatures against the entry points the CUDA sources declare, its
registry of kernels, and ``_launch``, which every launcher goes through
(the C call, the check of its return code, the count). No kernel is
built: a stand-in takes the C entry point's place."""

import re

import pytest

from avxwindowfmindex_tpu_torch.ops import kernels

# the launch counts' keys after a reset: every kernel's total
KERNEL_NAMES = {
    "k1_rank", "k2_ranges", "k3_backtrace_resolve", "k4_ngram_ranges", "k5_gather_reduce",
    "k6_slab_gather", "k1w_rank", "k2w_ranges", "k3w_backtrace_resolve", "k1_extend",
    "k1w_extend", "k1r_route", "k1r_rank", "k1rw_rank", "k2_ranges_block",
    "k4_ngram_ranges_block", "k1w_rank_compact", "k1w_extend_compact", "k2w_ranges_compact",
    "k3w_backtrace_resolve_compact", "k7_enumerate",
}


def _declared_entry_points() -> list:
    """The ``awfm_*`` functions defined in the ``extern "C"`` blocks of
    csrc/*.cu, one name per definition."""
    names = []
    for path in kernels._sources():
        if not path.endswith(".cu"):
            continue
        with open(path) as fh:
            text = re.sub(r"//[^\n]*", "", fh.read())
        for block in re.finditer(r'extern "C" \{', text):
            depth, i = 1, block.end()
            while depth:
                depth += {"{": 1, "}": -1}.get(text[i], 0)
                i += 1
            body = text[block.end():i]
            names += re.findall(r"^[A-Za-z_][\w \*]*?\b(awfm_\w+)\s*\(", body, re.MULTILINE)
    return names


def test_the_signature_table_names_every_c_entry_point_once():
    declared = _declared_entry_points()
    assert "awfm_k7_enumerate" in declared and "awfm_error_string" in declared
    assert sorted(declared) == sorted(kernels._SIGNATURES)


def test_every_kernel_is_registered_once():
    declared = [v for v in vars(kernels).values() if isinstance(v, kernels.Kernel)]
    assert len(kernels.KERNELS) == len(set(map(id, kernels.KERNELS))) == len(declared)
    assert set(map(id, kernels.KERNELS)) == set(map(id, declared))
    kernels.reset_launch_counts()
    assert kernels.launch_counts() == dict.fromkeys(KERNEL_NAMES, 0)


@pytest.mark.parametrize("modes, launches, by_mode", [
    ((None,), 1, {}),
    ((), 0, {}),
    (("bfs",), 1, {"bfs": 1}),
    (("scan", "write"), 2, {"scan": 1, "write": 1}),
], ids=["total", "none", "one-mode", "two-modes"])
def test_a_launch_counts_what_it_is_given(modes, launches, by_mode):
    seen = []

    def awfm_stand_in(*args):
        seen.append(args)
        return 0

    kernels.reset_launch_counts()
    kernels._launch(kernels.K7, awfm_stand_in, 3, None, modes=modes)
    assert seen == [(3, None)]
    assert kernels.K7.launches == launches and kernels.K7.modes == by_mode
    assert sum(kernels.launch_counts().values()) == launches + sum(by_mode.values())


def test_a_failed_launch_raises_with_its_entry_and_counts_nothing(monkeypatch):
    class Library:
        @staticmethod
        def awfm_error_string(rc):
            return f"error {rc}".encode()

    def awfm_stand_in(*args):
        return 7

    monkeypatch.setattr(kernels, "_library", lambda: Library)
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError, match=r"awfm_stand_in: CUDA error 7 \(error 7\)"):
        kernels._launch(kernels.K2, awfm_stand_in, 1, modes=("scan", "write"))
    assert all(k.launches == 0 and not k.modes for k in kernels.KERNELS)

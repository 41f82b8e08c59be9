"""Shared helpers for the PyTorch-port parity tests (tests/test_torch_*.py).

Each test builds the same input with both packages — the JAX reference
``avxwindowfmindex_tpu`` (JAX pinned to the CPU by conftest.py) and the
port ``avxwindowfmindex_tpu_torch`` on the CPU, where every kernel
wrapper runs its plain torch version — and compares exactly: every
quantity is an integer, so the tolerance is 0.
"""

from __future__ import annotations

import numpy as np
import torch

import avxwindowfmindex_tpu as jx
import avxwindowfmindex_tpu_torch as pt

# the parity inputs are small: torch's intra-op threads only contend with
# the other test workers and with XLA's own threads
torch.set_num_threads(1)

DEVICE_FIELDS = (
    "packed", "packed_pair", "prefix_sums", "seed_table", "sampled_sa",
    "code_masks", "vec_to_index",
)


def configs(ratio: int, k: int, alphabet, **kw):
    """The same IndexConfiguration in both packages."""
    return (
        jx.IndexConfiguration(ratio, k, jx.AlphabetType(int(alphabet)), **kw),
        pt.IndexConfiguration(ratio, k, pt.AlphabetType(int(alphabet)), **kw),
    )


def build_both(seq: bytes, ratio: int, k: int, alphabet, **kw):
    """(JAX FmIndex, port FmIndex) built from one sequence."""
    jcfg, pcfg = configs(ratio, k, alphabet)
    return (
        jx.create_index(seq, jcfg, **kw),
        pt.create_index(seq, pcfg, device="cpu", **kw),
    )


def jax_device_arrays(jax_index) -> dict:
    """np.asarray of every JAX DeviceIndex field."""
    dev = jax_index.to_device()
    return {
        f: None if getattr(dev, f) is None else np.asarray(getattr(dev, f))
        for f in DEVICE_FIELDS
    }


def port_device_bytes(port_dev) -> dict:
    """Raw bytes of every port DeviceIndex tensor field."""
    return {
        f: None if getattr(port_dev, f) is None
        else getattr(port_dev, f).numpy().tobytes()
        for f in DEVICE_FIELDS
    }


def assert_locates_equal(got, want) -> None:
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(
            np.asarray(g, dtype=np.uint64), np.asarray(w, dtype=np.uint64),
            err_msg=f"query {i}",
        )

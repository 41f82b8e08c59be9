"""State carried across from the JAX package.

Each function takes the JAX package's arrays as NumPy — ``np.asarray``
of each ``DeviceIndex``, ``DeviceIndex64`` or ``NgramIndex`` field, or
the JAX ``FmIndex``'s NumPy fields —
and return the port's objects holding the same bytes, so the two
packages can run on literally the same index. Nothing here imports
either JAX or the JAX package.
"""

from __future__ import annotations

from typing import Mapping, Optional

import numpy as np
import torch

from ..ops.ngram import NgramIndex, _geometry_pair
from .config import AlphabetType, IndexConfiguration
from .index import DeviceIndex, FmIndex, device_row_bytes64, u32_tensor, u64_tensor


def device_index_from_numpy(
    arrays: Mapping[str, Optional[np.ndarray]],
    *,
    bwt_length: int,
    ratio: int,
    k: int,
    alphabet,
    device,
) -> DeviceIndex:
    """A torch ``DeviceIndex`` from the JAX ``DeviceIndex``'s fields.

    ``arrays`` maps field names (``packed``, ``packed_pair``,
    ``prefix_sums``, ``seed_table``, ``sampled_sa``, ``code_masks``,
    ``vec_to_index``) to NumPy arrays; ``sampled_sa`` may be None
    (suffix array on disk), and so may ``packed_pair`` (a view without
    pair rows, the JAX package's ``AWFM_PAIR_ROWS=0``). u32 fields become
    int32 tensors holding the same bytes.
    """
    sa = arrays.get("sampled_sa")
    pair = arrays.get("packed_pair")
    return DeviceIndex(
        packed=torch.from_numpy(np.array(arrays["packed"], dtype=np.uint8)).to(device),
        packed_pair=None if pair is None else torch.from_numpy(
            np.array(pair, dtype=np.uint8)
        ).to(device),
        prefix_sums=u32_tensor(arrays["prefix_sums"], device),
        seed_table=u32_tensor(arrays["seed_table"], device),
        sampled_sa=None if sa is None else u32_tensor(sa, device),
        code_masks=torch.from_numpy(
            np.array(arrays["code_masks"], dtype=np.uint8)
        ).to(device),
        vec_to_index=torch.from_numpy(
            np.array(arrays["vec_to_index"], dtype=np.int32)
        ).to(device),
        bwt_length=int(bwt_length),
        ratio=int(ratio),
        kmer_length_in_seed_table=int(k),
        alphabet=AlphabetType(int(alphabet)),
    )


def _join_u64(lo, hi) -> np.ndarray:
    """uint64 values from their low and high u32 halves."""
    return (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(lo).astype(np.uint64)


def wide_device_index_from_numpy(
    arrays: Mapping[str, Optional[np.ndarray]],
    *,
    bwt_length: int,
    ratio: int,
    k: int,
    alphabet,
    device,
    pair_fused: bool = True,
) -> DeviceIndex:
    """A wide torch ``DeviceIndex`` from the JAX ``DeviceIndex64``'s fields.

    ``arrays`` maps ``packed``, ``prefix_hi``, ``prefix_lo``,
    ``seed_table`` ((A^k, 4) u32 ``[s_lo, s_hi, e_lo, e_hi]``),
    ``sampled_sa`` ((n, 2) u32 ``[lo, hi]``, or None: suffix array on
    disk), ``code_masks`` and ``vec_to_index`` to NumPy arrays. The hi/lo
    pairs become u64 values in int64 tensors of the same bytes; the one
    row table of pair-fused rows serves as ``packed`` and
    ``packed_pair``. ``pair_fused=False``: the compact single-block rows
    (the JAX ``DeviceIndex64.pair_fused`` False, its ``AWFM_PAIR_ROWS=0``
    amino view), a view without pair rows (``packed_pair`` None).
    """
    alphabet = AlphabetType(int(alphabet))
    packed = np.array(arrays["packed"], dtype=np.uint8, order="C")
    want = device_row_bytes64(alphabet, pair_fused)
    if packed.ndim != 2 or packed.shape[1] != want:
        raise ValueError(f"wide rows must be (nb, {want}), got {packed.shape}")
    seed = np.asarray(arrays["seed_table"])
    if seed.ndim != 2 or seed.shape[1] != 4:
        raise ValueError(f"wide seed table must be (rows, 4) u32, got {seed.shape}")
    sa = arrays.get("sampled_sa")
    rows = torch.from_numpy(packed).to(device)
    return DeviceIndex(
        packed=rows,
        packed_pair=rows if pair_fused else None,
        prefix_sums=u64_tensor(_join_u64(arrays["prefix_lo"], arrays["prefix_hi"]), device),
        seed_table=u64_tensor(
            np.stack([_join_u64(seed[:, 0], seed[:, 1]), _join_u64(seed[:, 2], seed[:, 3])], axis=1),
            device,
        ),
        sampled_sa=None if sa is None else u64_tensor(
            _join_u64(np.asarray(sa)[:, 0], np.asarray(sa)[:, 1]), device
        ),
        code_masks=torch.from_numpy(
            np.array(arrays["code_masks"], dtype=np.uint8)
        ).to(device),
        vec_to_index=torch.from_numpy(
            np.array(arrays["vec_to_index"], dtype=np.int32)
        ).to(device),
        bwt_length=int(bwt_length),
        ratio=int(ratio),
        kmer_length_in_seed_table=int(k),
        alphabet=alphabet,
        wide=True,
        pair_fused=bool(pair_fused),
    )


def ngram_index_from_numpy(pair, cn, *, n: int, biased: bool, device) -> NgramIndex:
    """A torch ``NgramIndex`` from the JAX ``NgramIndex``'s fields:
    ``np.asarray`` of its ``packed`` pair rows and its ``cn``, plus its
    ``n`` and ``biased`` flags. cn becomes an int32 tensor holding the
    same u32 bytes. On a CUDA device the index also carries K4's copy of
    the rows in its byte order (``NgramIndex.k4``)."""
    _, _, _, _, row_bytes = _geometry_pair(n)
    pair = np.array(pair, dtype=np.uint8, order="C")
    if pair.ndim != 2 or pair.shape[1] != row_bytes:
        raise ValueError(f"n={n} pair rows must be (nb, {row_bytes}), got {pair.shape}")
    if np.asarray(cn).shape != (4**n,):
        raise ValueError(f"n={n} cn must have {4**n} entries")
    return NgramIndex(
        packed=torch.from_numpy(pair).to(device),
        cn=u32_tensor(cn, device),
        n=int(n),
        biased=bool(biased),
    )


def fm_index_from_numpy(
    arrays: Mapping[str, Optional[np.ndarray]],
    *,
    bwt_length: int,
    ratio: int,
    k: int,
    alphabet,
    sequence: Optional[bytes] = None,
    sa_guard_bytes: bytes = b"\x00" * 8,
) -> FmIndex:
    """A host ``FmIndex`` from the JAX ``FmIndex``'s NumPy fields.

    ``arrays`` holds ``bwt_letters``, ``prefix_sums``,
    ``kmer_seed_table`` and ``sampled_sa`` (either of the last two may
    be None: no seed table yet, or the suffix array on disk). The
    original ``sequence`` is stored when given, as serde needs it.
    """
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=int(ratio),
        kmer_length_in_seed_table=int(k),
        alphabet_type=AlphabetType(int(alphabet)),
        keep_suffix_array_in_memory=arrays.get("sampled_sa") is not None,
        store_original_sequence=sequence is not None,
    )

    def u64(name):
        a = arrays.get(name)
        return None if a is None else np.array(a, dtype=np.uint64)

    return FmIndex(
        config=cfg,
        bwt_length=int(bwt_length),
        bwt_letters=np.array(arrays["bwt_letters"], dtype=np.uint8),
        prefix_sums=u64("prefix_sums"),
        kmer_seed_table=u64("kmer_seed_table"),
        sampled_sa=u64("sampled_sa"),
        sequence=sequence,
        sa_guard_bytes=bytes(sa_guard_bytes),
    )

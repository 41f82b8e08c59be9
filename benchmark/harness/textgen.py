"""The database texts, generated from a configuration's ``text`` block.

A configuration's database is fixed by its own ``data_seed``, as a
deployment serves one database; ``--seed`` makes only the traffic.
Every generator returns upper-case ASCII letters of the alphabet and
no other byte, so the index and the reference read the same text.

Generators (``text.generator``):

  uniform   ``bases`` letters drawn uniformly from ``letters``;
  proteins  ``proteins`` sequences with log-normal lengths (mean
            ``mean_length``, shape ``length_sigma``, clipped to
            [``min_length``, ``max_length``]) and residues drawn from
            ``composition`` (percent, two decimals each);
  repeats   a uniform text of ``bases`` letters in which copies of one
            random family of ``family_length`` letters, each letter
            changed with probability ``divergence``, cover a share
            ``family_share`` of the text (an Alu-like repeat family).

Bump ``VERSION`` whenever a generator's output for the same block
changes: the index cache is keyed on it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

VERSION = 1


@dataclasses.dataclass
class Text:
    ascii: np.ndarray  # (n,) uint8 upper-case letters
    ends: Optional[np.ndarray] = None  # (records,) int64 cumulative record ends


def generate(block: dict) -> Text:
    kind = block["generator"]
    rng = np.random.default_rng(int(block["data_seed"]))
    if kind == "uniform":
        return Text(_uniform(rng, int(block["bases"]), block["letters"]))
    if kind == "proteins":
        return _proteins(rng, block)
    if kind == "repeats":
        return Text(_repeats(rng, block))
    raise ValueError(f"unknown text generator {kind!r}")


def _uniform(rng, n: int, letters: str) -> np.ndarray:
    lut = np.frombuffer(letters.upper().encode(), dtype=np.uint8)
    return lut[rng.integers(0, len(lut), size=n, dtype=np.uint8)]


def composition_lut(composition: dict) -> np.ndarray:
    """One byte per hundredth of a percent: a draw of an index below the
    table's length picks each letter at its stated share exactly."""
    parts = [np.full(int(round(float(p) * 100)), ord(a.upper()), dtype=np.uint8)
             for a, p in composition.items()]
    return np.concatenate(parts)


def _proteins(rng, block: dict) -> Text:
    n = int(block["proteins"])
    sigma = float(block["length_sigma"])
    mu = np.log(float(block["mean_length"])) - sigma * sigma / 2
    lengths = np.clip(np.rint(rng.lognormal(mu, sigma, size=n)),
                      int(block["min_length"]), int(block["max_length"])).astype(np.int64)
    lut = composition_lut(block["composition"])
    residues = lut[rng.integers(0, len(lut), size=int(lengths.sum()), dtype=np.uint16)]
    return Text(residues, np.cumsum(lengths))


def _repeats(rng, block: dict) -> np.ndarray:
    n = int(block["bases"])
    letters = block["letters"]
    text = _uniform(rng, n, letters)
    fam_len = int(block["family_length"])
    family = _uniform(rng, fam_len, letters)
    copies = int(float(block["family_share"]) * n) // fam_len
    if copies == 0:
        return text
    slot = n // copies
    if slot < fam_len:
        raise ValueError("family_share too high for non-overlapping copies")
    starts = np.arange(copies, dtype=np.int64) * slot + rng.integers(0, slot - fam_len + 1, size=copies)
    block_copies = np.broadcast_to(family, (copies, fam_len)).copy()
    changed = rng.random((copies, fam_len)) < float(block["divergence"])
    block_copies[changed] = _uniform(rng, int(changed.sum()), letters)
    text[(starts[:, None] + np.arange(fam_len)).ravel()] = block_copies.ravel()
    return text


def write_fasta(text: Text, path: str, width: int = 60) -> None:
    """One record per sequence (``>seq<i>``), lines of ``width``
    letters: the FASTA a build reads back into the same concatenation."""
    ends = text.ends if text.ends is not None else np.array([len(text.ascii)])
    starts = np.concatenate([[0], ends[:-1]])
    buf = text.ascii.tobytes()
    with open(path, "wb") as fh:
        for i, (s, e) in enumerate(zip(starts.tolist(), ends.tolist())):
            seq = buf[s:e]
            lines = b"\n".join(seq[j:j + width] for j in range(0, len(seq), width))
            fh.write(b">seq%d\n%s\n" % (i, lines))

"""The general traffic generator: a traffic file's parameters to a pool
of query batches, from ``--seed``.

Keys of a traffic file (``benchmark/traffic/<name>.json``):

  op            ``count`` or ``locate``;
  source        ``text_kmers``: windows of ``length`` letters at uniform
                starts of the text (``yardstick.kmer_starts``);
                ``tryptic_peptides``: the text's records cut after
                ``cleave_after`` letters unless the next is in
                ``not_before``, and at record ends, keeping the pieces of
                ``min_length`` to ``max_length`` letters, drawn uniformly;
  batch         queries a request;
  pool          distinct batches, served in turn;
  columns       letter columns a batch is padded to (0: the longest
                query rounded up to ``pad_to``, 4 by default).

A key the generator does not know is refused, so that a file never asks
for traffic that the harness does not make. Every request is sent by one
client in a closed loop: the next when the answers of the last one are
in host memory.

Every seed draws the same sizes (batch, pool, columns): only which
windows or peptides follow the seed.
The draws are NumPy's (``default_rng(seed)``), so a seed gives the same
queries on any device; the windows are gathered from the text where it
lies, on the card in a run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import yardstick


@dataclasses.dataclass
class Batch:
    ascii: torch.Tensor  # (batch, columns) uint8; 0 past each query's length
    lengths: torch.Tensor  # (batch,) int32


def _any_of(a: torch.Tensor, letters: str) -> torch.Tensor:
    out = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    for c in letters.encode():
        out |= a == c
    return out


def digest(text: torch.Tensor, ends, cleave_after: str, not_before: str, min_length: int,
           max_length: int):
    """(starts, lengths) int64 of every piece of the records of ``text``
    (uint8; records end at ``ends``, None: one record) cut after a
    ``cleave_after`` letter whose next letter is not in ``not_before``,
    and at each record end, kept when its length lies in [min_length,
    max_length]."""
    n = text.shape[0]
    ends = (torch.tensor([n]) if ends is None else torch.as_tensor(ends)).to(text.device, torch.int64)
    cut = _any_of(text, cleave_after)
    cut[:-1] &= ~_any_of(text[1:], not_before)
    bounds = torch.unique(torch.cat([torch.nonzero(cut)[:, 0] + 1, ends]))
    starts = torch.cat([bounds.new_zeros(1), bounds[:-1]])
    lengths = bounds - starts
    keep = (lengths >= min_length) & (lengths <= max_length)
    return starts[keep], lengths[keep]


def _columns(spec: dict, longest: int) -> int:
    cols = int(spec.get("columns", 0))
    if cols:
        if cols < longest:
            raise ValueError(f"columns {cols} < longest query {longest}")
        return cols
    pad = int(spec.get("pad_to", 4))
    return -(-longest // pad) * pad


KEYS = {
    "text_kmers": {"op", "source", "length", "batch", "pool", "columns", "pad_to"},
    "tryptic_peptides": {"op", "source", "cleave_after", "not_before", "min_length",
                         "max_length", "batch", "pool", "columns", "pad_to"},
}


def check(spec: dict) -> None:
    """Refuse a traffic file with a source, an op or a key that the
    generator does not know."""
    known = KEYS.get(spec.get("source"))
    if known is None:
        raise ValueError(f"unknown traffic source {spec.get('source')!r}")
    if spec.get("op") not in ("count", "locate"):
        raise ValueError(f"unknown traffic op {spec.get('op')!r}")
    unknown = sorted(set(spec) - known)
    if unknown:
        raise ValueError(f"traffic keys the generator does not know: {unknown}")


def make_pool(spec: dict, text: torch.Tensor, ends, seed: int):
    """The pool of ``spec["pool"]`` batches drawn from ``seed``, on the
    device of ``text`` (uint8 letters; ``ends``: record ends or None)."""
    check(spec)
    rng = np.random.default_rng(int(seed))
    device = text.device
    batch = int(spec["batch"])
    source = spec["source"]
    n = text.shape[0]
    if source == "text_kmers":
        width = int(spec["length"])
        lengths = torch.full((batch,), width, dtype=torch.int32, device=device)
    elif source == "tryptic_peptides":
        p_starts, p_lens = digest(text, ends, spec["cleave_after"], spec["not_before"],
                                  int(spec["min_length"]), int(spec["max_length"]))
        if p_starts.numel() == 0:
            raise ValueError("the digest keeps no peptide")
        width = int(spec["max_length"])
    cols = _columns(spec, width)
    padded = torch.cat([text, text.new_zeros(width)])
    pool = []
    for _ in range(int(spec["pool"])):
        if source == "text_kmers":
            starts = torch.from_numpy(yardstick.kmer_starts(rng, n, width, batch)).to(device)
        else:
            pick = torch.from_numpy(rng.integers(0, p_starts.numel(), size=batch)).to(device)
            starts, lengths = p_starts[pick], p_lens[pick].to(torch.int32)
        mat = torch.zeros((batch, cols), dtype=torch.uint8, device=device)
        for j in range(width):
            col = padded[starts + j]
            mat[:, j] = col if source == "text_kmers" else torch.where(lengths > j, col, 0)
        pool.append(Batch(mat, lengths.clone()))
    return pool

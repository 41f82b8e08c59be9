"""Plain reference for exact-match count and locate over a text.

Works from the text and the queries alone, as ASCII bytes: no index,
no suffix array, nothing of the program under test. Every window of
``prefix`` letters of the text gets an exact integer key (its letters
as digits in base |alphabet|); the keys are sorted stably, so equal
keys keep their positions in ascending order. A query's candidates are
the windows whose key equals the key of its first ``prefix`` letters;
each candidate is kept when the query's remaining letters equal the
text's there. A query's count is the number kept and its hits are their
positions, ascending.

Letters outside the alphabet (upper or lower case) take part in no
match, in the text or in a query. Runs on whatever device the tensors
it is given live on; queries are answered in blocks, so the peak is the
sort's.
"""

from __future__ import annotations

import torch

LETTERS = {"dna": b"ACGT", "amino": b"ACDEFGHIKLMNPQRSTVWY"}
# the longest prefix whose base-|alphabet| key fits a signed 64-bit integer
MAX_PREFIX = {"dna": 31, "amino": 14}


def letter_lut(alphabet: str, device) -> torch.Tensor:
    """(256,) int64: ASCII byte -> letter number, -1 outside the alphabet."""
    lut = torch.full((256,), -1, dtype=torch.int64)
    for i, c in enumerate(LETTERS[alphabet]):
        lut[c] = i
        lut[ord(chr(c).lower())] = i
    return lut.to(device)


class WindowTable:
    """The sorted keys of every ``prefix``-letter window of ``text``."""

    def __init__(self, text: torch.Tensor, alphabet: str, prefix: int):
        if not 1 <= prefix <= MAX_PREFIX[alphabet]:
            raise ValueError(f"prefix must be in [1, {MAX_PREFIX[alphabet]}]")
        self.alphabet = alphabet
        self.card = len(LETTERS[alphabet])
        self.prefix = prefix
        self.codes = letter_lut(alphabet, text.device)[text.to(torch.int64)]
        n = self.codes.shape[0]
        self.n = n
        windows = n - prefix + 1
        if windows <= 0:
            self.keys = torch.empty(0, dtype=torch.int64, device=text.device)
            self.order = self.keys
            return
        key = torch.zeros(windows, dtype=torch.int64, device=text.device)
        bad = torch.zeros(windows, dtype=torch.bool, device=text.device)
        for j in range(prefix):
            c = self.codes[j:j + windows]
            key.mul_(self.card).add_(c.clamp(min=0))
            bad |= c < 0
        key[bad] = -1
        del bad
        self.keys, self.order = torch.sort(key, stable=True)

    def _query_keys(self, codes: torch.Tensor):
        key = torch.zeros(codes.shape[0], dtype=torch.int64, device=codes.device)
        bad = torch.zeros(codes.shape[0], dtype=torch.bool, device=codes.device)
        for j in range(self.prefix):
            key = key * self.card + codes[:, j].clamp(min=0)
            bad |= codes[:, j] < 0
        return torch.where(bad, torch.full_like(key, -2), key)

    def answer(self, queries: torch.Tensor, lengths: torch.Tensor, block: int = 1 << 20):
        """(counts (B,) int64, hits int64 grouped by query, ascending
        within a query) for ASCII ``queries`` (B, columns) of
        ``lengths`` (B,) letters, each at least ``prefix``."""
        lengths = lengths.to(torch.int64)
        if queries.shape[0] and int(lengths.min()) < self.prefix:
            raise ValueError("every query needs at least `prefix` letters")
        counts, hits = [], []
        for lo in range(0, queries.shape[0], block):
            c, h = self._answer_block(queries[lo:lo + block], lengths[lo:lo + block])
            counts.append(c)
            hits.append(h)
        if not counts:
            z = torch.zeros(0, dtype=torch.int64, device=self.keys.device)
            return z, z
        return torch.cat(counts), torch.cat(hits)

    def _answer_block(self, queries, lengths):
        device = self.keys.device
        lut = letter_lut(self.alphabet, device)
        codes = lut[queries.to(device).to(torch.int64)]
        lengths = lengths.to(device)
        b = codes.shape[0]
        qkey = self._query_keys(codes)
        lo = torch.searchsorted(self.keys, qkey, right=False)
        hi = torch.searchsorted(self.keys, qkey, right=True)
        ncand = hi - lo
        total = int(ncand.sum())
        qid = torch.repeat_interleave(torch.arange(b, device=device), ncand, output_size=total)
        first = torch.cumsum(ncand, 0) - ncand
        pos = self.order[lo[qid] + torch.arange(total, device=device) - first[qid]]
        qlen = lengths[qid]
        ok = pos + qlen <= self.n
        for j in range(self.prefix, int(lengths.max()) if b else 0):
            need = j < qlen
            at = (pos + j).clamp(max=self.n - 1)
            same = (self.codes[at] == codes[qid, j]) & (codes[qid, j] >= 0)
            ok &= ~need | same
        counts = torch.bincount(qid[ok], minlength=b)
        return counts, pos[ok]

"""The comparison that decides ``correct``: exact, query by query."""

from __future__ import annotations

import torch


def _sorted_keys(qid: torch.Tensor, hits: torch.Tensor, scale: int) -> torch.Tensor:
    return torch.sort(qid * scale + hits).values


def compare_answers(ref_counts, ref_hits, counts, hits, hit_counts):
    """(queries whose count differs, queries whose hits differ as sets).

    ``ref_counts`` / ``ref_hits``: the reference's counts and hits,
    grouped by query. ``counts``: the program's count of each query;
    ``hits``: its hits grouped by query, ``hit_counts`` of them a query
    (its counts, unless it returned fewer hits than it counted). All on
    one device."""
    count_wrong = int((counts != ref_counts).sum())
    b = ref_counts.shape[0]
    device = ref_counts.device
    same_len = hit_counts == ref_counts
    q = torch.arange(b, device=device)
    p_qid = torch.repeat_interleave(q, hit_counts, output_size=int(hit_counts.sum()))
    r_qid = torch.repeat_interleave(q, ref_counts, output_size=int(ref_counts.sum()))
    keep_p, keep_r = same_len[p_qid], same_len[r_qid]
    p_qid, p_hits = p_qid[keep_p], hits[keep_p]
    r_qid, r_hits = r_qid[keep_r], ref_hits[keep_r]
    wrong = int((~same_len).sum())
    if p_hits.numel():
        # a program hit outside the reference's range matches none of its hits
        top = int(r_hits.max()) + 1
        p_hits = torch.where((p_hits < 0) | (p_hits > top), torch.full_like(p_hits, top), p_hits)
        scale = top + 1
        if scale * b >= 2**62:
            raise ValueError("positions too large to key by query")
        pk = _sorted_keys(p_qid, p_hits, scale)
        rk = _sorted_keys(r_qid, r_hits, scale)
        bad = pk != rk
        wrong += int(torch.unique(torch.div(rk[bad], scale, rounding_mode="floor")).numel())
    return count_wrong, wrong

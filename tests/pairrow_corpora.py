"""The window-class corpora on which K2 and K4's pair forms are held to
their plain versions: ``chip_smoke.py``'s ``pairless_corpora`` (runs of one
letter in random text), cut into the forms below. The module imports
nothing of JAX, so the card tests that use it run without it
(``tests/test_torch_pairrow_steps.py``); ``tests/test_torch_window_classes.py``
holds the plain versions to the JAX package on the same inputs.
"""

from __future__ import annotations

import torch

import avxwindowfmindex_tpu_torch as pt
from avxwindowfmindex_tpu_torch import search
from avxwindowfmindex_tpu_torch.ops import ngram as ngram_ops

# K2: the DNA corpus's 41-mers and their last 29 letters (letters read from
# memory and in registers), the amino corpus; K4: n = 2 and 3 on both lengths
FORMS = ["k2-dna-41", "k2-dna-29", "k2-amino", "k4-n2-41", "k4-n3-41", "k4-n2-29", "k4-n3-29"]


def corpus_text(form: str):
    """(text, seed k, alphabet) of a form's corpus."""
    import chip_smoke

    text, _, _, aa_text, _ = chip_smoke.pairless_corpora()
    if form == "k2-amino":
        return aa_text, chip_smoke.PAIRLESS_AMINO_SEED_K, pt.AlphabetType.AMINO
    return text, 6, pt.AlphabetType.DNA


def corpus_inputs(form: str, index, device):
    """(view with pair rows, n-gram index or None, queries, inputs) of a
    form over ``index`` (built from :func:`corpus_text` at SA ratio 8):
    K2's (mat, lengths, seeded) or K4's (mat, kmer_len), on ``device``."""
    import chip_smoke
    from avxwindowfmindex_tpu_torch.tools.kernel_ab import lengthwise_batch

    _, k4_qs, klen, _, aa_qs = chip_smoke.pairless_corpora()
    view = index.to_device(device, pair_rows=True)
    length = int(form.split("-")[-1]) if form != "k2-amino" else None
    if form.startswith("k2"):
        qs = aa_qs if length is None else [q[-length:] for q in k4_qs]
        eng = pt.SearchEngine(view, device=device)
        mat, lengths, _ = eng.encode_kmers(qs)
        seeded = eng._seed_eligibility(mat, lengths)
        args = (torch.from_numpy(mat).to(device), torch.from_numpy(lengths).to(device),
                torch.from_numpy(seeded.astype("uint8")).to(device))
        return view, None, qs, args
    n = int(form.split("-")[1][1:])
    ng = ngram_ops.build_ngram_device(index, n, device=device)
    mat = torch.from_numpy(pt.SearchEngine(view, device=device).encode_kmers(k4_qs)[0]).to(device)
    if length != klen:
        mat = lengthwise_batch(mat, klen, length)[0]
    return view, ng, [q[-length:] for q in k4_qs], (mat, length)


def plain(view, ng, args):
    """(start, end, window classes of the single steps) by the plain version."""
    if ng is None:
        classes = torch.zeros(3, dtype=torch.int64, device=args[0].device)
        start, end = search.ranges_plain(view, *args, classes)
        return start, end, classes
    by_table = search.new_step_classes(args[0].device)
    start, end = search.ngram_ranges_plain(view, ng, *args, by_table)
    return start, end, by_table["pair"]

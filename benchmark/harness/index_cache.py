"""The index a configuration serves: built once in a checkout, loaded
by every later run.

The first run builds the index from the generated text (``build_from``
``sequence``: ``create_index``; ``fasta``: the text written as a FASTA
and read back by ``create_index_from_fasta``) and saves it as an
``.awfmx`` artifact under ``<bench>/.cache/<config>-g<generator
version>/``, beside the n-gram rows. A stamp written last names what
was built (the configuration's index keys and the text's CRC-32); a
later run whose stamp differs rebuilds. Loading rebuilds the seed table
on the card (``load_artifact``); the n-gram rows load from their file
(``build_ngram_device(cache_path=)``).
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import time
import zlib

from . import textgen

INDEX_KEYS = ("alphabet", "text", "seed_k", "sa_ratio", "device_sa_ratio", "build_from")


def _log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def stamp_of(config: dict, text) -> dict:
    s = {k: config.get(k) for k in INDEX_KEYS}
    s["textgen"] = textgen.VERSION
    s["crc32"] = zlib.crc32(memoryview(text.ascii))
    s["letters"] = int(len(text.ascii))
    return s


def prepare(config: dict, text, device, cache_root: str):
    """(host index, device view, n-gram table or None) for ``config``
    over ``text`` on ``device``."""
    import avxwindowfmindex_tpu_torch as awfm
    from avxwindowfmindex_tpu_torch.io import artifact

    d = os.path.join(cache_root, f"{config['name']}-g{textgen.VERSION}")
    art = os.path.join(d, "index.awfmx")
    stamp_path = os.path.join(d, "stamp.json")
    stamp = stamp_of(config, text)
    pair_rows = bool(config.get("pair_rows", True))
    old = None
    if os.path.exists(stamp_path):
        with open(stamp_path) as fh:
            old = json.load(fh)
    t0 = time.perf_counter()
    if old == stamp and os.path.exists(art):
        index = awfm.load_artifact(art, device=device, pair_rows=pair_rows)
        _log(f"index loaded from {art} in {time.perf_counter() - t0:.3f}s")
    else:
        shutil.rmtree(d, ignore_errors=True)
        os.makedirs(d)
        cfg = awfm.IndexConfiguration(
            alphabet_type=(awfm.AlphabetType.AMINO if config["alphabet"] == "amino"
                           else awfm.AlphabetType.DNA),
            kmer_length_in_seed_table=int(config["seed_k"]),
            suffix_array_compression_ratio=int(config["sa_ratio"]),
        )
        dense = config.get("device_sa_ratio")
        if config.get("build_from", "sequence") == "fasta":
            fasta = os.path.join(d, "db.fasta")
            textgen.write_fasta(text, fasta)
            index = awfm.create_index_from_fasta(fasta, cfg, device_sa_ratio=dense,
                                                 device=device, pair_rows=pair_rows)
            os.remove(fasta)
        else:
            index = awfm.create_index(text.ascii, cfg, device_sa_ratio=dense,
                                      device=device, pair_rows=pair_rows)
        _log(f"index built in {time.perf_counter() - t0:.3f}s")
        artifact.save_artifact(index, art + ".tmp", compress=False)
        os.replace(art + ".tmp", art)
        with open(stamp_path, "w") as fh:
            json.dump(stamp, fh)
    if index.bwt_length != len(text.ascii) + 1:
        raise RuntimeError("the index does not hold the generated text")
    dev = index.to_device(device, wide=config.get("wide"), pair_rows=pair_rows)
    ng = None
    n = config.get("ngram_n")
    if n and config["alphabet"] == "dna" and not dev.wide:
        t0 = time.perf_counter()
        ng = awfm.build_ngram_device(index, int(n), device=device,
                                     cache_path=os.path.join(d, f"ngram{int(n)}.npz"))
        _log(f"n = {n} table ready in {time.perf_counter() - t0:.3f}s")
    return index, dev, ng

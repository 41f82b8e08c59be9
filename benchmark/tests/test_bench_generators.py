"""The text and traffic generators repeat exactly per seed, and the
trypsin digest follows its rule."""

import numpy as np
import pytest
import torch

from benchmark.harness import textgen, traffic
from benchmark.tests.helpers import COMPOSITION, TINY_TRAFFIC

BLOCKS = {
    "uniform": {"generator": "uniform", "bases": 5000, "letters": "ACGT", "data_seed": 3},
    "proteins": {"generator": "proteins", "proteins": 40, "mean_length": 200, "length_sigma": 0.6,
                 "min_length": 2, "max_length": 2000, "composition": COMPOSITION, "data_seed": 4},
    "repeats": {"generator": "repeats", "bases": 20000, "letters": "ACGT", "family_length": 300,
                "family_share": 0.1, "divergence": 0.1, "data_seed": 5},
}


@pytest.mark.parametrize("kind", sorted(BLOCKS))
def test_text_repeats_per_seed(kind):
    a, b = textgen.generate(BLOCKS[kind]), textgen.generate(BLOCKS[kind])
    assert np.array_equal(a.ascii, b.ascii)
    other = textgen.generate(dict(BLOCKS[kind], data_seed=BLOCKS[kind]["data_seed"] + 1))
    assert not np.array_equal(a.ascii[:1000], other.ascii[:1000])
    letters = set(np.unique(a.ascii).tobytes())
    assert letters <= set(b"ACDEFGHIKLMNPQRSTVWY" if kind == "proteins" else b"ACGT")


def test_proteins_sizes_and_composition():
    block = dict(BLOCKS["proteins"], proteins=400)
    t = textgen.generate(block)
    assert len(t.ends) == 400 and t.ends[-1] == len(t.ascii)
    assert np.all(np.diff(np.concatenate([[0], t.ends])) >= 2)
    lut = textgen.composition_lut(COMPOSITION)
    assert len(lut) == 9989  # the percentages, two decimals, sum to 99.89
    share = np.mean(t.ascii == ord("L"))
    assert abs(share - 966 / 9989) < 0.01


def test_repeat_family_covers_its_share():
    block = BLOCKS["repeats"]
    t = textgen.generate(block).ascii
    base = textgen.generate(dict(block, generator="uniform")).ascii
    # the copies overwrite the uniform text: about 3 letters in 4 change
    changed = np.mean(t != base)
    assert 0.5 * 0.75 * block["family_share"] < changed < 1.5 * 0.75 * block["family_share"]


def _pool(spec, text, seed):
    return traffic.make_pool(spec, torch.from_numpy(text.ascii), text.ends, seed)


@pytest.mark.parametrize("name", sorted(TINY_TRAFFIC))
def test_pool_repeats_per_seed(name):
    text = textgen.generate(dict(BLOCKS["proteins"]) if name == "pep" else BLOCKS["uniform"])
    a = _pool(TINY_TRAFFIC[name], text, 2**31 + 5)
    b = _pool(TINY_TRAFFIC[name], text, 2**31 + 5)
    c = _pool(TINY_TRAFFIC[name], text, 2**31 + 6)
    assert len(a) == TINY_TRAFFIC[name]["pool"]
    for x, y, z in zip(a, b, c):
        assert torch.equal(x.ascii, y.ascii) and torch.equal(x.lengths, y.lengths)
        assert x.ascii.shape == z.ascii.shape  # every seed draws the same sizes
    assert not all(torch.equal(x.ascii, z.ascii) for x, z in zip(a, c))


def test_kmer_sampling_is_the_frozen_rule():
    text = textgen.generate(BLOCKS["uniform"])
    spec = dict(TINY_TRAFFIC["l10"], pool=1)
    got = _pool(spec, text, 9)[0]
    starts = np.random.default_rng(9).integers(0, len(text.ascii) - 10, size=spec["batch"])
    want = np.stack([text.ascii[s:s + 10] for s in starts])
    assert np.array_equal(got.ascii[:, :10].numpy(), want)
    assert not got.ascii[:, 10:].any() and (got.lengths == 10).all()


@pytest.mark.parametrize("change", [
    {"loop": "open"}, {"clients": 4}, {"mutate_share": 0.0625}, {"rate": 100.0},
    {"source": "bytes"}, {"op": "extract"},
])
def test_a_traffic_key_the_generator_does_not_know_is_refused(change):
    text = textgen.generate(BLOCKS["uniform"])
    with pytest.raises(ValueError):
        _pool(dict(TINY_TRAFFIC["l10"], **change), text, 9)


def _digest_plain(records, after, not_before, lo, hi):
    out = []
    for r in records:
        start = 0
        for i, c in enumerate(r):
            last = i == len(r) - 1
            if last or (c in after and r[i + 1] not in not_before):
                if lo <= i + 1 - start <= hi:
                    out.append(r[start:i + 1])
                start = i + 1
    return out


def test_trypsin_digest_rule():
    records = ["MAKPLLRAGGGKWWWWWWR", "PEPTIDEKAAAAAAARPKKLLLLLLLL", "KR", "GGGGGGGGGGGGGGGGGGGGGGGGGGGG"]
    text = textgen.Text(np.frombuffer("".join(records).encode(), dtype=np.uint8),
                        np.cumsum([len(r) for r in records]))
    t = torch.from_numpy(text.ascii.copy())
    starts, lengths = traffic.digest(t, text.ends, "KR", "P", 1, 25)
    buf = text.ascii.tobytes().decode()
    got = [buf[s:s + n] for s, n in zip(starts.tolist(), lengths.tolist())]
    assert got == _digest_plain(records, "KR", "P", 1, 25)
    # K before P is no cut; R at a record end is; pieces over the maximum are dropped
    assert "MAKPLLR" in got and "PEPTIDEK" in got and "AAAAAAARPK" in got
    assert all(len(p) <= 25 for p in got) and "G" * 28 not in got
    starts, lengths = traffic.digest(t, text.ends, "KR", "P", 7, 25)
    assert sorted(lengths.tolist()) == sorted(len(p) for p in got if len(p) >= 7)

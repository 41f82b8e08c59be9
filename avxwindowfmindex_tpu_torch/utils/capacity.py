"""Device-memory capacity planner: size an index configuration to the card.

Counterpart of ``avxwindowfmindex_tpu/utils/capacity.py``. The reference
documents this sizing guidance for its
users (seed-table memory against k, the suffix-array compression-ratio
trade, the in-memory SA); on a card the budget is its device memory and
the knobs are richer (digram table, dense device-side SA), so the
guidance becomes a planner:

    plan = plan_capacity(num_bases, AlphabetType.DNA, device="cuda:0")
    cfg  = plan.index_configuration()          # -> IndexConfiguration
    plan.seed_k, plan.device_sa_ratio, plan.ngram, plan.engine

Sizing model (byte counts exact: each equals the ``nbytes`` of the
port's tensor, and the JAX package's figure):

    packed       num_blocks x device_row_bytes        (backtrace rows)
    packed_pair  num_blocks x device_pair_row_bytes   (one-row steps)
                 wide: the one table of device_row_bytes64 rows stands
                 for both and is counted as ``packed``; without pair
                 rows, the compact wide rows (device_row_bytes64(pair=
                 False))
    ngram        num_blocks x pair-row bytes of the n-gram table
                 (nucleotide and narrow only — ops/ngram.py geometry)
    seed_table   |A|^k x 8 B narrow / 16 B wide
    sampled_sa   ceil(bwt/ratio) x 4 B narrow / 8 B wide, at the DENSER
                 of (config ratio, device_sa_ratio) when the dense SA is
                 on
    workspace    batch x (kmer_len + 96) B of live query/range buffers
                 + the measured peak of the port's bench beyond those

Degradation ladder when the rich configuration does not fit (the JAX
package's order): lower seed_k toward MIN_SEED_K, then drop the dense
device SA, then the digram table, then the pair rows.

Engine modes, in preference order (the JAX planner's):
    replicated     the index fits one card (``SearchEngine``, or the
                   query-parallel engine over several); a corpus of 2^32
                   positions and more gets a wide plan, which has no
                   n-gram candidate;
    range_sharded  ``n_devices > 1`` and the index exceeds one card but
                   fits the devices together: per-device bytes are the
                   sharded components split n ways plus the replicated
                   seed table (parallel/range_sharded.py); no n-gram
                   candidate.

The candidates are the JAX planner's, for both engines: pair rows
first, then, as the last resort, none (``pair_rows=False``: no narrow
pair table, the compact amino wide rows), which
``FmIndex.to_device(device, wide=plan.wide, pair_rows=plan.pair_rows)``
builds. The range-sharded engine holds only the block rows (narrow) or
the compact wide rows, so its plan with ``pair_rows`` on counts more
than the engine allocates; the figures follow the JAX planner's so that
both packages pick the same plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from ..models import alphabet as alpha
from ..models.config import AlphabetType

#: Largest seed k the planner will pick: the bench protocol's DNA k = 14
#: (a 2.1 GB table); amino 6 caps the table at 20^6 * 8 = 512 MB.
MAX_SEED_K = {AlphabetType.DNA: 14, AlphabetType.RNA: 14, AlphabetType.AMINO: 6}
MIN_SEED_K = {AlphabetType.DNA: 10, AlphabetType.RNA: 10, AlphabetType.AMINO: 2}

#: Device memory the port's bench held beyond its index tables during its
#: stages: ``torch.cuda.max_memory_allocated`` minus the index bytes, at
#: 64M bases and 4,194,304 queries (PERF.md; NVIDIA H100 80GB HBM3,
#: 700 W). It already holds the query buffers that the batch term counts
#: again, so the estimate errs large.
_WORKSPACE_SLACK_BYTES = 731_770_478

def detect_hbm_bytes(device) -> Tuple[int, str]:
    """Device memory of ``device``, (bytes, source-note).

    Reads ``torch.cuda.get_device_properties(device).total_memory``. A
    device without its own memory (the CPU) raises: pass ``hbm_bytes``
    to the planner instead, so that no figure is ever assumed.
    """
    import torch

    from ..models.index import as_device

    device = as_device(device)
    if device.type != "cuda":
        raise ValueError(
            f"cannot detect device memory on {device}; pass hbm_bytes"
        )
    props = torch.cuda.get_device_properties(device)
    return int(props.total_memory), f"detected {props.name}"


def component_bytes(
    num_bases: int,
    alphabet: AlphabetType = AlphabetType.DNA,
    *,
    seed_k: int,
    sa_ratio: int = 8,
    device_sa_ratio: Optional[int] = None,
    ngram: bool = False,
    ngram_n: int = 2,
    pair_rows: bool = True,
    wide: Optional[bool] = None,
) -> Dict[str, int]:
    """Exact per-component device bytes for one replicated index.
    ``wide`` defaults to what ``to_device`` picks (bwtLength >= 2^32)."""
    from ..models import index as index_mod

    bwt_length = num_bases + 1
    if wide is None:
        wide = bwt_length >= 2**32
    nb = index_mod.num_blocks_from_bwt_length(bwt_length)
    comp: Dict[str, int] = {}
    if wide:
        comp["packed"] = nb * index_mod.device_row_bytes64(alphabet, pair=pair_rows)
    else:
        comp["packed"] = nb * index_mod.device_row_bytes(alphabet)
        if pair_rows:
            comp["packed_pair"] = nb * index_mod.device_pair_row_bytes(alphabet)
    if ngram:
        if alphabet == AlphabetType.AMINO or wide:
            raise ValueError("the n-gram engine is nucleotide-only and narrow-only")
        from ..ops import ngram as ngram_ops

        comp["ngram"] = nb * ngram_ops._geometry_pair(ngram_n)[4]
    comp["seed_table"] = (alpha.cardinality(alphabet) ** seed_k) * (16 if wide else 8)
    ratio = device_sa_ratio if device_sa_ratio else sa_ratio
    comp["sampled_sa"] = -(-bwt_length // ratio) * (8 if wide else 4)
    return comp


def workspace_bytes(batch: int, kmer_len: int) -> int:
    """Estimated live non-index device bytes during a search batch."""
    return batch * (kmer_len + 96) + _WORKSPACE_SLACK_BYTES


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """A sized configuration; see the module docstring for the model."""

    num_bases: int
    alphabet: AlphabetType
    hbm_bytes: int
    n_devices: int
    engine: str  # "replicated" | "range_sharded"
    wide: bool
    seed_k: int
    sa_ratio: int
    device_sa_ratio: Optional[int]  # None = keep the config ratio
    ngram: bool
    ngram_n: int
    pair_rows: bool
    components: Dict[str, int]
    index_bytes: int
    per_chip_bytes: int  # the index's share resident on one device
    workspace: int
    budget: int  # fit_fraction * hbm - workspace
    fit_fraction: float
    notes: Tuple[str, ...]

    def index_configuration(self):
        from ..models.config import IndexConfiguration

        return IndexConfiguration(
            suffix_array_compression_ratio=self.sa_ratio,
            kmer_length_in_seed_table=self.seed_k,
            alphabet_type=self.alphabet,
        )

    def summary(self) -> str:
        gb = 1e9
        parts = ", ".join(
            f"{k}={v / gb:.2f}GB" for k, v in sorted(self.components.items())
        )
        return (
            f"{self.engine} engine ({self.n_devices} device"
            f"{'s' if self.n_devices != 1 else ''}, "
            f"{'wide' if self.wide else 'narrow'}): seed_k={self.seed_k}, "
            f"device_sa_ratio={self.device_sa_ratio}, "
            f"ngram={'on' if self.ngram else 'off'}, "
            f"pair_rows={'on' if self.pair_rows else 'off'}; "
            f"{self.per_chip_bytes / gb:.2f}GB/chip of "
            f"{self.budget / gb:.2f}GB budget ({parts})"
        )


def _candidates(alphabet, wide, max_k, min_k, dense_ratio):
    """Configs richest-first along the degradation ladder; a wide plan
    has no n-gram candidate."""
    ngram_ok = alphabet != AlphabetType.AMINO and not wide
    for ngram in ([True, False] if ngram_ok else [False]):
        for dense in ([dense_ratio, None] if dense_ratio else [None]):
            for k in range(max_k, min_k - 1, -1):
                yield dict(seed_k=k, device_sa_ratio=dense, ngram=ngram,
                           pair_rows=True)
    # last resorts: no pair rows
    for k in range(max_k, min_k - 1, -1):
        yield dict(seed_k=k, device_sa_ratio=None, ngram=False,
                   pair_rows=False)


def plan_capacity(
    num_bases: int,
    alphabet: AlphabetType = AlphabetType.DNA,
    *,
    device=None,
    hbm_bytes: Optional[int] = None,
    n_devices: int = 1,
    sa_ratio: int = 8,
    device_sa_ratio: Optional[int] = 4,
    batch: int = 1 << 22,
    kmer_len: int = 25,
    fit_fraction: float = 0.90,
    max_seed_k: Optional[int] = None,
    min_seed_k: Optional[int] = None,
    ngram_n: int = 2,
) -> CapacityPlan:
    """Pick seed_k / dense SA / digram / engine mode for the corpus.

    ``hbm_bytes`` defaults to the memory of ``device``
    (:func:`detect_hbm_bytes`). ``device_sa_ratio=None`` disables the
    dense-SA option; ``fit_fraction`` is the share of device memory the
    resident index may use after the workspace estimate is reserved.
    With ``n_devices > 1``, a corpus that no replicated plan fits gets a
    range-sharded plan, sized per device.
    """
    notes = []
    if hbm_bytes is None:
        if device is None:
            raise ValueError("pass device or hbm_bytes")
        hbm_bytes, src = detect_hbm_bytes(device)
        notes.append(f"device memory: {src}")
    bwt_length = num_bases + 1
    wide = bwt_length >= 2**32
    max_k = max_seed_k if max_seed_k is not None else MAX_SEED_K[alphabet]
    max_k = max(1, min(max_k, kmer_len))
    min_k = min_seed_k if min_seed_k is not None else MIN_SEED_K[alphabet]
    min_k = min(min_k, max_k)
    if device_sa_ratio and bwt_length // device_sa_ratio >= 2**31:
        notes.append(
            f"dense device SA at ratio {device_sa_ratio} exceeds the "
            "int32 sample-gather limit; disabled"
        )
        device_sa_ratio = None
    ws = workspace_bytes(batch, kmer_len)
    budget = int(fit_fraction * hbm_bytes) - ws
    if budget <= 0:
        raise ValueError(
            f"workspace estimate {ws} exceeds {fit_fraction:.0%} of device "
            f"memory ({hbm_bytes}); shrink the batch"
        )

    def build(cand, engine, chips):
        comp = component_bytes(
            num_bases, alphabet, sa_ratio=sa_ratio, ngram_n=ngram_n, wide=wide, **cand
        )
        total = sum(comp.values())
        if engine == "replicated":
            return comp, total, total
        # rows and SA split over the devices, the seed table on each
        sharded_bytes = total - comp["seed_table"]
        return comp, total, -(-sharded_bytes // chips) + comp["seed_table"]

    for engine in ("replicated", "range_sharded"):
        if engine == "range_sharded" and n_devices < 2:
            continue
        for cand in _candidates(alphabet, wide, max_k, min_k, device_sa_ratio):
            if engine == "range_sharded" and cand["ngram"]:
                continue  # the range-sharded rank steps one letter at a time
            comp, total, per_chip = build(cand, engine, n_devices)
            if per_chip <= budget:
                if engine == "range_sharded":
                    notes.append(
                        "index exceeds one chip's HBM; blocks+SA "
                        f"partitioned over {n_devices} devices"
                    )
                if wide:
                    notes.append("bwt >= 2^32: wide layout (u64 positions)")
                return CapacityPlan(
                    num_bases=num_bases, alphabet=alphabet, hbm_bytes=hbm_bytes,
                    n_devices=n_devices, engine=engine, wide=wide, sa_ratio=sa_ratio,
                    components=comp, index_bytes=total, per_chip_bytes=per_chip,
                    workspace=ws, budget=budget, fit_fraction=fit_fraction,
                    notes=tuple(notes), ngram_n=ngram_n, **cand,
                )
    # nothing fits: report the smallest configuration's shortfall
    comp, total, per_chip = build(
        dict(seed_k=min_k, device_sa_ratio=None, ngram=False, pair_rows=False),
        "range_sharded" if n_devices > 1 else "replicated", n_devices,
    )
    need = math.ceil((total - comp["seed_table"]) / max(budget - comp["seed_table"], 1))
    raise ValueError(
        f"no configuration fits: minimal index needs {per_chip / 1e9:.2f}"
        f"GB/chip against a {budget / 1e9:.2f}GB budget; "
        f"needs a >= {need}-device mesh (range-sharded) or a smaller "
        f"corpus/batch"
    )

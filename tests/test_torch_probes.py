"""Port parity: the gather-rate probes K5 and K6 against the Pallas kernels.

The Pallas probes P2-P5 live in measurement scripts that build their
kernels inside ``main()`` (or run it at import) and set a compilation
cache, so this file carries a verbatim copy of each kernel body, cited by
file and line, and runs it in Pallas interpret mode on the CPU at reduced
sizes. K5's and K6's plain versions (what their dispatch wrappers run on
CPU tensors, and what the kernels equal on the card) must give the same
integers: tolerance 0.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from avxwindowfmindex_tpu_torch.ops import kernels, probes
from avxwindowfmindex_tpu_torch.tools import gather_probe

import torch_helpers  # noqa: F401  (one torch thread per test worker)


def _p2_kernel(K, CHUNK, row_bytes):
    """experiments/pallas_gather_bench.py:89-129, verbatim."""

    def kernel(idx_ref, table_ref, out_ref):
        step = pl.program_id(0)

        def body(scratch, sems):
            def dma(slot, i):
                return pltpu.make_async_copy(
                    table_ref.at[pl.ds(idx_ref[i], 1), :],
                    scratch.at[slot],
                    sems.at[slot],
                )

            for s in range(K):
                dma(s, s).start()

            def loop(i, acc):
                slot = lax.rem(i, K)
                pltpu.make_async_copy(
                    table_ref.at[pl.ds(idx_ref[i], 1), :],
                    scratch.at[slot],
                    sems.at[slot],
                ).wait()
                acc = acc + jnp.sum(scratch[slot].astype(jnp.int32))

                @pl.when(i + K < CHUNK)
                def _():
                    dma(slot, i + K).start()

                return acc

            acc = lax.fori_loop(0, CHUNK, loop, jnp.int32(0))

            @pl.when(step == 0)
            def _():
                out_ref[0, 0] = jnp.int32(0)

            out_ref[0, 0] += acc

        pl.run_scoped(
            body,
            scratch=pltpu.VMEM((K, 1, row_bytes), jnp.uint8),
            sems=pltpu.SemaphoreType.DMA((K,)),
        )

    return kernel


def _p3_kernel(K, CHUNK):
    """experiments/pallas_aligned_bench.py:37-61, verbatim."""

    def kernel(idx_ref, table_ref, out_ref):
        step = pl.program_id(0)
        def body(scratch, sems):
            def dma(slot, i):
                return pltpu.make_async_copy(
                    table_ref.at[idx_ref[i]], scratch.at[slot], sems.at[slot])
            for s in range(K):
                dma(s, s).start()
            def loop(i, acc):
                slot = lax.rem(i, K)
                pltpu.make_async_copy(
                    table_ref.at[idx_ref[i]], scratch.at[slot], sems.at[slot]).wait()
                acc = acc + jnp.sum(scratch[slot][:1].astype(jnp.int32))
                @pl.when(i + K < CHUNK)
                def _():
                    dma(slot, i + K).start()
                return acc
            acc = lax.fori_loop(0, CHUNK, loop, jnp.int32(0))
            @pl.when(step == 0)
            def _():
                out_ref[0, 0] = jnp.int32(0)
            out_ref[0, 0] += acc
        pl.run_scoped(body, scratch=pltpu.VMEM((K, 8, 128), jnp.uint8),
                      sems=pltpu.SemaphoreType.DMA((K,)))

    return kernel


def _p4_kernel(K, CHUNK, row_bytes):
    """experiments/gather_pair_bench.py:137-176, verbatim."""

    def kernel(idx_ref, table_ref, out_ref):
        def body(scratch, sems):
            def dma(slot, i):
                return pltpu.make_async_copy(
                    table_ref.at[pl.ds(idx_ref[i], 1), :],
                    scratch.at[slot],
                    sems.at[slot],
                )

            for s in range(K):
                dma(s, s).start()

            def loop(i, acc):
                slot = lax.rem(i, K)
                pltpu.make_async_copy(
                    table_ref.at[pl.ds(idx_ref[i], 1), :],
                    scratch.at[slot],
                    sems.at[slot],
                ).wait()
                acc = acc + jnp.sum(
                    scratch[slot].astype(jnp.int32)
                )

                @pl.when(i + K < CHUNK)
                def _():
                    dma(slot, i + K).start()

                return acc

            acc = lax.fori_loop(0, CHUNK, loop, jnp.int32(0))
            out_ref[0, 0] = acc

        pl.run_scoped(
            body,
            scratch=pltpu.VMEM((K, 1, row_bytes), jnp.uint8),
            sems=pltpu.SemaphoreType.DMA((K,)),
        )

    return kernel


def _ring_call(kernel, table, idx, chunk, per_step):
    """The experiments' pallas_call (pallas_gather_bench.py:135-152,
    gather_pair_bench.py:178-199), in interpret mode."""
    steps = idx.shape[0] // chunk
    return pl.pallas_call(
        kernel,
        grid_spec=pltpu.PrefetchScalarGridSpec(
            num_scalar_prefetch=0,
            grid=(steps,),
            in_specs=[
                pl.BlockSpec((chunk,), lambda i: (i,), memory_space=pltpu.SMEM),
                pl.BlockSpec(memory_space=pl.ANY),
            ],
            out_specs=pl.BlockSpec(
                (1, 1), (lambda i: (i, 0)) if per_step else (lambda i: (0, 0)),
                memory_space=pltpu.SMEM,
            ),
        ),
        out_shape=jax.ShapeDtypeStruct((steps if per_step else 1, 1), jnp.int32),
        interpret=True,
    )(jnp.asarray(idx), jnp.asarray(table))


LANES = 128


def _k1_kernel(x_ref, idx_ref, out_ref):
    """experiments/ab_r5_pallas_gather.py:85-88, verbatim."""
    idx = idx_ref[:, :]  # (S, 128) i32 (pre-broadcast outside)
    out_ref[:, :] = jnp.take_along_axis(x_ref[:, :], idx, axis=0)


def _k1_call(x, idxb):
    """experiments/ab_r5_pallas_gather.py:91-100, in interpret mode."""
    s = x.shape[0]
    return pl.pallas_call(
        _k1_kernel,
        out_shape=jax.ShapeDtypeStruct((s, LANES), jnp.uint32),
        in_specs=[
            pl.BlockSpec(memory_space=pltpu.VMEM),
            pl.BlockSpec(memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(x, idxb)


def k1_chain(x, idx0, seg):
    """experiments/ab_r5_pallas_gather.py:103-112, verbatim."""
    s = x.shape[0]

    def body(i, idx):
        idxb = jnp.broadcast_to(idx[:, None], (s, LANES))
        rows = _k1_call(x, idxb)
        return ((rows[:, 0] + rows[:, 37]) % jnp.uint32(s)).astype(jnp.int32)

    idx = lax.fori_loop(0, seg, body, idx0)
    return jnp.sum(idx)


def _table(rng, nb, row_bytes, fill=None):
    if fill is not None:
        return np.full((nb, row_bytes), fill, dtype=np.uint8)
    return rng.integers(0, 256, size=(nb, row_bytes), dtype=np.uint8)


RING_CASES = [  # (table rows, row bytes, batch, K, CHUNK)
    (256, 128, 64, 2, 16),
    (1024, 512, 512, 4, 64),
    (4096, 128, 1024, 4, 128),
]


@pytest.mark.parametrize("nb,row_bytes,batch,ring,chunk", RING_CASES)
def test_k5_total_equals_p2(nb, row_bytes, batch, ring, chunk):
    rng = np.random.default_rng(nb + row_bytes)
    table = _table(rng, nb, row_bytes)
    idx = rng.integers(0, nb, size=batch, dtype=np.int32)
    want = int(np.asarray(_ring_call(_p2_kernel(ring, chunk, row_bytes), table, idx, chunk, False))[0, 0])
    partials = probes.gather_reduce(
        torch.from_numpy(table), torch.from_numpy(idx), sum_bytes=row_bytes, chunk=chunk, ring=ring
    )
    assert probes.wrapped_total(partials) == want


@pytest.mark.parametrize("nb,row_bytes,batch,ring,chunk", RING_CASES)
def test_k5_partials_equal_p4(nb, row_bytes, batch, ring, chunk):
    rng = np.random.default_rng(7 * nb + row_bytes)
    table = _table(rng, nb, row_bytes)
    idx = rng.integers(0, nb, size=batch, dtype=np.int32)
    want = np.asarray(_ring_call(_p4_kernel(ring, chunk, row_bytes), table, idx, chunk, True))[:, 0]
    got = probes.gather_reduce_plain(torch.from_numpy(table), torch.from_numpy(idx), row_bytes, chunk)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("ring,chunk", [(2, 32), (4, 64)])
def test_k5_first_128_bytes_equal_p3(ring, chunk):
    # P3's (nb, 8, 128) tiles are K5's 1 KB rows with sum_bytes = 128
    rng = np.random.default_rng(ring)
    nb, batch = 512, 256
    tiles = rng.integers(0, 256, size=(nb, 8, 128), dtype=np.uint8)
    idx = rng.integers(0, nb, size=batch, dtype=np.int32)
    want = int(np.asarray(_ring_call(_p3_kernel(ring, chunk), tiles, idx, chunk, False))[0, 0])
    rows = torch.from_numpy(tiles.reshape(nb, 1024))
    partials = probes.gather_reduce(rows, torch.from_numpy(idx), sum_bytes=128, chunk=chunk, ring=ring)
    assert probes.wrapped_total(partials) == want


def test_k5_total_wraps_as_int32():
    # 0xFF bytes: 8320 rows x 1024 B x 255 passes 2^31, so P2's int32
    # accumulator wraps; K5's wrapped total must wrap the same way
    nb, row_bytes, batch, chunk = 256, 1024, 8320, 128
    table = _table(None, nb, row_bytes, fill=0xFF)
    idx = np.random.default_rng(3).integers(0, nb, size=batch, dtype=np.int32)
    want = int(np.asarray(_ring_call(_p2_kernel(2, chunk, row_bytes), table, idx, chunk, False))[0, 0])
    assert want != batch * row_bytes * 255  # the reference wrapped
    partials = probes.gather_reduce_plain(torch.from_numpy(table), torch.from_numpy(idx), row_bytes, chunk)
    assert probes.wrapped_total(partials) == want


def test_k5_ragged_batch_and_clamped_index():
    # a batch that is not a chunk multiple gets a short last chunk; an
    # index past the table reads the last row, as XLA's gather clamps
    rng = np.random.default_rng(5)
    table = torch.from_numpy(_table(rng, 64, 256))
    idx = torch.tensor([0, 63, 64, 1000, -3, 5, 6], dtype=torch.int32)
    got = probes.gather_reduce_plain(table, idx, 256, 3)
    per_row = table.to(torch.int64).sum(1)
    clamped = [0, 63, 63, 63, 0, 5, 6]
    want = [int(per_row[clamped[i : i + 3]].sum()) for i in range(0, 7, 3)]
    assert got.tolist() == want


# (row bytes, sum bytes, K, CHUNK) of phase 3b: gather_probe's P2 and P3
PHASE_3B_CONFIGS = [(r, r, ring, chunk) for r, ring, chunk in gather_probe.P2_CONFIGS] + [
    (1024, 128, ring, chunk) for ring, chunk in gather_probe.P3_CONFIGS]


@pytest.mark.parametrize("row_bytes,sum_bytes,ring,chunk", PHASE_3B_CONFIGS)
def test_k5_phase_3b_shapes_equal_pallas(row_bytes, sum_bytes, ring, chunk):
    """K5's plain version at each of phase 3b's (row bytes, sum bytes, K,
    CHUNK): two whole chunks against P4's partials (P3's total for the
    1 KB rows), then a ragged third chunk whose indices include some past
    the table on both sides (clamped), against a numpy sum."""
    rng = np.random.default_rng(row_bytes + ring + chunk)
    nb = 64
    table = _table(rng, nb, row_bytes)
    full = rng.integers(0, nb, size=2 * chunk, dtype=np.int32)
    tail = np.concatenate([rng.integers(0, nb, size=chunk // 3 - 4, dtype=np.int32),
                           np.array([-1, -(2**31), nb, 2**31 - 1], dtype=np.int32)])
    got = probes.gather_reduce(torch.from_numpy(table), torch.from_numpy(np.concatenate([full, tail])),
                               sum_bytes=sum_bytes, chunk=chunk, ring=ring)
    assert got.shape == (3,) and got.dtype == torch.int32
    if sum_bytes == row_bytes:
        want = np.asarray(_ring_call(_p4_kernel(ring, chunk, row_bytes), table, full, chunk, True))[:, 0]
        np.testing.assert_array_equal(got[:2].numpy(), want)
    else:
        tiles = table.reshape(nb, 8, 128)
        want = int(np.asarray(_ring_call(_p3_kernel(ring, chunk), tiles, full, chunk, False))[0, 0])
        assert probes.wrapped_total(got[:2]) == want
    clamped = np.clip(tail.astype(np.int64), 0, nb - 1)
    tail_sum = int(table[clamped, :sum_bytes].astype(np.int64).sum())
    assert int(got[2]) == (tail_sum + 2**31) % 2**32 - 2**31


@pytest.mark.parametrize("seg", [1, 4, 20])
def test_k5_walk_equals_bench_formula(seg):
    """bench.py:212-228's walk, written in jnp and jitted (no routing)."""

    @jax.jit
    def walk(table, idx):
        nb = jnp.uint32(table.shape[0])
        for _ in range(seg):
            rows = table[idx]
            nxt = (
                idx.astype(jnp.uint32) * jnp.uint32(1103515245)
                + jnp.sum(rows.astype(jnp.uint32), axis=1)
                + jnp.uint32(12345)
            )
            idx = (nxt % nb).astype(jnp.int32)
        return idx

    rng = np.random.default_rng(seg)
    for nb, row_bytes in ((1000, 128), (777, 384)):
        table = _table(rng, nb, row_bytes)
        idx = rng.integers(0, nb, size=2048, dtype=np.int32)
        want = np.asarray(walk(jnp.asarray(table), jnp.asarray(idx)))
        got = probes.gather_walk(torch.from_numpy(table), torch.from_numpy(idx), seg)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mask", [0b010101010101, 0b000000000001, 0b101000000010],
                         ids=["first-block-visit", "one-sector", "scattered"])
def test_k5_masked_walk_equals_a_numpy_loop(mask):
    """The walk that reads and sums only the 32 B sectors in the mask,
    against the same recurrence written lane by lane in numpy."""
    rng = np.random.default_rng(mask)
    nb, row_bytes, seg = 777, 384, 5
    table = _table(rng, nb, row_bytes)
    idx = rng.integers(0, nb, size=300, dtype=np.int32)
    idx[:3] = [-4, nb, nb + 100]  # clamped
    want = []
    for x in np.clip(idx.astype(np.int64), 0, nb - 1):
        for _ in range(seg):
            total = sum(int(table[x, 32 * sec : 32 * sec + 32].sum())
                        for sec in range(row_bytes // 32) if (mask >> sec) & 1)
            x = ((int(x) * 1103515245 + total + 12345) % 2**32) % nb
        want.append(x)
    got = probes.gather_walk(torch.from_numpy(table), torch.from_numpy(idx), seg, mask)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    # it differs from the whole-row walk, which the all-sectors mask is
    whole = probes.gather_walk(torch.from_numpy(table), torch.from_numpy(idx), seg)
    assert not torch.equal(got, whole)
    assert torch.equal(
        whole, probes.gather_walk(torch.from_numpy(table), torch.from_numpy(idx), seg, 0xFFF)
    )
    assert probes.sector_columns(64, 0b10) == list(range(32, 64))


def test_k5_masked_walk_over_n3_ngram_rows():
    """The walk over 768 B rows (an n = 3 n-gram table, which the pairless
    models calibrate) with the n = 3 first-block mask: the same recurrence
    in numpy; the walk entry takes the width, the reduce does not."""
    from avxwindowfmindex_tpu_torch.utils import roofline

    mask = roofline.first_block_visits(ngram_n=3)["ngram_pair"][0]
    rng = np.random.default_rng(768)
    nb, row_bytes, seg = 301, 768, 4
    table = _table(rng, nb, row_bytes)
    idx = rng.integers(0, nb, size=200, dtype=np.int32)
    want = []
    for x in idx.astype(np.int64):
        for _ in range(seg):
            total = sum(int(table[x, 32 * sec : 32 * sec + 32].sum())
                        for sec in range(row_bytes // 32) if (mask >> sec) & 1)
            x = ((int(x) * 1103515245 + total + 12345) % 2**32) % nb
        want.append(x)
    got = probes.gather_walk(torch.from_numpy(table), torch.from_numpy(idx), seg, mask)
    np.testing.assert_array_equal(got.numpy(), np.array(want))
    assert 768 in probes.K5_WALK_ROW_BYTES and 768 not in probes.K5_ROW_BYTES
    assert set(probes.K5_ROW_BYTES) < set(probes.K5_WALK_ROW_BYTES)


@pytest.mark.parametrize("n", [1, 37])
def test_k6_ragged_batch_with_indices_out_of_range(n):
    """A batch that is no multiple of the kernel's tile of rows, some
    indices outside the slab: clamped to its first and last row."""
    rng = np.random.default_rng(n)
    x = rng.integers(-(2**31), 2**31, size=(64, LANES), dtype=np.int64).astype(np.int32)
    idx = rng.integers(-3, 70, size=n, dtype=np.int32)
    idx[0] = 66
    got = probes.slab_gather(torch.from_numpy(x), torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy(), x[np.clip(idx, 0, 63)])


@pytest.mark.parametrize("s", [64, 256])
def test_k6_single_equals_p5(s):
    rng = np.random.default_rng(s)
    x = rng.integers(0, 2**32, size=(s, LANES), dtype=np.uint32)
    idx = rng.integers(0, s, size=s, dtype=np.int32)
    want = np.asarray(_k1_call(jnp.asarray(x), jnp.broadcast_to(jnp.asarray(idx)[:, None], (s, LANES))))
    slab = torch.from_numpy(x.view(np.int32))
    got = probes.slab_gather(slab, torch.from_numpy(idx))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("s,seg", [(64, 1), (256, 5)])
def test_k6_chain_equals_k1_chain(s, seg):
    rng = np.random.default_rng(s + seg)
    x = rng.integers(0, 2**32, size=(s, LANES), dtype=np.uint32)
    idx = rng.integers(0, s, size=s, dtype=np.int32)
    want = int(np.asarray(k1_chain(jnp.asarray(x), jnp.asarray(idx), seg)))
    got = probes.slab_chain(torch.from_numpy(x.view(np.int32)), torch.from_numpy(idx), seg)
    assert int(got.to(torch.int64).sum()) == want
    # and step by step: each step is one P5 gather and k1_chain's update
    cur = jnp.asarray(idx)
    for _ in range(seg):
        rows = _k1_call(jnp.asarray(x), jnp.broadcast_to(cur[:, None], (s, LANES)))
        cur = ((rows[:, 0] + rows[:, 37]) % jnp.uint32(s)).astype(jnp.int32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(cur))


def test_kernel_launchers_refuse_cpu_tensors():
    # on a CPU tensor the dispatch wrappers run the plain version; the
    # launchers themselves only take CUDA tensors (nothing falls back)
    table = torch.zeros((16, 128), dtype=torch.uint8)
    idx = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k5_gather_reduce(table, idx, 128, 2, 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k5_gather_walk(table, idx, 1)
    slab = torch.zeros((16, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k6_slab_gather(slab, idx)
    with pytest.raises(ValueError, match="CUDA tensor"):
        kernels.k6_slab_chain(slab, idx, 1)
    assert kernels.K5.launches == 0 and kernels.K6.launches == 0


def test_k5_walk_refuses_lanes_it_has_no_form_for():
    """The walk takes 1 or 4 lanes a chain (four: the block rows' ceiling in
    ``tools.kernel_ab --cases pairless``, held to the plain walk on the card
    by ``chip_smoke.py`` phase 4p); another count is refused on the CPU
    too, where the plain version answers."""
    rng = np.random.default_rng(44)
    nb, row_bytes, seg, mask = 1000, 128, 6, 0b1111
    table = torch.from_numpy(_table(rng, nb, row_bytes))
    idx = torch.from_numpy(rng.integers(0, nb, size=257, dtype=np.int32))
    assert probes.K5_WALK_LANES == (1, 4)
    for lanes in (0, 2, 3, 8):
        with pytest.raises(ValueError, match="lanes"):
            probes.gather_walk(table, idx, seg, mask, lanes)

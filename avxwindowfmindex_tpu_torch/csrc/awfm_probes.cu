// Hand-written Hopper (sm_90a) gather-rate probes.
//
//   K5 awfm_k5_gather_reduce / awfm_k5_gather_walk
//       Replaces the Pallas row-gather probes experiments/
//       pallas_gather_bench.py:kernel (P2), pallas_aligned_bench.py:kernel
//       (P3) and gather_pair_bench.py:kernel (P4). Each index's row of a
//       uint8 table of R-byte rows is read, and the int32 sum of its first
//       sum_bytes bytes is added into one partial per CHUNK of indices
//       (P4's output; P2's and P3's scalar is the wrapping sum of the
//       partials). P2's ring of K row DMAs in flight becomes K 16 B pieces
//       in flight in each lane's registers. What bounds it on this card:
//       the bytes of random rows (P2: 524,288 x 128 B of a 1 GiB table,
//       0.020 ms at 3.35 TB/s). A first form copied every row whole into a
//       ring of shared-memory slots by cp.async (a warp instruction moved
//       one 128 B row, 8 of its 32 lanes busy) and read it back to sum it:
//       0.072 ms at P2's shape on the 1 GiB table and on a 64 MiB one
//       alike, so the per-row work and not device memory held it. What the
//       design does about it: L lanes take a row (the pieces summed,
//       rounded up to a power of two from 8 to 32), so one warp load
//       instruction moves 32 / L rows; only the pieces within sum_bytes
//       are loaded, non-allocating in L1 (ld.global.nc.L1::no_allocate),
//       straight into registers, K of them in flight a lane before the
//       first is summed; the grid is what the card holds at once, each
//       block owning whole chunks, so each partial has one writer and no
//       atomics. Against the first form in one process (H100 80GB HBM3,
//       700 W): P2's shape 0.029 ms at K = 16 (0.072), 0.026 at K = 8;
//       512 B rows 0.092 (0.113); P3's 1 KB rows, 128 B summed, 0.028
//       (0.226). The walk entry runs
//       bench.py's calibration walk, idx <- (idx * 1103515245 + sum of the
//       row's bytes + 12345) mod nb in u32, for seg steps in one launch,
//       one chain per lane, its vector loads of a row all in flight
//       together (or per 4 lanes, each loading a share of the row's
//       pieces: a warp load instruction then touches 8 rows; over the
//       L2-resident block rows four lanes a chain walk twice as fast as
//       one, the ceiling tools.kernel_ab sets K2 against). A
//       sector mask (bit s: the row's 32 B sector s) limits the
//       loads and the sum to the sectors a search step reads, so the walk
//       can measure the rate of visits that touch only those (the walk
//       also takes the 768 B rows of an n = 3 n-gram table, which
//       tools.kernel_ab's models calibrate). Every fraction of a ceiling
//       divides by the walk's rates, so the walk keeps its form.
//   K6 awfm_k6_slab_gather / awfm_k6_slab_chain
//       Replaces experiments/ab_r5_pallas_gather.py:_k1_kernel (P5):
//       out[i, :] = slab[idx[i], :] over a (S, 128) u32 slab of 1-4 MiB.
//       What bounds the single gather on this card: 4 MB in and 4 MB out
//       of the L2 take 2 us at the HBM rate, so it is a launch, and what
//       counts is how soon every load is in flight. The grid is sized to
//       the card (at most a few blocks per SM); a warp takes tiles of R
//       = 4 rows (8 measured a little behind at P5's 8,192 rows): lanes
//       0..R-1 read the tile's indices in one coalesced load, every lane
//       then starts its R independent 16 B loads (one warp moves one 512 B row
//       per load instruction) before its first store, and the stores are
//       streaming (st.global.cs), since nothing here reads them back. The
//       chained entry runs k1_chain's idx <- (row[0] + row[37]) mod S for
//       seg steps in one launch, one warp per lane, each step reading the
//       whole 512 B row (one 16 B volatile load per lane); it is the
//       calibration's slab rate and no library call computes it. The slab
//       stays in global memory, where it sits in the 50 MB L2: one block's
//       227 KB of shared memory cannot hold it, and the distributed shared
//       memory of a 16-block cluster, 16 x 227 KB = 3.6 MB, is smaller
//       than the 4 MiB slab the calibration uses.
//
// All four are bound by random row reads from device memory (K6: from L2)
// and do a few integer operations per 16 B. An index outside the table is
// clamped to the last row, as XLA's gather clamps.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avxwindowfmindex_tpu_torch/ops/kernels.py).
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

#include "awfm_common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxWarps = 8;          // warps per K5 reduce block

__device__ __forceinline__ uint32_t byte_sum(uint32_t x) {
  x = (x & 0x00FF00FFu) + ((x >> 8) & 0x00FF00FFu);
  return (x & 0xFFFFu) + (x >> 16);
}

__device__ __forceinline__ uint32_t byte_sum(const uint4& v) {
  return byte_sum(v.x) + byte_sum(v.y) + byte_sum(v.z) + byte_sum(v.w);
}

__device__ __forceinline__ int64_t clamp_row(int32_t i, int64_t nb) {
  const int64_t r = i;
  return r < 0 ? 0 : (r >= nb ? nb - 1 : r);
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// 16 B read once: no L1 line is allocated for it.
__device__ __forceinline__ uint4 ld_once(const uint8_t* p) {
  uint4 v;
  asm("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "l"(p));
  return v;
}

// K5's reduce. L lanes take a row (a power of two, 8 to 32), lane l its
// 16 B pieces l, l + L, ... below sum_pieces (PPL of them at most), so one
// warp load instruction moves 32 / L rows' pieces. Each lane asks for K
// pieces (K / PPL rows) before it sums the first, holding them in
// registers. Block b owns chunks b, b + gridDim.x, ...; a batch of its
// warps takes a chunk's rows in order (warp w's slot j: rows (j W + w)
// 32 / L ... of the batch, W warps), and the chunk's partial is summed
// over the block in a fixed order and written by one thread.
template <int L, int PPL, int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
k5_gather_reduce_kernel(const uint8_t* __restrict__ table, int64_t nb, int row_bytes,
                        const int32_t* __restrict__ idx, int64_t n, int chunk,
                        int sum_pieces, int32_t* __restrict__ out) {
  constexpr int kRowsPerLoad = 32 / L;
  constexpr int kSlots = K / PPL;  // rows a lane has in flight
  __shared__ uint32_t warp_sums[kMaxWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int sub = lane % L;      // the row's first piece this lane takes
  const int r_in = lane / L;     // the lane's row among a load's
  const int batch = n_warps * kSlots * kRowsPerLoad;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int64_t lo = c * chunk;
    const int rows = static_cast<int>(n - lo < chunk ? n - lo : chunk);
    uint32_t acc = 0u;
    for (int base = 0; base < rows; base += batch) {
      uint4 v[kSlots][PPL];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
        const int r = base + (j * n_warps + warp) * kRowsPerLoad + r_in;
        const bool live = r < rows;
        const uint8_t* src = table + (live ? clamp_row(idx[lo + r], nb) : 0) * row_bytes;
#pragma unroll
        for (int q = 0; q < PPL; ++q) {
          const int piece = sub + q * L;
          v[j][q] = make_uint4(0u, 0u, 0u, 0u);
          if (live && piece < sum_pieces) v[j][q] = ld_once(src + piece * 16);
        }
      }
#pragma unroll
      for (int j = 0; j < kSlots; ++j) {
#pragma unroll
        for (int q = 0; q < PPL; ++q) acc += byte_sum(v[j][q]);
      }
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      uint32_t t = 0u;
      for (int w = 0; w < n_warps; ++w) t += warp_sums[w];  // wraps as int32 does
      out[c] = static_cast<int32_t>(t);
    }
    __syncthreads();  // warp_sums is read before the next chunk writes it
  }
}

// MASKED false: every sector of the row, loaded unconditionally. L
// neighbouring lanes walk one chain (L = 1 or 4): lane sub loads pieces
// sub, sub + L, ... of the row, so one warp load instruction touches 32 / L
// rows, and the sum is taken over the L lanes by shuffle.
template <int R, bool MASKED, int L>
__global__ void k5_gather_walk_kernel(const uint8_t* __restrict__ table,
                                      int64_t nb, const int32_t* __restrict__ idx,
                                      int64_t n, int seg, uint32_t sector_mask,
                                      int32_t* __restrict__ out) {
  const int64_t i = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) / L;
  if (i >= n) return;  // the same in the L lanes of a chain, which alone shuffle
  const int lane = threadIdx.x & 31;
  const int sub = lane & (L - 1);
  const unsigned group = L == 1 ? 1u << lane : ((1u << L) - 1u) << (lane & ~(L - 1));
  const uint32_t rows = static_cast<uint32_t>(nb);
  uint32_t x = static_cast<uint32_t>(clamp_row(idx[i], nb));
  for (int s = 0; s < seg; ++s) {
    const uint4* row = reinterpret_cast<const uint4*>(table + static_cast<int64_t>(x) * R);
    uint32_t sum = 0u;
    if constexpr (!MASKED && L == 1) {
#pragma unroll
      for (int q = 0; q < R / 16; ++q) sum += byte_sum(__ldg(row + q));
    } else {
      // a lane's pieces, kBatch loaded before the first is summed: a load
      // under its mask bit and nothing else, so that the compiler predicates
      // it and the batch is in flight together
      constexpr int kMine = R / 16 / L;
      constexpr int kBatch = kMine <= 24 ? kMine : 16;
#pragma unroll
      for (int q0 = 0; q0 < kMine; q0 += kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          const int q = (q0 + j) * L + sub;
          if constexpr (MASKED) {
            v[j] = make_uint4(0u, 0u, 0u, 0u);
            if ((sector_mask >> (q / 2)) & 1u) v[j] = __ldg(row + q);
          } else {
            v[j] = __ldg(row + q);
          }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) sum += byte_sum(v[j]);
      }
    }
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) sum += __shfl_xor_sync(group, sum, o);
    x = (x * 1103515245u + sum + 12345u) % rows;
  }
  if (sub == 0) out[i] = static_cast<int32_t>(x);
}

constexpr int kK6BlocksPerSm = 4;  // the grid's cap: this many blocks per SM
constexpr int kK6Rows = 4;         // rows in flight per lane

// A warp takes tiles of R rows, tile w, w + (warps in the grid), ...: R
// loads in flight per lane, then R streaming stores.
__global__ void __launch_bounds__(kThreads)
k6_slab_gather_kernel(const uint4* __restrict__ slab, int64_t s,
                      const int32_t* __restrict__ idx, int64_t n,
                      uint4* __restrict__ out) {
  constexpr int R = kK6Rows;
  const int lane = threadIdx.x & 31;
  const int64_t warp = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int64_t n_warps = (gridDim.x * static_cast<int64_t>(blockDim.x)) >> 5;
  for (int64_t base = warp * R; base < n; base += n_warps * R) {
    int32_t mine = 0;
    if (lane < R && base + lane < n) mine = idx[base + lane];
    uint4 v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int32_t i = __shfl_sync(0xFFFFFFFFu, mine, r);
      if (base + r < n) v[r] = __ldg(slab + clamp_row(i, s) * 32 + lane);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (base + r < n) __stcs(out + (base + r) * 32 + lane, v[r]);
    }
  }
}

__device__ __forceinline__ uint4 ld_volatile(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__global__ void k6_slab_chain_kernel(const uint4* __restrict__ slab, int64_t s,
                                     const int32_t* __restrict__ idx, int64_t n,
                                     int seg, int32_t* __restrict__ out) {
  // one warp per lane of the chain; the warp index is uniform in a warp
  const int64_t w = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (w >= n) return;
  const uint32_t rows = static_cast<uint32_t>(s);
  uint32_t x = static_cast<uint32_t>(clamp_row(idx[w], s));
  for (int k = 0; k < seg; ++k) {
    const uint4 v = ld_volatile(slab + static_cast<int64_t>(x) * 32 + lane);
    const uint32_t w0 = __shfl_sync(0xFFFFFFFFu, v.x, 0);   // word 0
    const uint32_t w37 = __shfl_sync(0xFFFFFFFFu, v.y, 9);  // word 37 = 4 * 9 + 1
    x = (w0 + w37) % rows;
  }
  if (lane == 0) out[w] = static_cast<int32_t>(x);
}

unsigned int blocks_for(int64_t threads) {
  return static_cast<unsigned int>((threads + kThreads - 1) / kThreads);
}

cudaError_t launch_slab_gather(int device, const int32_t* slab, int64_t s,
                               const int32_t* idx, int64_t n, int32_t* out,
                               cudaStream_t stream) {
  static int sm_count[64] = {};  // per device, asked once
  int sms = device < 64 ? sm_count[device] : 0;
  if (sms == 0) {
    cudaError_t err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return err;
    if (device < 64) sm_count[device] = sms;
  }
  const int64_t tiles = (n + kK6Rows - 1) / kK6Rows;  // one per warp, until the grid is full
  const int64_t want = (tiles + kThreads / 32 - 1) / (kThreads / 32);
  const int64_t cap = static_cast<int64_t>(sms) * kK6BlocksPerSm;
  k6_slab_gather_kernel<<<static_cast<unsigned int>(want < cap ? want : cap), kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(slab), s, idx, n, reinterpret_cast<uint4*>(out));
  return cudaGetLastError();
}

// A mask that holds every sector of the row takes the whole-row walk.
template <int R, int L>
cudaError_t launch_walk_lanes(const uint8_t* table, int64_t nb, const int32_t* idx,
                              int64_t n, int seg, uint32_t sector_mask, int32_t* out,
                              cudaStream_t stream) {
  constexpr uint32_t kAll = R / 32 == 32 ? 0xFFFFFFFFu : (1u << (R / 32)) - 1u;
  if ((sector_mask & kAll) == kAll) {
    k5_gather_walk_kernel<R, false, L><<<blocks_for(n * L), kThreads, 0, stream>>>(
        table, nb, idx, n, seg, sector_mask, out);
  } else {
    k5_gather_walk_kernel<R, true, L><<<blocks_for(n * L), kThreads, 0, stream>>>(
        table, nb, idx, n, seg, sector_mask, out);
  }
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_walk(const uint8_t* table, int64_t nb, const int32_t* idx,
                        int64_t n, int seg, uint32_t sector_mask, int lanes, int32_t* out,
                        cudaStream_t stream) {
  switch (lanes) {
    case 1: return launch_walk_lanes<R, 1>(table, nb, idx, n, seg, sector_mask, out, stream);
    case 4: return launch_walk_lanes<R, 4>(table, nb, idx, n, seg, sector_mask, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

// A grid the card holds at once (at most one block a chunk), of blocks of
// enough warps to take a chunk in one batch, at most kMaxWarps.
template <int L, int PPL, int K>
cudaError_t launch_reduce(int device, const uint8_t* table, int64_t nb, int row_bytes,
                          const int32_t* idx, int64_t n, int chunk, int sum_pieces,
                          int32_t* out, cudaStream_t stream) {
  constexpr int kPerWarp = (K / PPL) * (32 / L);  // rows a warp has in flight
  const int64_t want = (static_cast<int64_t>(chunk) + kPerWarp - 1) / kPerWarp;
  const int warps = static_cast<int>(want < kMaxWarps ? want : kMaxWarps);
  int per_sm = 0, sms = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, k5_gather_reduce_kernel<L, PPL, K>, warps * 32, 0);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  const int64_t cap = static_cast<int64_t>(per_sm > 0 ? per_sm : 1) * sms;
  k5_gather_reduce_kernel<L, PPL, K>
      <<<static_cast<unsigned int>(n_chunks < cap ? n_chunks : cap), warps * 32, 0, stream>>>(
          table, nb, row_bytes, idx, n, chunk, sum_pieces, out);
  return cudaGetLastError();
}

template <int L, int PPL>
cudaError_t launch_reduce_ring(int ring, int device, const uint8_t* table, int64_t nb,
                               int row_bytes, const int32_t* idx, int64_t n, int chunk,
                               int sum_pieces, int32_t* out, cudaStream_t stream) {
  switch (ring) {
    case 2: return launch_reduce<L, PPL, 2>(device, table, nb, row_bytes, idx, n, chunk, sum_pieces, out, stream);
    case 4: return launch_reduce<L, PPL, 4>(device, table, nb, row_bytes, idx, n, chunk, sum_pieces, out, stream);
    case 8: return launch_reduce<L, PPL, 8>(device, table, nb, row_bytes, idx, n, chunk, sum_pieces, out, stream);
    case 16: return launch_reduce<L, PPL, 16>(device, table, nb, row_bytes, idx, n, chunk, sum_pieces, out, stream);
    case 32: return launch_reduce<L, PPL, 32>(device, table, nb, row_bytes, idx, n, chunk, sum_pieces, out, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int awfm_k5_gather_reduce(int device, const uint8_t* table, int64_t nb,
                          int row_bytes, const int32_t* idx, int64_t n,
                          int sum_bytes, int chunk, int ring, int32_t* out,
                          cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool width_ok = row_bytes == 128 || row_bytes == 256 || row_bytes == 384 ||
                        row_bytes == 512 || row_bytes == 1024;
  if (!width_ok || chunk < 1 || sum_bytes < 16 || sum_bytes > row_bytes || sum_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // lanes a row: the pieces summed, rounded up to a power of two in [8, 32]
  const int sp = sum_bytes / 16;
  if (sp <= 8) {
    err = launch_reduce_ring<8, 1>(ring, device, table, nb, row_bytes, idx, n, chunk, sp, out, stream);
  } else if (sp <= 16) {
    err = launch_reduce_ring<16, 1>(ring, device, table, nb, row_bytes, idx, n, chunk, sp, out, stream);
  } else if (sp <= 32) {
    err = launch_reduce_ring<32, 1>(ring, device, table, nb, row_bytes, idx, n, chunk, sp, out, stream);
  } else {
    err = launch_reduce_ring<32, 2>(ring, device, table, nb, row_bytes, idx, n, chunk, sp, out, stream);
  }
  return static_cast<int>(err);
}

int awfm_k5_gather_walk(int device, const uint8_t* table, int64_t nb,
                        int row_bytes, const int32_t* idx, int64_t n, int seg,
                        uint32_t sector_mask, int lanes, int32_t* out,
                        cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (row_bytes) {
    case 128: err = launch_walk<128>(table, nb, idx, n, seg, sector_mask, lanes, out, stream); break;
    case 256: err = launch_walk<256>(table, nb, idx, n, seg, sector_mask, lanes, out, stream); break;
    case 384: err = launch_walk<384>(table, nb, idx, n, seg, sector_mask, lanes, out, stream); break;
    case 512: err = launch_walk<512>(table, nb, idx, n, seg, sector_mask, lanes, out, stream); break;
    case 768: err = launch_walk<768>(table, nb, idx, n, seg, sector_mask, lanes, out, stream); break;
    case 1024: err = launch_walk<1024>(table, nb, idx, n, seg, sector_mask, lanes, out, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int awfm_k6_slab_gather(int device, const int32_t* slab, int64_t s,
                        const int32_t* idx, int64_t n, int32_t* out,
                        cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_slab_gather(device, slab, s, idx, n, out, stream));
}

int awfm_k6_slab_chain(int device, const int32_t* slab, int64_t s,
                       const int32_t* idx, int64_t n, int seg, int32_t* out,
                       cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  k6_slab_chain_kernel<<<blocks_for(n * 32), kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(slab), s, idx, n, seg, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

// Hand-written Hopper (sm_90a) gather-rate probes.
//
//   K5 awfm_k5_gather_reduce / awfm_k5_gather_walk
//       Replaces the Pallas row-gather probes experiments/
//       pallas_gather_bench.py:kernel (P2), pallas_aligned_bench.py:kernel
//       (P3) and gather_pair_bench.py:kernel (P4). Each index's row of a
//       uint8 table of R-byte rows is read whole, and the int32 sum of its
//       first sum_bytes bytes is added into one partial per CHUNK of
//       indices (P4's output; P2's and P3's scalar is the wrapping sum of
//       the partials). P2's ring of K row DMAs in flight becomes a ring of
//       K shared-memory slots per warp filled by cp.async: a warp keeps K
//       rows in flight, each lane copying and later summing the same 16 B
//       pieces, so no lane reads another's copy. A block of up to 8 warps
//       owns one chunk, warp w taking rows w, w + W, w + 2W, ... of it (W
//       warps), so the card holds thousands of warps' rings at once. The
//       walk entry runs
//       bench.py's calibration walk, idx <- (idx * 1103515245 + sum of the
//       row's bytes + 12345) mod nb in u32, for seg steps in one launch,
//       one thread per lane, its vector loads of a row all in flight
//       together. A sector mask (bit s: the row's 32 B sector s) limits the
//       loads and the sum to the sectors a search step reads, so the walk
//       can measure the rate of visits that touch only those.
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
constexpr int kRingBytesPerBlock = 32768;  // stays under the 48 KB default

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t warp_sum(uint32_t v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

// Copy row i (P pieces of 16 B) into a ring slot; lane l copies pieces
// l, l + 32, ...
template <int P>
__device__ __forceinline__ void issue_row(const uint8_t* table, int64_t nb,
                                          int32_t i, uint4* slot, int lane) {
  const uint4* src = reinterpret_cast<const uint4*>(table + clamp_row(i, nb) * (P * 16));
  for (int p = lane; p < P; p += 32) cp_async16(slot + p, src + p);
}

template <int R, int K>
__global__ void __launch_bounds__(kMaxWarps * 32)
k5_gather_reduce_kernel(const uint8_t* __restrict__ table, int64_t nb,
                        const int32_t* __restrict__ idx, int64_t n, int chunk,
                        int sum_pieces, int32_t* __restrict__ out) {
  constexpr int P = R / 16;
  constexpr int PPL = (P + 31) / 32;
  extern __shared__ uint4 ring_all[];
  __shared__ uint32_t warp_sums[kMaxWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  uint4* ring = ring_all + static_cast<size_t>(warp) * K * P;
  const int64_t lo = static_cast<int64_t>(blockIdx.x) * chunk;
  const int64_t rem = n - lo;
  const int rows = static_cast<int>(rem < chunk ? rem : chunk);
  // this warp's rows: lo + warp + j * n_warps for j = 0 .. m - 1
  const int m = rows > warp ? (rows - warp + n_warps - 1) / n_warps : 0;
  const int32_t* my_idx = idx + lo + warp;
  uint32_t acc = 0u;
#pragma unroll
  for (int j = 0; j < K; ++j) {
    if (j < m) issue_row<P>(table, nb, my_idx[static_cast<int64_t>(j) * n_warps], ring + j * P, lane);
    cp_async_commit();  // one group per ring slot, empty past the last row
  }
  for (int j = 0; j < m; ++j) {
    cp_async_wait<K - 1>();  // row j's group has landed
    uint4* slot = ring + (j % K) * P;
#pragma unroll
    for (int q = 0; q < PPL; ++q) {
      const int p = lane + 32 * q;
      if (p < sum_pieces) acc += byte_sum(slot[p]);
    }
    __syncwarp();  // the slot's reads are done before its refill is issued
    if (j + K < m) {
      issue_row<P>(table, nb, my_idx[static_cast<int64_t>(j + K) * n_warps], slot, lane);
    }
    cp_async_commit();
  }
  acc = warp_sum(acc);
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    uint32_t t = 0u;
    for (int w = 0; w < n_warps; ++w) t += warp_sums[w];  // wraps as int32 does
    out[blockIdx.x] = static_cast<int32_t>(t);
  }
}

// MASKED false: every sector of the row, loaded unconditionally.
template <int R, bool MASKED>
__global__ void k5_gather_walk_kernel(const uint8_t* __restrict__ table,
                                      int64_t nb, const int32_t* __restrict__ idx,
                                      int64_t n, int seg, uint32_t sector_mask,
                                      int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t rows = static_cast<uint32_t>(nb);
  uint32_t x = static_cast<uint32_t>(clamp_row(idx[i], nb));
  for (int s = 0; s < seg; ++s) {
    const uint4* row = reinterpret_cast<const uint4*>(table + static_cast<int64_t>(x) * R);
    uint32_t sum = 0u;
    if constexpr (!MASKED) {
#pragma unroll
      for (int q = 0; q < R / 16; ++q) sum += byte_sum(__ldg(row + q));
    } else {
      // two 16 B pieces per sector, kBatch pieces loaded before the first
      // is summed: a load under its mask bit and nothing else, so that the
      // compiler predicates it and the batch is in flight together
      constexpr int kPieces = R / 16;
      constexpr int kBatch = kPieces <= 24 ? kPieces : 16;
#pragma unroll
      for (int q0 = 0; q0 < kPieces; q0 += kBatch) {
        uint4 v[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
          v[j] = make_uint4(0u, 0u, 0u, 0u);
          if ((sector_mask >> ((q0 + j) / 2)) & 1u) v[j] = __ldg(row + q0 + j);
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) sum += byte_sum(v[j]);
      }
    }
    x = (x * 1103515245u + sum + 12345u) % rows;
  }
  out[i] = static_cast<int32_t>(x);
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
template <int R>
cudaError_t launch_walk(const uint8_t* table, int64_t nb, const int32_t* idx,
                        int64_t n, int seg, uint32_t sector_mask, int32_t* out,
                        cudaStream_t stream) {
  constexpr uint32_t kAll = R / 32 == 32 ? 0xFFFFFFFFu : (1u << (R / 32)) - 1u;
  if ((sector_mask & kAll) == kAll) {
    k5_gather_walk_kernel<R, false><<<blocks_for(n), kThreads, 0, stream>>>(
        table, nb, idx, n, seg, sector_mask, out);
  } else {
    k5_gather_walk_kernel<R, true><<<blocks_for(n), kThreads, 0, stream>>>(
        table, nb, idx, n, seg, sector_mask, out);
  }
  return cudaGetLastError();
}

template <int R, int K>
cudaError_t launch_reduce(const uint8_t* table, int64_t nb, const int32_t* idx,
                          int64_t n, int chunk, int sum_pieces, int32_t* out,
                          cudaStream_t stream) {
  int warps = kRingBytesPerBlock / (K * R);
  warps = warps < 1 ? 1 : (warps > kMaxWarps ? kMaxWarps : warps);
  const size_t smem = static_cast<size_t>(warps) * K * R;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  k5_gather_reduce_kernel<R, K><<<static_cast<unsigned int>(n_chunks), warps * 32, smem, stream>>>(
      table, nb, idx, n, chunk, sum_pieces, out);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_reduce_ring(int ring, const uint8_t* table, int64_t nb,
                               const int32_t* idx, int64_t n, int chunk,
                               int sum_pieces, int32_t* out, cudaStream_t stream) {
  switch (ring) {
    case 2: return launch_reduce<R, 2>(table, nb, idx, n, chunk, sum_pieces, out, stream);
    case 4: return launch_reduce<R, 4>(table, nb, idx, n, chunk, sum_pieces, out, stream);
    case 8: return launch_reduce<R, 8>(table, nb, idx, n, chunk, sum_pieces, out, stream);
    case 16: return launch_reduce<R, 16>(table, nb, idx, n, chunk, sum_pieces, out, stream);
    case 32: return launch_reduce<R, 32>(table, nb, idx, n, chunk, sum_pieces, out, stream);
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
  if (chunk < 1 || sum_bytes < 16 || sum_bytes > row_bytes || sum_bytes % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int sp = sum_bytes / 16;
  switch (row_bytes) {
    case 128: err = launch_reduce_ring<128>(ring, table, nb, idx, n, chunk, sp, out, stream); break;
    case 256: err = launch_reduce_ring<256>(ring, table, nb, idx, n, chunk, sp, out, stream); break;
    case 384: err = launch_reduce_ring<384>(ring, table, nb, idx, n, chunk, sp, out, stream); break;
    case 512: err = launch_reduce_ring<512>(ring, table, nb, idx, n, chunk, sp, out, stream); break;
    case 1024: err = launch_reduce_ring<1024>(ring, table, nb, idx, n, chunk, sp, out, stream); break;
    default: err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

int awfm_k5_gather_walk(int device, const uint8_t* table, int64_t nb,
                        int row_bytes, const int32_t* idx, int64_t n, int seg,
                        uint32_t sector_mask, int32_t* out,
                        cudaStream_t stream) {
  cudaError_t err = use_device(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  switch (row_bytes) {
    case 128: err = launch_walk<128>(table, nb, idx, n, seg, sector_mask, out, stream); break;
    case 256: err = launch_walk<256>(table, nb, idx, n, seg, sector_mask, out, stream); break;
    case 384: err = launch_walk<384>(table, nb, idx, n, seg, sector_mask, out, stream); break;
    case 512: err = launch_walk<512>(table, nb, idx, n, seg, sector_mask, out, stream); break;
    case 1024: err = launch_walk<1024>(table, nb, idx, n, seg, sector_mask, out, stream); break;
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

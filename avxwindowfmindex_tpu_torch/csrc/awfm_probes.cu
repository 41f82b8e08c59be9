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
//       one thread per lane, its R / 16 vector loads of a row all in flight
//       together.
//   K6 awfm_k6_slab_gather / awfm_k6_slab_chain
//       Replaces experiments/ab_r5_pallas_gather.py:_k1_kernel (P5):
//       out[i, :] = slab[idx[i], :] over a (S, 128) u32 slab of 1-4 MiB.
//       The slab does not fit one block's 227 KB of shared memory, so it is
//       read from global memory, where it sits in the 50 MB L2. The chained
//       entry runs k1_chain's idx <- (row[0] + row[37]) mod S for seg steps
//       in one launch, one warp per lane, each step reading the whole 512 B
//       row (one 16 B volatile load per lane).
//
// All four are bound by random row reads from device memory (K6: from L2)
// and do a few integer operations per 16 B. An index outside the table is
// clamped to the last row, as XLA's gather clamps. These are simple,
// correct first kernels; making them fast is later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC (avxwindowfmindex_tpu_torch/ops/kernels.py).
// Every entry point returns cudaGetLastError() after its launch.

#include <cstdint>
#include <cuda_runtime.h>

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

template <int R>
__global__ void k5_gather_walk_kernel(const uint8_t* __restrict__ table,
                                      int64_t nb, const int32_t* __restrict__ idx,
                                      int64_t n, int seg,
                                      int32_t* __restrict__ out) {
  const int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (i >= n) return;
  const uint32_t rows = static_cast<uint32_t>(nb);
  uint32_t x = static_cast<uint32_t>(clamp_row(idx[i], nb));
  for (int s = 0; s < seg; ++s) {
    const uint4* row = reinterpret_cast<const uint4*>(table + static_cast<int64_t>(x) * R);
    uint32_t sum = 0u;
#pragma unroll
    for (int q = 0; q < R / 16; ++q) sum += byte_sum(__ldg(row + q));
    x = (x * 1103515245u + sum + 12345u) % rows;
  }
  out[i] = static_cast<int32_t>(x);
}

__global__ void k6_slab_gather_kernel(const uint4* __restrict__ slab, int64_t s,
                                      const int32_t* __restrict__ idx, int64_t n,
                                      uint4* __restrict__ out) {
  // one thread per 16 B piece: row i = t / 32, piece t % 32
  const int64_t t = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (t >= n * 32) return;
  const int64_t i = t >> 5;
  const int p = static_cast<int>(t & 31);
  out[t] = slab[clamp_row(idx[i], s) * 32 + p];
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
  cudaError_t err = cudaSetDevice(device);
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
                        int32_t* out, cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int grid = blocks_for(n);
  switch (row_bytes) {
    case 128: k5_gather_walk_kernel<128><<<grid, kThreads, 0, stream>>>(table, nb, idx, n, seg, out); break;
    case 256: k5_gather_walk_kernel<256><<<grid, kThreads, 0, stream>>>(table, nb, idx, n, seg, out); break;
    case 384: k5_gather_walk_kernel<384><<<grid, kThreads, 0, stream>>>(table, nb, idx, n, seg, out); break;
    case 512: k5_gather_walk_kernel<512><<<grid, kThreads, 0, stream>>>(table, nb, idx, n, seg, out); break;
    case 1024: k5_gather_walk_kernel<1024><<<grid, kThreads, 0, stream>>>(table, nb, idx, n, seg, out); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

int awfm_k6_slab_gather(int device, const int32_t* slab, int64_t s,
                        const int32_t* idx, int64_t n, int32_t* out,
                        cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  k6_slab_gather_kernel<<<blocks_for(n * 32), kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(slab), s, idx, n, reinterpret_cast<uint4*>(out));
  return static_cast<int>(cudaGetLastError());
}

int awfm_k6_slab_chain(int device, const int32_t* slab, int64_t s,
                       const int32_t* idx, int64_t n, int seg, int32_t* out,
                       cudaStream_t stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  k6_slab_chain_kernel<<<blocks_for(n * 32), kThreads, 0, stream>>>(
      reinterpret_cast<const uint4*>(slab), s, idx, n, seg, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

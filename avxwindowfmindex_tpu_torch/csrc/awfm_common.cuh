// Shared by awfm_kernels.cu and awfm_probes.cu.

#pragma once

#include <cuda_runtime.h>

// Makes `device` the calling thread's current device, when it is not.
inline cudaError_t use_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess || current == device) return err;
  return cudaSetDevice(device);
}

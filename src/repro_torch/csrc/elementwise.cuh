// Launch geometry shared by the elementwise kernels (lif.cu, llsmu.cu,
// po2_quant.cu): one thread per element, grid-stride over the flat arrays,
// at most BLOCKS_PER_SM blocks of THREADS threads on each SM, so a large
// array is walked by a resident grid and a small one by just enough blocks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace elementwise {

constexpr int THREADS = 256;
constexpr int BLOCKS_PER_SM = 16;

// Selects `device` and sets `blocks` for n > 0 elements; returns the
// cudaError_t of the two runtime calls (0 = success).
inline int grid(int64_t n, int device, int* blocks) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t need = (n + THREADS - 1) / THREADS;
  const int64_t cap = static_cast<int64_t>(sms) * BLOCKS_PER_SM;
  *blocks = static_cast<int>(need < cap ? need : cap);
  return 0;
}

}  // namespace elementwise

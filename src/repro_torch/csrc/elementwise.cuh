// Launch plumbing shared by the elementwise kernels (lif.cu, llsmu.cu,
// po2_quant.cu): the device made current, a grid of THREADS-thread blocks
// sized from the work items (at most a given cap), and the 16-byte
// alignment test that decides whether a kernel may read and write four
// elements a thread as one vector.
//
// These host functions run on every launch, so each keeps to what it must
// do: the current device is read (a thread-local read in the runtime) and
// set only when it differs.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace elementwise {

constexpr int THREADS = 256;

// Makes `device` current unless it already is; returns the cudaError_t of
// the runtime calls (0 = success).
inline int set_device(int device) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  return static_cast<int>(err);
}

// The most blocks a grid may have (gridDim.x).
constexpr int64_t MAX_BLOCKS = (int64_t{1} << 31) - 1;

// Blocks for `items` work items of one thread each (at least one block), at
// most `cap`.
inline int blocks(int64_t items, int64_t cap = MAX_BLOCKS) {
  const int64_t need = (items + THREADS - 1) / THREADS;
  return static_cast<int>(need < 1 ? 1 : (need < cap ? need : cap));
}

// True when every pointer is 16-byte aligned: a contiguous tensor whose
// storage offset is not a multiple of four elements (x[1:]) is not.
template <typename... P>
inline bool aligned16(const P*... ptrs) {
  return ((reinterpret_cast<uintptr_t>(ptrs) % 16 == 0) && ...);
}

}  // namespace elementwise

// LLSMU approximate multiplier (paper SII-D, eqs. 6-14) for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/llsmu/kernel.py:
//   llsmu_multiply (_llsmu_kernel, _mitchell, _floor_log2, _var_shift).
// Elementwise over non-negative int32 operands a, b: a Karatsuba split at
// n_bits, three Mitchell log-multiplies (the leading-one position k, the
// Q(frac_bits) mantissas, delta = fx + fy - 2, the two compensated branches,
// the barrel shift back), and the exact recombination
// m1 << 2n + (m2 - m0 - m1) << n + m0.  The sign is handled around the
// kernel (kernels/llsmu/ops.py), as in the hardware.
//
// Bit control.  The kernel reproduces XLA's int32 semantics, which the
// Pallas body runs under and the plain version (kernels/llsmu/ref.py)
// shares: every add, subtract and shift is done on uint32_t and cast back
// (two's complement wrap, no signed overflow left to the compiler); a left
// shift by 32 or more gives 0, a right shift is arithmetic and saturates at
// 31 (sign fill), since C++ leaves shifts by the width or more undefined.
// The leading-one count is the Pallas threshold chain
// k = #{1 <= i < max_bits : x >= 2^i}, i.e. min(31 - clz(x), max_bits - 1)
// for x > 0 and 0 otherwise, with max_bits = 2 n_bits + 10 from the wrapper.
// cq = round(c * 2^frac_bits) is rounded on the host as Python rounds it;
// cq // 2 is its floor half (an arithmetic shift).
//
// Bound: memory.  12 bytes move per element (two int32 operands read, one
// written); the three Mitchell evaluations are some 120 integer operations
// per element, below the byte time even counted at the card's float32 rate.  Design:
// one thread per element, grid-stride over the flat arrays (elementwise.cuh),
// ragged end masked, no shared memory; neighbouring threads read neighbouring
// words.

#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace {

__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(y));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) - static_cast<uint32_t>(y));
}

// x << s for s >= 0, XLA semantics: 0 once s reaches the width.
__device__ __forceinline__ int32_t shl(int32_t x, int32_t s) {
  return s >= 32 ? 0 : static_cast<int32_t>(static_cast<uint32_t>(x) << s);
}

// Arithmetic x >> s for s >= 0, XLA semantics: the sign fills from 32 on.
__device__ __forceinline__ int32_t shr(int32_t x, int32_t s) {
  return x >> (s > 31 ? 31 : s);
}

__device__ __forceinline__ int32_t floor_log2(int32_t x, int max_bits) {
  if (x <= 0) return 0;
  const int k = 31 - __clz(x);
  return k < max_bits - 1 ? k : max_bits - 1;
}

// mant * 2^s, truncating for negative s (the hardware barrel shift).
__device__ __forceinline__ int32_t var_shift(int32_t mant, int32_t s) {
  return shr(shl(mant, s > 0 ? s : 0), s < 0 ? -s : 0);
}

__device__ __forceinline__ int32_t mitchell(int32_t x, int32_t y, int frac_bits,
                                            int32_t cq, int max_bits) {
  const int32_t one = static_cast<int32_t>(1u << frac_bits);
  const int32_t kx = floor_log2(x, max_bits);
  const int32_t ky = floor_log2(y, max_bits);
  const int32_t fx = var_shift(x, frac_bits - kx);
  const int32_t fy = var_shift(y, frac_bits - ky);
  const int32_t delta = wrap_sub(wrap_add(fx, fy), wrap_add(one, one));
  const int32_t mant = delta < one
                           ? wrap_add(wrap_add(one, delta), cq)
                           : shl(wrap_add(delta, cq >> 1), 1);   // 2 * (delta + cq // 2)
  const int32_t p = var_shift(mant, wrap_sub(wrap_add(kx, ky), frac_bits));
  return (x == 0 || y == 0) ? 0 : p;
}

__global__ void llsmu_multiply_kernel(int32_t* __restrict__ out,
                                      const int32_t* __restrict__ a,
                                      const int32_t* __restrict__ b, int64_t n, int n_bits,
                                      int frac_bits, int32_t cq, int max_bits) {
  const int32_t mask = static_cast<int32_t>((1u << n_bits) - 1u);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const int32_t av = a[k], bv = b[k];
    const int32_t ha = av >> n_bits, la = av & mask;
    const int32_t hb = bv >> n_bits, lb = bv & mask;
    const int32_t m0 = mitchell(la, lb, frac_bits, cq, max_bits);
    const int32_t m1 = mitchell(ha, hb, frac_bits, cq, max_bits);
    const int32_t m2 = mitchell(wrap_add(ha, la), wrap_add(hb, lb), frac_bits, cq, max_bits);
    const int32_t s3 = wrap_sub(wrap_sub(m2, m0), m1);
    out[k] = wrap_add(wrap_add(shl(m1, 2 * n_bits), shl(s3, n_bits)), m0);
  }
}

}  // namespace

extern "C" {

// out, a, b: (n,) int32, a and b non-negative.  Returns the cudaError_t of
// the launch (0 = success).
int llsmu_multiply(int32_t* out, const int32_t* a, const int32_t* b, int64_t n,
                   int n_bits, int frac_bits, int cq, int max_bits, int device,
                   void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  const int err = elementwise::grid(n, device, &blocks);
  if (err != 0) return err;
  llsmu_multiply_kernel<<<blocks, elementwise::THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      out, a, b, n, n_bits, frac_bits, cq, max_bits);
  return static_cast<int>(cudaGetLastError());
}

const char* llsmu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

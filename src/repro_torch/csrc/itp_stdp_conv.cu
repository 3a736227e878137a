// Patch-level (im2col) ITP-STDP conv weight delta for Hopper (sm_90a),
// plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/itp_stdp_conv/kernel.py:
//   itp_stdp_conv_delta_packed (packed uint8 history words, one per patch
//                               element / output neuron) and
//   itp_stdp_conv_delta        (depth-major float32 bitplanes).
// For M patch rows (batch x output positions), K patch elements and C output
// channels it computes the raw (K, C) delta
//
//   dw[k, c] = sum_m (1 - pre[m, k]) * ltp_mag[m, k] * post[m, c]
//            - sum_m pre[m, k] * (1 - post[m, c]) * ltd_mag[m, c]
//
// where the magnitudes are the po2 reads of the history registers: unpack
// slot k = word bit 7-k (or read bitplane k), keep only the newest set bit
// under nearest pairing, sum po2[k] * bit over k = 0 .. depth-1 in float32.
// Both entry points instantiate one kernel template; only the history load
// differs, so packed and unpacked are bit-identical.
//
// Bound: memory.  The inputs are read once (pre/post spikes as float32, one
// history byte per element, or 4*depth bytes of bitplanes) against 4*M*K*C
// flops of the two contractions; at the DCSNN conv1 shape (M=9216, K=25,
// C=12, packed) that is 1.70 MB, 0.51 us at 3.35 TB/s, against 11 MFLOP,
// 0.17 us at the 67 TFLOP/s float32 rate outside the tensor cores.
//
// Design.  The Pallas grid walks the M tiles in order and accumulates into
// one resident VMEM block; blocks on the card run in no order, so the
// contraction is the split-M two-pass scheme of gated_sum.cuh (per-chunk
// float64 partials into a scratch tensor, then an ordered sum), with the po2
// register read as its magnitude.  No atomics; ragged M, K and C are masked
// in-kernel and the wrapper pads nothing.
//
// Arithmetic: no tensor cores (TF32 would drop the po2 sums' low bits).  The
// magnitudes are float32, written with __fmul_rn/__fadd_rn so nvcc does not
// contract them into FMAs.  The po2 terms span a few binades, so the float64
// sums are exact: two runs, the packed and unpacked kernels, and the plain
// version (which contracts in float64) agree bit for bit.  Double adds run at
// half the float32 rate, which does not matter for a kernel bound by memory.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gated_sum.cuh"

namespace {

// po2 magnitude of element (m, x) of an (M, X) layout: k = 0 (newest) ..
// depth-1, nearest mask = keep a bit only while the running count is one.
template <bool PACKED>
__device__ __forceinline__ float magnitude(const void* hist, int m, int x,
                                           int rows, int cols,
                                           const float* __restrict__ po2,
                                           int depth, bool nearest) {
  const size_t at = static_cast<size_t>(m) * cols + x;
  float acc = 0.0f;
  float count = 0.0f;
  unsigned word = 0u;
  if constexpr (PACKED) word = static_cast<const uint8_t*>(hist)[at];
  for (int k = 0; k < depth; ++k) {
    float bit;
    if constexpr (PACKED) {
      bit = static_cast<float>((word >> (7 - k)) & 1u);
    } else {
      bit = static_cast<const float*>(hist)[static_cast<size_t>(k) * rows * cols + at];
    }
    if (nearest) {
      count = __fadd_rn(count, bit);
      bit = (count == 1.0f) ? bit : 0.0f;
    }
    acc = __fadd_rn(acc, __fmul_rn(po2[k], bit));
  }
  return acc;
}

// The register read of one (M, X) history operand as gated::partial_chunk's
// magnitude functor.
template <bool PACKED>
struct Po2Read {
  const void* hist;   // (M, X) u8 words | (depth, M, X) f32 bitplanes
  const float* po2;   // (depth,)
  int rows, cols, depth, nearest;
  __device__ __forceinline__ float operator()(int m, int x) const {
    return magnitude<PACKED>(hist, m, x, rows, cols, po2, depth, nearest != 0);
  }
};

// The operands arrive as plain kernel parameters and the functors are built
// in the body (passed as struct parameters, ptxas held the bitplane variant
// at 32 registers with a spill).
template <bool PACKED>
__global__ void __launch_bounds__(gated::THREADS)
conv_delta_partial(double* __restrict__ partial, const float* __restrict__ pre,
                   const float* __restrict__ post, const void* __restrict__ pre_hist,
                   const void* __restrict__ post_hist, const float* __restrict__ po2_ltp,
                   const float* __restrict__ po2_ltd, int M, int K, int C, int depth,
                   int nearest) {
  const Po2Read<PACKED> pre_mag{pre_hist, po2_ltp, M, K, depth, nearest};
  const Po2Read<PACKED> post_mag{post_hist, po2_ltd, M, C, depth, nearest};
  gated::partial_chunk(partial, pre, post, pre_mag, post_mag, M, K, C);
}

template <bool PACKED>
int launch(float* out, double* partial, const float* pre, const float* post,
           const void* pre_hist, const void* post_hist, const float* po2_ltp,
           const float* po2_ltd, int M, int K, int C, int depth, int nearest,
           int device, void* stream) {
  return gated::launch(out, partial, M, K, C, device, stream,
                       [&](dim3 grid, dim3 block, cudaStream_t s) {
                         conv_delta_partial<PACKED><<<grid, block, 0, s>>>(
                             partial, pre, post, pre_hist, post_hist, po2_ltp, po2_ltd,
                             M, K, C, depth, nearest);
                       });
}

}  // namespace

extern "C" {

// Rows per partial: the wrapper allocates partial as (chunks, K, C) float64
// with chunks = ceil(M / itp_stdp_conv_chunk_rows()).
int itp_stdp_conv_chunk_rows() { return gated::CHUNK_M; }

// pre: (M, K) f32, post: (M, C) f32, words: (M, K) / (M, C) uint8 with
// register slot k at bit 7-k; po2: (depth,) f32; out: (K, C) f32.
// Returns the cudaError_t of the launches (0 = success).
int itp_stdp_conv_delta_packed(float* out, double* partial, const float* pre,
                               const float* post, const uint8_t* pre_words,
                               const uint8_t* post_words, const float* po2_ltp,
                               const float* po2_ltd, int M, int K, int C, int depth,
                               int nearest, int device, void* stream) {
  return launch<true>(out, partial, pre, post, pre_words, post_words, po2_ltp,
                      po2_ltd, M, K, C, depth, nearest, device, stream);
}

// As above, with (depth, M, K) / (depth, M, C) f32 bitplanes, k = 0 newest.
int itp_stdp_conv_delta(float* out, double* partial, const float* pre,
                        const float* post, const float* pre_bits,
                        const float* post_bits, const float* po2_ltp,
                        const float* po2_ltd, int M, int K, int C, int depth,
                        int nearest, int device, void* stream) {
  return launch<false>(out, partial, pre, post, pre_bits, post_bits, po2_ltp,
                       po2_ltd, M, K, C, depth, nearest, device, stream);
}

const char* itp_stdp_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

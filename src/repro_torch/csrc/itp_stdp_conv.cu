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
// Bound.  The inputs are read once (pre/post spikes as float32, one history
// byte per element, or 4*depth bytes of bitplanes) against 4*M*K*C flops of
// the two contractions; at the DCSNN conv1 shape (M=9216, K=25, C=12,
// packed) that is 1.70 MB, 0.51 us at 3.35 TB/s, against 11 MFLOP, 0.17 us
// at the 67 TFLOP/s float32 rate outside the tensor cores.  Neither is what
// holds the kernel: a call is a chain of loads, block syncs and double adds
// a few microseconds long, so its time is latency, and the design is about
// the length of that chain and how many SMs share it.
//
// Design.  The Pallas grid walks the M tiles in order and accumulates into
// one resident VMEM block; blocks on the card run in no order, so the
// contraction is the one-launch cooperative scheme of gated_sum.cuh: every
// co-resident block sums its own rows for all K x C outputs (each element's
// register read done once, into shared memory, while cp.async stages the
// next rows), its lanes are added in a fixed tree, the blocks' float64
// partials go to a per-call scratch tensor, the grid syncs, and each output
// is summed over the blocks in a fixed order.  No atomics; ragged M, K and C
// are masked in-kernel and the wrapper pads nothing.
//
// The SNN fc layers' batch-summed delta is the same contraction with the
// batch as the M rows (one row per sample, K inputs, C neurons).  At the
// paper's widest fc layer (256 x 784 x 6,400) there are more output tiles
// than co-resident blocks, so M is not split and each block stores its
// tiles' outputs directly (gated_sum.cuh, "Direct store"): the 2.57 G double
// FMAs of the two contractions, ~0.15 ms at the card's float64 rate, bound
// that call.
//
// Arithmetic: no tensor cores (TF32 would drop the po2 sums' low bits).  The
// magnitudes are float32, written with __fmul_rn/__fadd_rn so nvcc does not
// contract them into FMAs.  The po2 terms span a few binades, so the float64
// sums are exact: two runs, the packed and unpacked kernels, and the plain
// version (which contracts in float64) agree bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "gated_sum.cuh"

namespace {

// One step of the po2 read: slot k's bit (0 or 1), the nearest mask (keep a
// bit only while the running count is one), po2[k] * bit into the sum.
__device__ __forceinline__ void po2_step(float po2_k, float bit, bool nearest, float& count,
                                         float& acc) {
  if (nearest) {
    count = __fadd_rn(count, bit);
    bit = (count == 1.0f) ? bit : 0.0f;
  }
  acc = __fadd_rn(acc, __fmul_rn(po2_k, bit));
}

// The register read of both history operands as gated::contract's magnitude
// functor, k = 0 (newest) .. depth-1: words (depth <= 8) hold slot k at bit
// 7-k, one chunk; bitplanes arrive in depth chunks, plane k0 + i at
// at[i * plane], and each chunk's steps continue the running read (acc,
// count), so the chunked read is the one-pass read.  The po2 rows sit in
// shared memory; the general body reads them in place past
// gated::MAX_PARAMS.  The one-pass body holds one pointer, as registers are
// tight there.  Under nearest pairing a word's read is its newest live
// slot's po2 value (the MSB mask of the paper's Fig. 11: a priority encoder,
// __clz), which is exactly what the step-wise read reaches when the po2
// values are finite: every other step adds +-0.  Otherwise the read goes
// step by step.
template <bool PACKED, bool GENERAL>
struct Po2Read {
  const float* ltp;   // (depth,) po2 rows: LTP, and LTD at ltp + depth or at ltd
  const float* ltd;
  int depth;
  bool nearest;

  template <int SIDE, class Hist>
  __device__ __forceinline__ float read(const Hist* at, int plane, int k0, int nk, float acc,
                                        float& count) const {
    const float* row = SIDE == 0 ? ltp : (GENERAL ? ltd : ltp + depth);
    if constexpr (PACKED) {
      const unsigned word = *reinterpret_cast<const uint8_t*>(at);
      if (nearest) {
        const unsigned live = word & (0xff00u >> depth) & 0xffu;   // slots 0 .. depth-1
        return live ? row[__clz(live << 24)] : 0.0f;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) {   // the bit as 1.0f or 0.0f, no conversion
        const float bit = __uint_as_float(((word >> (7 - k)) & 1u) * 0x3f800000u);
        if (k < depth) po2_step(row[k], bit, false, count, acc);
      }
    } else {
#pragma unroll 1   // unrolled, the plane loads made ptxas spill
      for (int k = 0; k < nk; ++k) {
        po2_step(row[k0 + k], reinterpret_cast<const float*>(at)[k * plane], nearest, count,
                 acc);
      }
    }
    return acc;
  }
  template <class Hist>
  __device__ __forceinline__ float pre(const Hist* at, int plane, int k0, int nk, float acc,
                                       float& count) const {
    return read<0>(at, plane, k0, nk, acc, count);
  }
  template <class Hist>
  __device__ __forceinline__ float post(const Hist* at, int plane, int k0, int nk, float acc,
                                        float& count) const {
    return read<1>(at, plane, k0, nk, acc, count);
  }
};

// The operands arrive as plain kernel parameters and the functor is built
// in the body (passed as a struct parameter, ptxas held the bitplane variant
// at 32 registers with a spill).  The general body (row slots, depth chunks)
// runs one block an SM, so its extra state has the registers it needs.
template <bool PACKED, bool GENERAL>
__global__ void __launch_bounds__(gated::THREADS, GENERAL ? 1 : gated::MIN_BLOCKS)
itp_conv_delta_kernel(float* __restrict__ out, double* __restrict__ partial,
                      const float* __restrict__ pre, const float* __restrict__ post,
                      const void* __restrict__ pre_hist, const void* __restrict__ post_hist,
                      const float* __restrict__ po2_ltp, const float* __restrict__ po2_ltd,
                      int depth, int nearest, gated::Plan plan) {
  using Hist = typename std::conditional<PACKED, uint8_t, float>::type;
  extern __shared__ __align__(16) char smem[];
  // the po2 vectors are staged into shared memory with the first rows
  const float* staged = reinterpret_cast<const float*>(smem + plan.param_at);
  const bool in_smem = !GENERAL || plan.params > 0;
  const Po2Read<PACKED, GENERAL> mag{in_smem ? staged : po2_ltp,
                                     in_smem ? staged + depth : po2_ltd, depth, nearest != 0};
  gated::contract<GENERAL>(out, partial, pre, post, static_cast<const Hist*>(pre_hist),
                  static_cast<const Hist*>(post_hist), po2_ltp, po2_ltd, plan, mag, smem);
}

template <bool PACKED>
int launch(float* out, double* partial, long scratch, const float* pre, const float* post,
           const void* pre_hist, const void* post_hist, const float* po2_ltp,
           const float* po2_ltd, int M, int K, int C, int depth, int nearest,
           int device, void* stream, int* direct) {
  return gated::launch(itp_conv_delta_kernel<PACKED, false>, itp_conv_delta_kernel<PACKED, true>,
                       M, K, C, PACKED ? 1 : 4, PACKED ? 1 : depth, depth, device, stream,
                       scratch, direct, out, partial, pre, post, pre_hist, post_hist, po2_ltp,
                       po2_ltd, depth, nearest);
}

}  // namespace

extern "C" {

// The float64 scratch the launch of this shape takes, into *doubles: the
// wrapper allocates partial as that many values (per call; no zeroing), or
// passes null at 0, where the blocks store the outputs directly and partial
// is not read.  Returns the cudaError_t (0 = success).
int itp_stdp_conv_scratch(int M, int K, int C, int depth, int packed, int device,
                          long* doubles) {
  return packed ? gated::plan_scratch(itp_conv_delta_kernel<true, false>,
                                      itp_conv_delta_kernel<true, true>, M, K, C, 1, 1, depth,
                                      device, doubles)
                : gated::plan_scratch(itp_conv_delta_kernel<false, false>,
                                      itp_conv_delta_kernel<false, true>, M, K, C, 4, depth,
                                      depth, device, doubles);
}

// pre: (M, K) f32, post: (M, C) f32, words: (M, K) / (M, C) uint8 with
// register slot k at bit 7-k; po2: (depth,) f32; out: (K, C) f32; partial:
// `scratch` f64 values, sized as above; *direct: whether the launch stored
// the outputs directly.  Returns the cudaError_t of the launch (0 = success).
int itp_stdp_conv_delta_packed(float* out, double* partial, long scratch, const float* pre,
                               const float* post, const uint8_t* pre_words,
                               const uint8_t* post_words, const float* po2_ltp,
                               const float* po2_ltd, int M, int K, int C, int depth,
                               int nearest, int device, void* stream, int* direct) {
  return launch<true>(out, partial, scratch, pre, post, pre_words, post_words, po2_ltp,
                      po2_ltd, M, K, C, depth, nearest, device, stream, direct);
}

// As above, with (depth, M, K) / (depth, M, C) f32 bitplanes, k = 0 newest.
int itp_stdp_conv_delta(float* out, double* partial, long scratch, const float* pre,
                        const float* post, const float* pre_bits,
                        const float* post_bits, const float* po2_ltp,
                        const float* po2_ltd, int M, int K, int C, int depth,
                        int nearest, int device, void* stream, int* direct) {
  return launch<false>(out, partial, scratch, pre, post, pre_bits, post_bits, po2_ltp,
                       po2_ltd, M, K, C, depth, nearest, device, stream, direct);
}

const char* itp_stdp_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

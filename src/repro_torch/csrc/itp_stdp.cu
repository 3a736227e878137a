// Fused ITP-STDP weight update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernels of src/repro/kernels/itp_stdp/kernel.py:
//   itp_stdp_update_packed (packed uint8 history words) and
//   itp_stdp_update        (depth-major float32 bitplanes).
// Both entry points instantiate one kernel template and share its device
// body (po2 read -> XOR pair gate -> clipped read-modify-write of w), so the
// packed and unpacked variants are bit-identical, as _stdp_body makes them
// in the reference.
//
// Bound: memory.  Each synapse is read and written once as float32 (8 B)
// against a handful of flops; the per-neuron history (1 B word or 4*depth B
// of bitplanes) and spikes are O(n), not O(n^2).  Design: the tile-streaming
// routine of dense_update.cuh (each thread's 16-byte vectors of w loaded
// into registers before anything else, 16-byte stores), with the po2
// register read as the element magnitude.  A block reads each neuron of its
// tile once, while its w loads fly (unpack (word >> (7-k)) & 1, nearest mask
// = first set bit, po2 sum k = 0..depth-1 in float32; bitplanes are loaded
// in depth chunks of 8, each chunk's loads issued together, then summed in
// order).  The magnitude is per neuron, the point of the paper: each
// synapse reads two staged magnitudes.
//
// Arithmetic is written with __fmul_rn / __fadd_rn / __fsub_rn so nvcc
// cannot contract it into FMAs: the plain PyTorch version rounds after every
// multiply and add, and with an eta that is not a power of two an FMA would
// round differently.

#include <cuda_runtime.h>
#include <stdint.h>

#include "dense_update.cuh"

namespace {

constexpr int CHUNK = 8;   // bitplanes loaded together
constexpr int SLOTS = 4;   // 16-byte vectors of w a thread (dense_update.cuh)

// One step of the register read: the nearest mask keeps a bit only while the
// running count of set bits is exactly one (bits * (cumsum(bits) == 1)).
__device__ __forceinline__ float read_step(float acc, float& count, float bit,
                                           float po2, bool nearest) {
  if (nearest) {
    count = __fadd_rn(count, bit);
    bit = (count == 1.0f) ? bit : 0.0f;
  }
  return __fadd_rn(acc, __fmul_rn(po2, bit));
}

// po2 magnitude of neuron idx of one lane: k = 0 (newest) .. depth-1.
template <bool PACKED>
__device__ __forceinline__ float magnitude(const void* hist, int lane, int n, int idx,
                                           const float* __restrict__ po2, int depth,
                                           bool nearest) {
  float acc = 0.0f;
  float count = 0.0f;
  if constexpr (PACKED) {
    const unsigned word =
        static_cast<const uint8_t*>(hist)[static_cast<size_t>(lane) * n + idx];
    for (int k = 0; k < depth; ++k) {
      const float bit = static_cast<float>((word >> (7 - k)) & 1u);
      acc = read_step(acc, count, bit, po2[k], nearest);
    }
  } else {
    const float* planes = static_cast<const float*>(hist) +
                          static_cast<size_t>(lane) * depth * n + idx;
    for (int k0 = 0; k0 < depth; k0 += CHUNK) {
      float bits[CHUNK];
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        bits[q] = k0 + q < depth ? planes[static_cast<size_t>(k0 + q) * n] : 0.0f;
      }
#pragma unroll
      for (int q = 0; q < CHUNK; ++q) {
        if (k0 + q < depth) acc = read_step(acc, count, bits[q], po2[k0 + q], nearest);
      }
    }
  }
  return acc;
}

// The register read as dense::update's magnitude: a neuron's staged value is
// its po2 magnitude, read once per block.
template <bool PACKED>
struct Po2Magnitude {
  const float* pre_spike;
  const float* post_spike;
  const void* pre_hist;
  const void* post_hist;
  const float* po2_ltp;
  const float* po2_ltd;
  int n_pre, n_post, depth;
  bool nearest;

  __device__ __forceinline__ dense::Side pre(int lane, int i) const {
    return {magnitude<PACKED>(pre_hist, lane, n_pre, i, po2_ltp, depth, nearest),
            pre_spike[static_cast<size_t>(lane) * n_pre + i]};
  }
  __device__ __forceinline__ dense::Side post(int lane, int j) const {
    return {magnitude<PACKED>(post_hist, lane, n_post, j, po2_ltd, depth, nearest),
            post_spike[static_cast<size_t>(lane) * n_post + j]};
  }
  __device__ __forceinline__ float ltp_mag(float v) const { return v; }
  __device__ __forceinline__ float ltd_mag(float v) const { return v; }
};

// 6 blocks an SM hold registers to 80: four float4 of w stay live through
// the magnitude reads
template <bool PACKED, int VEC>
__global__ void __launch_bounds__(dense::THREADS, 6)
itp_stdp_kernel(float* w_out, const float* w,  // may alias: in place
                const float* __restrict__ pre_spike,
                const float* __restrict__ post_spike,
                const void* __restrict__ pre_hist,
                const void* __restrict__ post_hist,
                const float* __restrict__ po2_ltp,
                const float* __restrict__ po2_ltd, int depth, int nearest, float eta,
                float w_min, float w_max, dense::Plan plan) {
  extern __shared__ __align__(16) char smem[];
  const Po2Magnitude<PACKED> mag{pre_spike, post_spike, pre_hist, post_hist, po2_ltp,
                                 po2_ltd, plan.n_pre, plan.n_post, depth, nearest != 0};
  dense::update<SLOTS, VEC>(w_out, w, eta, w_min, w_max, plan, mag, smem);
}

template <bool PACKED>
int launch(float* w_out, const float* w, const float* pre_spike,
           const float* post_spike, const void* pre_hist, const void* post_hist,
           const float* po2_ltp, const float* po2_ltd, int lanes, int n_pre,
           int n_post, int depth, int nearest, float eta, float w_min,
           float w_max, int device, void* stream) {
  return dense::launch<SLOTS>(itp_stdp_kernel<PACKED, 4>, itp_stdp_kernel<PACKED, 1>, w_out, w,
                              lanes, n_pre, n_post, 0, device, stream, pre_spike, post_spike,
                              pre_hist, post_hist, po2_ltp, po2_ltd, depth, nearest, eta,
                              w_min, w_max);
}

}  // namespace

extern "C" {

// w, w_out: (lanes, n_pre, n_post) f32; spikes: (lanes, n) f32 {0,1};
// words: (lanes, n) uint8, register slot k at bit 7-k; po2: (depth,) f32.
// Returns the cudaError_t of the launch (0 = success).
int itp_stdp_update_packed(float* w_out, const float* w, const float* pre_spike,
                           const float* post_spike, const uint8_t* pre_words,
                           const uint8_t* post_words, const float* po2_ltp,
                           const float* po2_ltd, int lanes, int n_pre, int n_post,
                           int depth, int nearest, float eta, float w_min,
                           float w_max, int device, void* stream) {
  return launch<true>(w_out, w, pre_spike, post_spike, pre_words, post_words,
                      po2_ltp, po2_ltd, lanes, n_pre, n_post, depth, nearest,
                      eta, w_min, w_max, device, stream);
}

// As above, with (lanes, depth, n) f32 bitplanes, k = 0 row the newest.
int itp_stdp_update(float* w_out, const float* w, const float* pre_spike,
                    const float* post_spike, const float* pre_hist,
                    const float* post_hist, const float* po2_ltp,
                    const float* po2_ltd, int lanes, int n_pre, int n_post,
                    int depth, int nearest, float eta, float w_min, float w_max,
                    int device, void* stream) {
  return launch<false>(w_out, w, pre_spike, post_spike, pre_hist, post_hist,
                       po2_ltp, po2_ltd, lanes, n_pre, n_post, depth, nearest,
                       eta, w_min, w_max, device, stream);
}

const char* itp_stdp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// against a handful of flops, far below the card's ~20 flop/B balance point
// for float32; the per-neuron history (1 B word or 4*depth B of bitplanes)
// and spikes are O(n), not O(n^2).  Design: one thread per (lane, i, j)
// synapse, a block covering TILE_PRE rows x TILE_POST columns of one lane's
// w, with a warp along the contiguous post axis so w loads and stores are
// coalesced.  The block first reads the po2 magnitudes of its TILE_PRE pre
// rows and TILE_POST post columns into shared memory (unpack
// (word >> (7-k)) & 1, nearest mask = first set bit, po2 sum k = 0..depth-1
// in float32), so each magnitude is computed once per block, not once per
// synapse.  Ragged edges are masked here; the wrapper pads nothing.
//
// Arithmetic is written with __fmul_rn / __fadd_rn / __fsub_rn so nvcc
// cannot contract it into FMAs: the plain PyTorch version rounds after every
// multiply and add, and with an eta that is not a power of two an FMA would
// round differently.
//
// In place: each thread reads its w element before writing the same
// element, so w_out may alias w.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_POST = 32;  // columns per block: one warp along a w row
constexpr int TILE_PRE = 8;    // rows per block

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
__device__ __forceinline__ float magnitude(const void* hist, int lane, int n,
                                           int idx, const float* __restrict__ po2,
                                           int depth, bool nearest) {
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
    for (int k = 0; k < depth; ++k) {
      acc = read_step(acc, count, planes[static_cast<size_t>(k) * n], po2[k], nearest);
    }
  }
  return acc;
}

template <bool PACKED>
__global__ void __launch_bounds__(TILE_PRE * TILE_POST)
itp_stdp_kernel(float* w_out, const float* w,  // may alias: in place
                const float* __restrict__ pre_spike,
                const float* __restrict__ post_spike,
                const void* __restrict__ pre_hist,
                const void* __restrict__ post_hist,
                const float* __restrict__ po2_ltp,
                const float* __restrict__ po2_ltd, int n_pre, int n_post,
                int depth, int nearest, float eta, float w_min, float w_max) {
  __shared__ float ltp_mag[TILE_PRE];
  __shared__ float ltd_mag[TILE_POST];
  const int lane = blockIdx.z;
  const int i0 = blockIdx.y * TILE_PRE;
  const int j0 = blockIdx.x * TILE_POST;
  const int tid = threadIdx.y * TILE_POST + threadIdx.x;

  if (tid < TILE_PRE) {
    const int i = i0 + tid;
    ltp_mag[tid] = (i < n_pre)
        ? magnitude<PACKED>(pre_hist, lane, n_pre, i, po2_ltp, depth, nearest != 0)
        : 0.0f;
  } else if (tid < TILE_PRE + TILE_POST) {
    const int c = tid - TILE_PRE;
    const int j = j0 + c;
    ltd_mag[c] = (j < n_post)
        ? magnitude<PACKED>(post_hist, lane, n_post, j, po2_ltd, depth, nearest != 0)
        : 0.0f;
  }
  __syncthreads();

  const int i = i0 + threadIdx.y;
  const int j = j0 + threadIdx.x;
  if (i >= n_pre || j >= n_post) return;

  const bool pre_s = pre_spike[static_cast<size_t>(lane) * n_pre + i] != 0.0f;
  const bool post_s = post_spike[static_cast<size_t>(lane) * n_post + j] != 0.0f;
  const bool fire_xor = pre_s != post_s;
  const float ltp_en = (fire_xor && post_s) ? 1.0f : 0.0f;  // post fired alone
  const float ltd_en = (fire_xor && pre_s) ? 1.0f : 0.0f;   // pre fired alone
  const float dw = __fsub_rn(__fmul_rn(ltp_en, ltp_mag[threadIdx.y]),
                             __fmul_rn(ltd_en, ltd_mag[threadIdx.x]));

  const size_t at = (static_cast<size_t>(lane) * n_pre + i) * n_post + j;
  const float x = __fadd_rn(w[at], __fmul_rn(eta, dw));
  w_out[at] = fminf(fmaxf(x, w_min), w_max);
}

template <bool PACKED>
int launch(float* w_out, const float* w, const float* pre_spike,
           const float* post_spike, const void* pre_hist, const void* post_hist,
           const float* po2_ltp, const float* po2_ltd, int lanes, int n_pre,
           int n_post, int depth, int nearest, float eta, float w_min,
           float w_max, int device, void* stream) {
  if (lanes <= 0 || n_pre <= 0 || n_post <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 block(TILE_POST, TILE_PRE);
  const dim3 grid((n_post + TILE_POST - 1) / TILE_POST,
                  (n_pre + TILE_PRE - 1) / TILE_PRE, lanes);
  itp_stdp_kernel<PACKED><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      w_out, w, pre_spike, post_spike, pre_hist, post_hist, po2_ltp, po2_ltd,
      n_pre, n_post, depth, nearest, eta, w_min, w_max);
  return static_cast<int>(cudaGetLastError());
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

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
// one resident VMEM block; blocks on the card run in no order, so M is cut
// into fixed chunks of CHUNK_M rows instead.  Block (c-tile, k-tile, chunk)
// walks its chunk TILE_M rows at a time: it loads the rows' pre spikes and
// post spikes, computes their gated magnitudes (1-pre)*ltp_mag and
// (1-post)*ltd_mag into shared memory, and each thread adds the rows' two
// terms to the sum of its one (k, c) output.  The chunk's partial goes to a
// (S, K, C) scratch tensor the wrapper allocates; a second kernel sums the S
// partials of each (k, c) in chunk order.  No atomics.  Ragged M, K and C
// are masked here; the wrapper pads nothing.
//
// Arithmetic: no tensor cores (TF32 would drop the po2 sums' low bits).  The
// magnitudes are float32, written with __fmul_rn/__fadd_rn so nvcc does not
// contract them into FMAs.  Spikes are {0,1}, so every product term of the
// contractions is an exact float32 value, and the terms span few binades: a
// double holds their sum over millions of rows exactly.  So the kernel
// accumulates the terms and the partials in double and rounds the (K, C)
// delta to float32 once.  The result is the correctly rounded exact sum,
// whatever the order: two runs, the packed and unpacked kernels, and the
// plain version (which contracts in float64) agree bit for bit.  Double adds
// run at half the float32 rate, which does not matter for a kernel bound by
// memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_K = 32;    // patch elements per block (threadIdx.y)
constexpr int TILE_C = 8;     // output channels per block (threadIdx.x)
constexpr int TILE_M = 32;    // patch rows staged in shared memory at a time
constexpr int CHUNK_M = 256;  // patch rows per block: one partial per chunk
constexpr int THREADS = TILE_K * TILE_C;
constexpr int REDUCE_THREADS = 256;

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

template <bool PACKED>
__global__ void __launch_bounds__(THREADS)
conv_delta_partial(double* __restrict__ partial,      // (S, K, C)
                   const float* __restrict__ pre,     // (M, K)
                   const float* __restrict__ post,    // (M, C)
                   const void* __restrict__ pre_hist,   // (M, K) u8 | (depth, M, K) f32
                   const void* __restrict__ post_hist,  // (M, C) u8 | (depth, M, C) f32
                   const float* __restrict__ po2_ltp,
                   const float* __restrict__ po2_ltd, int M, int K, int C,
                   int depth, int nearest) {
  __shared__ float s_pre[TILE_M][TILE_K];
  __shared__ float s_ltp[TILE_M][TILE_K];   // (1 - pre) * ltp_mag
  __shared__ float s_post[TILE_M][TILE_C];
  __shared__ float s_ltd[TILE_M][TILE_C];   // (1 - post) * ltd_mag

  const int c0 = blockIdx.x * TILE_C;
  const int k0 = blockIdx.y * TILE_K;
  const int chunk = blockIdx.z;
  const int m_begin = chunk * CHUNK_M;
  const int m_end = min(m_begin + CHUNK_M, M);
  const int tid = threadIdx.y * TILE_C + threadIdx.x;

  double sum = 0.0;
  for (int m0 = m_begin; m0 < m_end; m0 += TILE_M) {
    for (int i = tid; i < TILE_M * TILE_K; i += THREADS) {
      const int r = i / TILE_K, x = i % TILE_K;
      const int m = m0 + r, k = k0 + x;
      float p = 0.0f, g = 0.0f;
      if (m < m_end && k < K) {
        p = pre[static_cast<size_t>(m) * K + k];
        const float mag = magnitude<PACKED>(pre_hist, m, k, M, K, po2_ltp, depth,
                                            nearest != 0);
        g = __fmul_rn(__fsub_rn(1.0f, p), mag);
      }
      s_pre[r][x] = p;
      s_ltp[r][x] = g;
    }
    for (int i = tid; i < TILE_M * TILE_C; i += THREADS) {
      const int r = i / TILE_C, x = i % TILE_C;
      const int m = m0 + r, c = c0 + x;
      float q = 0.0f, g = 0.0f;
      if (m < m_end && c < C) {
        q = post[static_cast<size_t>(m) * C + c];
        const float mag = magnitude<PACKED>(post_hist, m, c, M, C, po2_ltd, depth,
                                            nearest != 0);
        g = __fmul_rn(__fsub_rn(1.0f, q), mag);
      }
      s_post[r][x] = q;
      s_ltd[r][x] = g;
    }
    __syncthreads();
    const int rows = min(TILE_M, m_end - m0);
    for (int r = 0; r < rows; ++r) {   // exact: float32 terms into a double
      sum += static_cast<double>(__fmul_rn(s_ltp[r][threadIdx.y], s_post[r][threadIdx.x]));
      sum -= static_cast<double>(__fmul_rn(s_pre[r][threadIdx.y], s_ltd[r][threadIdx.x]));
    }
    __syncthreads();
  }

  const int k = k0 + threadIdx.y;
  const int c = c0 + threadIdx.x;
  if (k < K && c < C) {
    partial[(static_cast<size_t>(chunk) * K + k) * C + c] = sum;
  }
}

// out[i] = sum_s partial[s, i], s ascending, rounded to float32 once.
__global__ void __launch_bounds__(REDUCE_THREADS)
conv_delta_reduce(float* __restrict__ out, const double* __restrict__ partial,
                  int chunks, int n) {
  const int i = blockIdx.x * REDUCE_THREADS + threadIdx.x;
  if (i >= n) return;
  double sum = 0.0;
  for (int s = 0; s < chunks; ++s) {
    sum += partial[static_cast<size_t>(s) * n + i];
  }
  out[i] = __double2float_rn(sum);
}

template <bool PACKED>
int launch(float* out, double* partial, const float* pre, const float* post,
           const void* pre_hist, const void* post_hist, const float* po2_ltp,
           const float* po2_ltd, int M, int K, int C, int depth, int nearest,
           int device, void* stream) {
  if (K <= 0 || C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int chunks = (M + CHUNK_M - 1) / CHUNK_M;
  const int n = K * C;
  if (chunks == 0) {
    err = cudaMemsetAsync(out, 0, sizeof(float) * n, s);
    return static_cast<int>(err);
  }
  const dim3 block(TILE_C, TILE_K);
  const dim3 grid((C + TILE_C - 1) / TILE_C, (K + TILE_K - 1) / TILE_K, chunks);
  conv_delta_partial<PACKED><<<grid, block, 0, s>>>(
      partial, pre, post, pre_hist, post_hist, po2_ltp, po2_ltd, M, K, C, depth,
      nearest);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_delta_reduce<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
      out, partial, chunks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Rows per partial: the wrapper allocates partial as (chunks, K, C) float64
// with chunks = ceil(M / itp_stdp_conv_chunk_rows()).
int itp_stdp_conv_chunk_rows() { return CHUNK_M; }

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

// The split-M gated patch-row contraction shared by the conv-delta kernels
// (itp_stdp_conv.cu: ITP register reads; itp_counter.cu: counter windows).
//
// For M patch rows (batch x output positions), K patch elements and C output
// channels, with per-element magnitudes pre_mag (M, K) and post_mag (M, C):
//
//   dw[k, c] = sum_m (1 - pre[m, k]) * pre_mag[m, k] * post[m, c]
//            - sum_m pre[m, k] * (1 - post[m, c]) * post_mag[m, c]
//
// (potentiate where post fired alone, depress where pre fired alone).  The
// kernels differ only in how an element's magnitude is read; each passes a
// functor mag(m, x) to partial_chunk().
//
// Design.  Blocks on the card run in no order, so M is cut into fixed chunks
// of CHUNK_M rows.  Block (c-tile, k-tile, chunk) walks its chunk TILE_M rows
// at a time: it loads the rows' pre and post spikes, computes their gated
// magnitudes (1-pre)*pre_mag and (1-post)*post_mag into shared memory, and
// each thread adds the rows' two terms to the sum of its one (k, c) output.
// The chunk's partial goes to a (S, K, C) float64 scratch tensor the wrapper
// allocates; conv_delta_reduce sums the S partials of each (k, c) in chunk
// order.  No atomics.  Ragged M, K and C are masked here; nothing is padded.
//
// Arithmetic: no tensor cores.  The gated magnitudes are float32, written
// with __fmul_rn/__fsub_rn so nvcc does not contract them into FMAs.  Spikes
// are {0,1}, so every product term is an exact float32 value; the terms and
// partials are summed in double and the (K, C) delta is rounded to float32
// once.  Where the magnitudes span few binades (a double holds their sum over
// millions of rows exactly) the result is the correctly rounded exact sum,
// whatever the order, and equals the plain version's float64 contraction bit
// for bit; otherwise it is deterministic run to run.
#pragma once

#include <cuda_runtime.h>

namespace gated {

constexpr int TILE_K = 32;    // patch elements per block (threadIdx.y)
constexpr int TILE_C = 8;     // output channels per block (threadIdx.x)
constexpr int TILE_M = 32;    // patch rows staged in shared memory at a time
constexpr int CHUNK_M = 256;  // patch rows per block: one partial per chunk
constexpr int THREADS = TILE_K * TILE_C;
constexpr int REDUCE_THREADS = 256;

// The body of a partial kernel: block (blockIdx.x, blockIdx.y, blockIdx.z) =
// (c-tile, k-tile, chunk) writes partial[chunk, k, c] for its (k, c) tile.
template <class PreMag, class PostMag>
__device__ __forceinline__ void partial_chunk(double* __restrict__ partial,   // (S, K, C)
                                              const float* __restrict__ pre,  // (M, K)
                                              const float* __restrict__ post, // (M, C)
                                              const PreMag& pre_mag,
                                              const PostMag& post_mag, int M, int K,
                                              int C) {
  __shared__ float s_pre[TILE_M][TILE_K];
  __shared__ float s_ltp[TILE_M][TILE_K];   // (1 - pre) * pre_mag
  __shared__ float s_post[TILE_M][TILE_C];
  __shared__ float s_ltd[TILE_M][TILE_C];   // (1 - post) * post_mag

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
        g = __fmul_rn(__fsub_rn(1.0f, p), pre_mag(m, k));
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
        g = __fmul_rn(__fsub_rn(1.0f, q), post_mag(m, c));
      }
      s_post[r][x] = q;
      s_ltd[r][x] = g;
    }
    __syncthreads();
    const int rows = min(TILE_M, m_end - m0);
    for (int r = 0; r < rows; ++r) {   // float32 terms into a double
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

inline int chunks(int M) { return (M + CHUNK_M - 1) / CHUNK_M; }

// Both passes on `stream`: launch_partial(grid, block, stream) launches the
// caller's partial kernel, then the ordered reduce.  Returns the cudaError_t
// of the launches (0 = success).  M = 0 gives a zero delta.
template <class LaunchPartial>
int launch(float* out, double* partial, int M, int K, int C, int device, void* stream,
           LaunchPartial launch_partial) {
  if (K <= 0 || C <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_chunks = chunks(M);
  const int n = K * C;
  if (n_chunks == 0) {
    return static_cast<int>(cudaMemsetAsync(out, 0, sizeof(float) * n, s));
  }
  const dim3 block(TILE_C, TILE_K);
  const dim3 grid((C + TILE_C - 1) / TILE_C, (K + TILE_K - 1) / TILE_K, n_chunks);
  launch_partial(grid, block, s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  conv_delta_reduce<<<(n + REDUCE_THREADS - 1) / REDUCE_THREADS, REDUCE_THREADS, 0, s>>>(
      out, partial, n_chunks, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gated

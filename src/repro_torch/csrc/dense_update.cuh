// The dense weight update shared by kernels 1-2 (itp_stdp.cu: ITP register
// reads) and kernel 5 (itp_counter.cu: counter windows).
//
// For `lanes` independent engines, w (lanes, n_pre, n_post) float32:
//
//   w_out[l, i, j] = clip(w[l, i, j] + eta * (ltp_en * ltp(l, i) - ltd_en * ltd(l, j)))
//
// with the XOR pair gate on the current spikes (ltp_en where the post neuron
// fired alone, ltd_en where the pre neuron fired alone).  The kernels differ
// in the element magnitude, a functor built in the kernel body:
//   Side pre(lane, i) / post(lane, j): a neuron's staged value and spike,
//     read from device memory once per block (ITP: its register read;
//     counter: its raw counter word);
//   float ltp_mag(v) / ltd_mag(v): the synapse's magnitude from the staged value
//     (ITP: v itself; counter: the window of the counter, per pair).
//
// What bounds it.  Each synapse's weight is read and written once as float32
// (8 B) against a handful of operations: bytes, 3.0 us at the 2layer-snn fc
// shape (16 x 784 x 100) on the card's 3.35 TB/s.  The one-thread-per-synapse
// design this replaces kept too few bytes in flight (4 B loads, a fifth of
// the threads idle at n_post = 100) and paid two dependent round trips per
// block (history reads, a block sync, then the w load).
//
// Design.
//   * Tiles.  A block owns a tile of one lane: `rows` rows x `cols` columns,
//     whole rows (cols = n_post) up to one block's reach, rows chosen so the
//     tile is THREADS * SLOTS vectors, one contiguous range of w at the fc
//     and serving shapes.  Tiles are
//     numbered lane-major, then column block, then row block, on a 1-D grid,
//     so the number of lanes is not bound to the grid's 65,535 in y or z.
//   * Bytes in flight, one round trip.  Each thread first issues the loads
//     of its SLOTS vectors of w straight into registers (16-byte loads where
//     n_post % 4 == 0 and w is 16-byte aligned; else the masked 4-byte path,
//     VEC = 1; the wrapper pads nothing), then the tile's neuron reads (the
//     pre rows', the post columns'), which go out while the w loads fly;
//     one block sync, then each synapse is updated in registers and stored
//     (16-byte stores where w_out allows).  SLOTS is the kernel's: the ITP
//     kernels, a few operations a synapse, take 4 (8 KB of w in flight a
//     block); the counter kernels, whose per-pair windows make them
//     compute-heavy (two double exps a synapse for exact), take 1, for four
//     times the threads.  Measured slower on the card (PERF.md, PR 16): a
//     first design that staged w through shared memory with cp.async,
//     double-buffered in persistent blocks (three block syncs per strip and
//     a serial per-synapse loop cost more than the overlap gained); for the
//     counter, one synapse a thread (4-byte tiles, 1.4-2.5x slower) and a
//     vector's synapses one by one through shared memory.
//   * Post side once per tile.  The tile's post columns are read once for
//     all its rows (16-32 at the fc shapes for the ITP kernels; 8 before),
//     its pre rows once.
//   * Per synapse.  The functor's ltp_mag / ltd_mag run for every synapse:
//     the counter windows stay two per synapse (itp_counter.cu keeps each
//     evaluation distinct, so nvcc cannot merge the four LTP windows of a
//     16-byte vector, whose synapses share a row).
//   * In place and safe.  Each thread loads its own elements before it
//     stores them and tiles are disjoint, so w_out may alias w; no atomics,
//     nothing kept on the card across calls; one launch per call.
//
// Arithmetic is __fmul_rn / __fadd_rn / __fsub_rn, so nvcc forms no FMA and
// every step rounds as the plain PyTorch versions round it.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>

namespace dense {

constexpr int THREADS = 128;
constexpr int MAX_ROWS = 1024;     // rows per tile

// A neuron's staged value (a magnitude, or a counter word's bits) and spike.
struct __align__(8) Side {
  float v;
  float spike;
};

// Launch plan, computed on the host and passed by value: the grid is
// lanes * col_blocks * row_blocks tiles of rows x cols.
struct Plan {
  int n_pre, n_post;
  int rows, cols, row_blocks, col_blocks;
  int post_at, param_at;   // dynamic shared memory: pre sides, post sides, parameters
};

template <int VEC>
struct Vec;
template <>
struct Vec<4> {
  using T = float4;
  __device__ static float& at(T& v, int q) { return (&v.x)[q]; }
};
template <>
struct Vec<1> {
  using T = float;
  __device__ static float& at(T& v, int) { return v; }
};

// The kernel body: this block's tile, SLOTS vectors of w a thread.
template <int SLOTS, int VEC, class Mag>
__device__ __forceinline__ void update(float* w_out, const float* w, float eta, float w_min,
                                       float w_max, const Plan& p, const Mag& mag, char* smem) {
  using V = typename Vec<VEC>::T;
  const int tid = threadIdx.x;
  Side* s_pre = reinterpret_cast<Side*>(smem);
  Side* s_post = reinterpret_cast<Side*>(smem + p.post_at);
  const int t = blockIdx.x;
  const int rb = t % p.row_blocks, lc = t / p.row_blocks;
  const int cb = lc % p.col_blocks, lane = lc / p.col_blocks;
  const int i0 = rb * p.rows, j0 = cb * p.cols;
  const int nr = min(p.rows, p.n_pre - i0), nc = min(p.cols, p.n_post - j0);
  const size_t at = (static_cast<size_t>(lane) * p.n_pre + i0) * p.n_post + j0;
  const int per_row = nc / VEC;   // vectors per row
  const int nv = nr * per_row;

  V v[SLOTS];
#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {   // every load issued before any is used
    const int s = tid + u * THREADS, r = s / per_row, x = (s - r * per_row) * VEC;
    if (s < nv) v[u] = *reinterpret_cast<const V*>(w + at + static_cast<size_t>(r) * p.n_post + x);
  }
  // the tile's neurons, read while the w loads fly
  for (int i = tid; i < nr; i += THREADS) s_pre[i] = mag.pre(lane, i0 + i);
  for (int j = tid; j < nc; j += THREADS) s_post[j] = mag.post(lane, j0 + j);
  __syncthreads();

#pragma unroll
  for (int u = 0; u < SLOTS; ++u) {
    const int s = tid + u * THREADS, r = s / per_row, x = (s - r * per_row) * VEC;
    if (s < nv) {
      const Side a = s_pre[r];
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        const Side c = s_post[x + q];
        const float ltp = mag.ltp_mag(a.v), ltd = mag.ltd_mag(c.v);
        const bool pre_s = a.spike != 0.0f, post_s = c.spike != 0.0f;
        const bool fire_xor = pre_s != post_s;
        const float ltp_en = (fire_xor && post_s) ? 1.0f : 0.0f;   // post fired alone
        const float ltd_en = (fire_xor && pre_s) ? 1.0f : 0.0f;    // pre fired alone
        const float dw = __fsub_rn(__fmul_rn(ltp_en, ltp), __fmul_rn(ltd_en, ltd));
        float& y = Vec<VEC>::at(v[u], q);
        y = fminf(fmaxf(__fadd_rn(y, __fmul_rn(eta, dw)), w_min), w_max);
      }
      *reinterpret_cast<V*>(w_out + at + static_cast<size_t>(r) * p.n_post + x) = v[u];
    }
  }
}

inline int align16(long n) { return static_cast<int>((n + 15) / 16 * 16); }

// Plans and launches kernel4 (VEC = 4) or kernel1 (VEC = 1), each a kernel
// whose body is update<SLOTS, VEC>, as kernel(w_out, w, args..., plan) on
// `stream`.  params: floats per side the kernel stages after the sides (the
// imstdp table).  Returns the cudaError_t (0 = success); an empty w
// launches nothing.
template <int SLOTS, class... KArgs, class... Args>
int launch(void (*kernel4)(KArgs...), void (*kernel1)(KArgs...), float* w_out, const float* w,
           int lanes, int n_pre, int n_post, int params, int device, void* stream,
           Args... args) {
  if (lanes <= 0 || n_pre <= 0 || n_post <= 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec4 = n_post % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(w_out) % 16 == 0;
  const int reach = THREADS * SLOTS * (vec4 ? 4 : 1);   // floats a block updates
  Plan p{};
  p.n_pre = n_pre;
  p.n_post = n_post;
  p.cols = n_post < reach ? n_post : reach;
  p.rows = reach / p.cols;
  p.rows = p.rows < MAX_ROWS ? p.rows : MAX_ROWS;
  p.rows = p.rows < n_pre ? p.rows : n_pre;
  p.row_blocks = (n_pre + p.rows - 1) / p.rows;
  p.col_blocks = (n_post + p.cols - 1) / p.cols;
  const long tiles = static_cast<long>(lanes) * p.row_blocks * p.col_blocks;
  if (tiles > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  p.post_at = align16(static_cast<long>(sizeof(Side)) * p.rows);
  p.param_at = p.post_at + align16(static_cast<long>(sizeof(Side)) * p.cols);
  const int smem = p.param_at + align16(2L * 4 * params);   // at most ~18 KB: no opt-in

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tiles));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(&cfg, vec4 ? kernel4 : kernel1, w_out, w, args..., p);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace dense

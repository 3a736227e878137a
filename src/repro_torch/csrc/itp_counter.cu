// Fused counter-rule (explicit-Delta-t STDP) kernels for Hopper (sm_90a),
// plain C interface: the conventional learning datapath the paper measures
// ITP-STDP against (Tables III-V).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/itp_counter/kernel.py:
//   counter_stdp_update (dense: clip(w + eta * dw) over the synapse matrix)
//   counter_conv_delta  (im2col conv: the raw (K, C) delta summed over M);
// and adds one that replaces no TPU kernel:
//   counter_fc_delta    (an SNN fc layer: the raw (n_pre, n_post) delta of
//                        (B, n) words and spikes, summed over the B lanes).
// A neuron's timing state is one uint8 last-spike counter word: t steps since
// its last spike, saturated at depth; the delay is live while t <= depth-1.
// The window of a delay t (one per side, LTP from the pre counter, LTD from
// the post counter):
//   exact  : A * exp(-t / tau)            (the float32 quotient, exp taken in
//                                           double, rounded to float once)
//   linear : A * clip(1 - t / (2 tau), 0, 1)    (the PWL rule of [24])
//   imstdp : lut[min(t, depth-1)]          (the [23] LUT, (2, depth) float32,
//                                           built on the host with the exact
//                                           formula)
// times the validity gate.  All float arithmetic is __fdiv_rn / __fsub_rn /
// __fmul_rn / __fadd_rn, so nvcc forms no FMA and every step rounds as the
// plain PyTorch version (kernels/itp_counter/ref.py) rounds it.
//
// The window is evaluated PER PAIR, in the kernel body, as the Pallas
// kernel's _pair_window does: each synapse's thread forms both delays from
// the counter words and evaluates both windows itself.  That per-pair
// transcendental / PWL / table read is the measured cost of the counter
// datapath (the O(n^2) work the ITP register read collapses to O(n)); it is
// deliberately NOT hoisted into a per-neuron table in shared memory, which
// would make this baseline cheaper than the paper measures it and erase the
// kernel-against-kernel comparison with itp_stdp.cu.  Only the imstdp table
// itself is staged into shared memory, once per block, from the device
// pointer the wrapper passes (not __constant__ memory written per call: two
// launches with different tables on two streams would race).
//
// counter_stdp_update.  Bound: memory.  Each synapse's weight is read and
// written once as float32 (8 B); the words, spikes and table are O(n).  The
// per-pair window adds a double exp (exact) or a few float ops per synapse.
// Design: the tile-streaming routine of dense_update.cuh, shared with
// itp_stdp.cu (each thread's 16-byte vectors of w loaded into registers
// before anything else, 16-byte stores, all lanes in one launch, ragged
// edges masked in the kernel), with the window as the element magnitude.  A
// block stages the raw counter words and spikes of its tile's neurons, not
// their windows: every synapse evaluates both of its windows itself.  The
// four synapses of a 16-byte vector share a row, so their LTP windows have
// one argument; each evaluation first passes its counter through an empty
// asm statement that nvcc must assume changes it, so no two evaluations are
// merged and every synapse pays two, as the paper's per-pair datapath does.
// w_out may alias w.
//
// counter_conv_delta.  The one-launch cooperative contraction of
// gated_sum.cuh (the design of itp_stdp_conv.cu) with the counter window as
// the element magnitude: every co-resident block evaluates each of its rows'
// windows once for all K x C outputs (into shared memory, while cp.async
// stages the next rows), sums them into 16 independent double accumulators a
// thread, and the lanes and blocks are added in a fixed order in the same
// kernel (a per-call float64 scratch, a grid sync), no atomics, no padding.
// Each element's window is still evaluated in the kernel, as kernel 3 reads
// each element's register once, so the two remain the paper's datapath
// comparison on one contraction design.  Every term is a float32 window
// value or 0; at depth 7 the values span a few binades and the double sums
// are exact (bit-equal to the plain version's float64 contraction); at a
// large depth (255 with tau = 4 spans ~90 binades) the fixed order keeps the
// sum equal run to run and within the reference's tolerance of the plain
// version.  Bound: latency, as itp_stdp_conv.cu.
//
// counter_fc_delta.  It exists because the per-lane array was the cost: the
// fc layers' batch sum used to run kernel 5 over a zero-filled (B, n_pre,
// n_post) array and sum it in float64 outside (at 256 x 784 x 6,400 a 5.1 GB
// array, its fill, a 10.3 GB float64 cast and a reduction, three quarters of
// the step).  Here each thread keeps one float64 accumulator for each of its
// synapses, walks the lanes in ascending order, evaluates both windows of
// every (lane, i, j) pair through window<W> and CounterWindow (the asm
// barrier, the same staged words and spikes as kernel 5; both windows whether
// or not the pair gate is open), adds the XOR pair gate's float32 term, and
// rounds once into the (n_pre, n_post) output: one launch, no per-lane array,
// no scratch.  The per-pair windows stay, so the comparison with ITP's
// register read is still the paper's per-pair datapath.  Bound: the per-pair
// double exps and float<->double conversions and the float64 adds (two window
// evaluations and one add a pair), not bytes: the words and spikes of all
// lanes are 5 bytes a neuron and stay in L2.  Design: a block owns a tile of
// FC_ROWS x FC_COLS synapses (a warp spans 32 columns, each thread FC_RPT rows
// of one column); the tile's pre and post sides are staged into shared memory
// FC_LANES lanes at a time, double-buffered, so one block sync a chunk
// separates the staging of the next chunk from the reads of this one.  The
// tiles alone give thousands of blocks at the main path's shape, so the lanes
// are not split across blocks; at the batch-16 fc shapes a call is a few
// microseconds of pair work.  Every term is a float32 window value or 0; at
// depth 7 the float64 sums are exact (bit-equal to the plain version's sum of
// kernel 5's lanes); at depth 255 the fixed lane order keeps the sum equal run
// to run and within the reference's tolerance.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <climits>

#include "dense_update.cuh"
#include "gated_sum.cuh"

namespace {

constexpr int MAX_DEPTH = 255; // counter words are uint8
constexpr int SLOTS = 1;       // 16-byte vectors of w a thread (dense_update.cuh): the
                               // windows are the work, so threads before bytes in flight

enum Window { EXACT = 0, LINEAR = 1, IMSTDP = 2 };

// One side's window parameters (LTP: a_plus/tau_plus, LTD: a_minus/tau_minus).
struct Side {
  float amp, tau, two_tau;
  const float* lut;   // (depth,) table row, in shared memory (imstdp only)
};

// Window magnitude of counter value t, gated by validity (t <= depth - 1).
template <int W>
__device__ __forceinline__ float window(unsigned t, const Side& s, int depth) {
  float mag;
  if constexpr (W == EXACT) {
    const float arg = __fdiv_rn(-static_cast<float>(t), s.tau);
    mag = __fmul_rn(s.amp, __double2float_rn(exp(static_cast<double>(arg))));
  } else if constexpr (W == LINEAR) {
    const float x = __fsub_rn(1.0f, __fdiv_rn(static_cast<float>(t), s.two_tau));
    mag = __fmul_rn(s.amp, fminf(fmaxf(x, 0.0f), 1.0f));
  } else {
    mag = s.lut[min(static_cast<int>(t), depth - 1)];
  }
  const float valid = (static_cast<int>(t) <= depth - 1) ? 1.0f : 0.0f;
  return __fmul_rn(mag, valid);
}

// The counter words as dense::update's magnitude: a neuron's staged value is
// its raw counter (as the bits of a float), its window evaluated per synapse.
template <int W>
struct CounterWindow {
  const float* pre_spike;
  const float* post_spike;
  const uint8_t* pre_words;
  const uint8_t* post_words;
  Side ltp, ltd;
  int n_pre, n_post, depth;

  __device__ __forceinline__ dense::Side pre(int lane, int i) const {
    const size_t at = static_cast<size_t>(lane) * n_pre + i;
    return {__uint_as_float(pre_words[at]), pre_spike[at]};
  }
  __device__ __forceinline__ dense::Side post(int lane, int j) const {
    const size_t at = static_cast<size_t>(lane) * n_post + j;
    return {__uint_as_float(post_words[at]), post_spike[at]};
  }
  // each call a distinct evaluation: the asm hides that two counters are equal
  __device__ __forceinline__ float ltp_mag(float v) const {
    unsigned t = __float_as_uint(v);
    asm volatile("" : "+r"(t));
    return window<W>(t, ltp, depth);
  }
  __device__ __forceinline__ float ltd_mag(float v) const {
    unsigned t = __float_as_uint(v);
    asm volatile("" : "+r"(t));
    return window<W>(t, ltd, depth);
  }
};

// 12 blocks an SM hold registers to 40: more threads, for the windows
template <int W, int VEC>
__global__ void __launch_bounds__(dense::THREADS, 12)
counter_stdp_kernel(float* w_out, const float* w,  // may alias: in place
                    const float* __restrict__ pre_spike,
                    const float* __restrict__ post_spike,
                    const uint8_t* __restrict__ pre_words,
                    const uint8_t* __restrict__ post_words,
                    const float* __restrict__ lut, Side ltp, Side ltd, int depth, float eta,
                    float w_min, float w_max, dense::Plan plan) {
  extern __shared__ __align__(16) char smem[];
  if constexpr (W == IMSTDP) {   // the (2, depth) table; read only after update's first sync
    float* s_lut = reinterpret_cast<float*>(smem + plan.param_at);
    for (int i = threadIdx.x; i < 2 * depth; i += dense::THREADS) s_lut[i] = lut[i];
    ltp.lut = s_lut;
    ltd.lut = s_lut + depth;
  }
  const CounterWindow<W> mag{pre_spike, post_spike, pre_words, post_words, ltp, ltd,
                             plan.n_pre, plan.n_post, depth};
  dense::update<SLOTS, VEC>(w_out, w, eta, w_min, w_max, plan, mag, smem);
}

// The windows of both counter-word operands as gated::contract's magnitude
// functor.
template <int W>
struct CounterRead {
  Side ltp, ltd;
  int depth;
  // a counter word is one chunk: its window, whatever the running read
  __device__ __forceinline__ float pre(const uint8_t* at, int, int, int, float, float&) const {
    return window<W>(*at, ltp, depth);
  }
  __device__ __forceinline__ float post(const uint8_t* at, int, int, int, float, float&) const {
    return window<W>(*at, ltd, depth);
  }
};

template <int W, bool GENERAL>
__global__ void __launch_bounds__(gated::THREADS, GENERAL ? 1 : gated::MIN_BLOCKS)
counter_conv_delta_kernel(float* __restrict__ out, double* __restrict__ partial,
                          const float* __restrict__ pre, const float* __restrict__ post,
                          const uint8_t* __restrict__ pre_words,
                          const uint8_t* __restrict__ post_words,
                          const float* __restrict__ lut, Side ltp, Side ltd, int depth,
                          gated::Plan plan) {
  extern __shared__ __align__(16) char smem[];
  // the imstdp table is staged into shared memory with the first rows
  const float* s_lut = reinterpret_cast<const float*>(smem + plan.param_at);
  ltp.lut = s_lut;
  ltd.lut = s_lut + depth;
  const CounterRead<W> mag{ltp, ltd, depth};
  gated::contract<GENERAL>(out, partial, pre, post, pre_words, post_words, lut, lut + depth, plan,
                  mag, smem);
}

constexpr int FC_THREADS = 128;
constexpr int FC_COLS = 32;                              // a warp's columns
constexpr int FC_RPT = 4;                                // rows a thread
constexpr int FC_ROWS = FC_THREADS / FC_COLS * FC_RPT;   // rows a tile
constexpr int FC_LANES = 16;                             // lanes a staged chunk

// The XOR pair gate's float32 term of one synapse, as dense::update forms it
// (ltp_en where the post neuron fired alone, ltd_en where the pre neuron did),
// both windows evaluated whatever the gate.
template <int W>
__device__ __forceinline__ float pair_dw(const CounterWindow<W>& mag, dense::Side a,
                                         dense::Side c) {
  const float ltp = mag.ltp_mag(a.v), ltd = mag.ltd_mag(c.v);
  const bool pre_s = a.spike != 0.0f, post_s = c.spike != 0.0f;
  const bool fire_xor = pre_s != post_s;
  const float ltp_en = (fire_xor && post_s) ? 1.0f : 0.0f;
  const float ltd_en = (fire_xor && pre_s) ? 1.0f : 0.0f;
  return __fsub_rn(__fmul_rn(ltp_en, ltp), __fmul_rn(ltd_en, ltd));
}

template <int W>
__global__ void __launch_bounds__(FC_THREADS, 8)
counter_fc_delta_kernel(float* __restrict__ out, const float* __restrict__ pre_spike,
                        const float* __restrict__ post_spike,
                        const uint8_t* __restrict__ pre_words,
                        const uint8_t* __restrict__ post_words,
                        const float* __restrict__ lut, Side ltp, Side ltd, int depth,
                        int lanes, int n_pre, int n_post, int col_blocks) {
  __shared__ dense::Side s_pre[2][FC_LANES][FC_ROWS];
  __shared__ dense::Side s_post[2][FC_LANES][FC_COLS];
  __shared__ float s_lut[W == IMSTDP ? 2 * MAX_DEPTH : 1];
  if constexpr (W == IMSTDP) {   // read only after the first sync
    for (int i = threadIdx.x; i < 2 * depth; i += FC_THREADS) s_lut[i] = lut[i];
    ltp.lut = s_lut;
    ltd.lut = s_lut + depth;
  }
  const CounterWindow<W> mag{pre_spike, post_spike, pre_words, post_words, ltp, ltd,
                             n_pre, n_post, depth};
  const int cb = blockIdx.x % col_blocks, rb = blockIdx.x / col_blocks;
  const int i0 = rb * FC_ROWS, j0 = cb * FC_COLS;
  const int nr = min(FC_ROWS, n_pre - i0), nc = min(FC_COLS, n_post - j0);
  const int col = threadIdx.x % FC_COLS, row = threadIdx.x / FC_COLS * FC_RPT;

  // a chunk's sides; a neuron past the tile's edge stages counter 0, no spike,
  // so every read of the table stays inside it
  auto stage = [&](int buf, int l0) {
    const int nl = min(FC_LANES, lanes - l0);
    for (int k = threadIdx.x; k < nl * FC_ROWS; k += FC_THREADS) {
      const int l = k / FC_ROWS, i = k - l * FC_ROWS;
      s_pre[buf][l][i] = i < nr ? mag.pre(l0 + l, i0 + i) : dense::Side{0.0f, 0.0f};
    }
    for (int k = threadIdx.x; k < nl * FC_COLS; k += FC_THREADS) {
      const int l = k / FC_COLS, j = k - l * FC_COLS;
      s_post[buf][l][j] = j < nc ? mag.post(l0 + l, j0 + j) : dense::Side{0.0f, 0.0f};
    }
  };

  double acc[FC_RPT];
#pragma unroll
  for (int q = 0; q < FC_RPT; ++q) acc[q] = 0.0;
  const int chunks = (lanes + FC_LANES - 1) / FC_LANES;
  if (chunks > 0) stage(0, 0);
  __syncthreads();
  for (int ch = 0; ch < chunks; ++ch) {
    const int buf = ch & 1;
    // the other buffer was last read before the previous chunk's sync
    if (ch + 1 < chunks) stage(buf ^ 1, (ch + 1) * FC_LANES);
    const int nl = min(FC_LANES, lanes - ch * FC_LANES);
    for (int l = 0; l < nl; ++l) {   // ascending lanes: a fixed order of the adds
      const dense::Side c = s_post[buf][l][col];
#pragma unroll
      for (int q = 0; q < FC_RPT; ++q) {
        acc[q] += static_cast<double>(pair_dw(mag, s_pre[buf][l][row + q], c));
      }
    }
    __syncthreads();
  }
  if (col < nc) {
#pragma unroll
    for (int q = 0; q < FC_RPT; ++q) {
      if (row + q < nr) {
        out[static_cast<size_t>(i0 + row + q) * n_post + j0 + col] = __double2float_rn(acc[q]);
      }
    }
  }
}

Side side(float amp, float tau) { return Side{amp, tau, 2.0f * tau, nullptr}; }

template <int W>
int launch_update(float* w_out, const float* w, const float* pre_spike,
                  const float* post_spike, const uint8_t* pre_words,
                  const uint8_t* post_words, const float* lut, int lanes, int n_pre,
                  int n_post, int depth, Side ltp, Side ltd, float eta, float w_min,
                  float w_max, int device, void* stream) {
  return dense::launch<SLOTS>(counter_stdp_kernel<W, 4>, counter_stdp_kernel<W, 1>, w_out, w,
                              lanes, n_pre, n_post, W == IMSTDP ? depth : 0, device, stream,
                              pre_spike, post_spike, pre_words, post_words, lut, ltp, ltd,
                              depth, eta, w_min, w_max);
}

template <int W>
int launch_conv(float* out, double* partial, long scratch, const float* pre, const float* post,
                const uint8_t* pre_words, const uint8_t* post_words, const float* lut,
                int M, int K, int C, int depth, Side ltp, Side ltd, int device,
                void* stream) {
  return gated::launch(counter_conv_delta_kernel<W, false>, counter_conv_delta_kernel<W, true>,
                       M, K, C, 1, 1, W == IMSTDP ? depth : 0, device, stream, scratch,
                       nullptr, out, partial, pre, post, pre_words, post_words, lut, ltp,
                       ltd, depth);
}

template <int W>
int launch_fc(float* out, const float* pre_spike, const float* post_spike,
              const uint8_t* pre_words, const uint8_t* post_words, const float* lut, int lanes,
              int n_pre, int n_post, int depth, Side ltp, Side ltd, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int row_blocks = (n_pre + FC_ROWS - 1) / FC_ROWS;
  const int col_blocks = (n_post + FC_COLS - 1) / FC_COLS;
  if (static_cast<long>(row_blocks) * col_blocks > INT_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  counter_fc_delta_kernel<W><<<row_blocks * col_blocks, FC_THREADS, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      out, pre_spike, post_spike, pre_words, post_words, lut, ltp, ltd, depth, lanes, n_pre,
      n_post, col_blocks);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int conv_scratch(int M, int K, int C, int depth, int device, long* doubles) {
  return gated::plan_scratch(counter_conv_delta_kernel<W, false>,
                             counter_conv_delta_kernel<W, true>, M, K, C, 1, 1,
                             W == IMSTDP ? depth : 0, device, doubles);
}

}  // namespace

extern "C" {

// The float64 scratch the conv delta's launch of this shape takes, into
// *doubles (window and depth as below): the wrapper allocates partial as
// that many values (per call; no zeroing), or passes null at 0, where the
// blocks store the outputs directly.  Returns the cudaError_t (0 = success).
int counter_conv_scratch(int M, int K, int C, int depth, int window, int device,
                         long* doubles) {
  *doubles = 0;
  if (depth < 1 || depth > MAX_DEPTH || window < EXACT || window > IMSTDP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (window) {
    case EXACT:
      return conv_scratch<EXACT>(M, K, C, depth, device, doubles);
    case LINEAR:
      return conv_scratch<LINEAR>(M, K, C, depth, device, doubles);
    default:
      return conv_scratch<IMSTDP>(M, K, C, depth, device, doubles);
  }
}

// w, w_out: (lanes, n_pre, n_post) f32; spikes: (lanes, n) f32 {0,1}; counter
// words: (lanes, n) uint8; lut: (2, depth) f32 (rows LTP, LTD; read by
// window 2 only); window: 0 exact, 1 linear, 2 imstdp; 1 <= depth <= 255.
// Returns the cudaError_t of the launch (0 = success).
int counter_stdp_update(float* w_out, const float* w, const float* pre_spike,
                        const float* post_spike, const uint8_t* pre_words,
                        const uint8_t* post_words, const float* lut, int lanes,
                        int n_pre, int n_post, int depth, int window, float a_plus,
                        float a_minus, float tau_plus, float tau_minus, float eta,
                        float w_min, float w_max, int device, void* stream) {
  if (lanes <= 0 || n_pre <= 0 || n_post <= 0) return 0;
  if (depth < 1 || depth > MAX_DEPTH || window < EXACT || window > IMSTDP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Side ltp = side(a_plus, tau_plus), ltd = side(a_minus, tau_minus);
  switch (window) {
    case EXACT:
      return launch_update<EXACT>(w_out, w, pre_spike, post_spike, pre_words, post_words,
                                  lut, lanes, n_pre, n_post, depth, ltp, ltd, eta, w_min,
                                  w_max, device, stream);
    case LINEAR:
      return launch_update<LINEAR>(w_out, w, pre_spike, post_spike, pre_words, post_words,
                                   lut, lanes, n_pre, n_post, depth, ltp, ltd, eta, w_min,
                                   w_max, device, stream);
    default:
      return launch_update<IMSTDP>(w_out, w, pre_spike, post_spike, pre_words, post_words,
                                   lut, lanes, n_pre, n_post, depth, ltp, ltd, eta, w_min,
                                   w_max, device, stream);
  }
}

// pre: (M, K) f32, post: (M, C) f32, words: (M, K) / (M, C) uint8; lut and
// window as above; out: (K, C) f32; partial: `scratch` f64 values, sized
// as above.  Returns the cudaError_t of the launch (0 = success).
int counter_conv_delta(float* out, double* partial, long scratch, const float* pre,
                       const float* post, const uint8_t* pre_words,
                       const uint8_t* post_words, const float* lut, int M, int K,
                       int C, int depth, int window, float a_plus, float a_minus,
                       float tau_plus, float tau_minus, int device, void* stream) {
  if (depth < 1 || depth > MAX_DEPTH || window < EXACT || window > IMSTDP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Side ltp = side(a_plus, tau_plus), ltd = side(a_minus, tau_minus);
  switch (window) {
    case EXACT:
      return launch_conv<EXACT>(out, partial, scratch, pre, post, pre_words, post_words, lut,
                                M, K, C, depth, ltp, ltd, device, stream);
    case LINEAR:
      return launch_conv<LINEAR>(out, partial, scratch, pre, post, pre_words, post_words, lut,
                                 M, K, C, depth, ltp, ltd, device, stream);
    default:
      return launch_conv<IMSTDP>(out, partial, scratch, pre, post, pre_words, post_words, lut,
                                 M, K, C, depth, ltp, ltd, device, stream);
  }
}

// pre_spike: (lanes, n_pre) f32, post_spike: (lanes, n_post) f32, words:
// (lanes, n) uint8; lut and window as above; out: (n_pre, n_post) f32, the
// raw delta summed over the lanes (zeros at lanes = 0).  Returns the
// cudaError_t of the launch (0 = success); an empty out launches nothing.
int counter_fc_delta(float* out, const float* pre_spike, const float* post_spike,
                     const uint8_t* pre_words, const uint8_t* post_words, const float* lut,
                     int lanes, int n_pre, int n_post, int depth, int window, float a_plus,
                     float a_minus, float tau_plus, float tau_minus, int device,
                     void* stream) {
  if (lanes < 0 || depth < 1 || depth > MAX_DEPTH || window < EXACT || window > IMSTDP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_pre <= 0 || n_post <= 0) return 0;
  const Side ltp = side(a_plus, tau_plus), ltd = side(a_minus, tau_minus);
  switch (window) {
    case EXACT:
      return launch_fc<EXACT>(out, pre_spike, post_spike, pre_words, post_words, lut, lanes,
                              n_pre, n_post, depth, ltp, ltd, device, stream);
    case LINEAR:
      return launch_fc<LINEAR>(out, pre_spike, post_spike, pre_words, post_words, lut, lanes,
                               n_pre, n_post, depth, ltp, ltd, device, stream);
    default:
      return launch_fc<IMSTDP>(out, pre_spike, post_spike, pre_words, post_words, lut, lanes,
                               n_pre, n_post, depth, ltp, ltd, device, stream);
  }
}

const char* counter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

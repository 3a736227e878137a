// Fused counter-rule (explicit-Delta-t STDP) kernels for Hopper (sm_90a),
// plain C interface: the conventional learning datapath the paper measures
// ITP-STDP against (Tables III-V).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/itp_counter/kernel.py:
//   counter_stdp_update (dense: clip(w + eta * dw) over the synapse matrix)
//   counter_conv_delta  (im2col conv: the raw (K, C) delta summed over M).
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
// per-pair window adds a double exp (exact) or a few float ops per synapse,
// below the byte time at the shapes the nets use.  Design as itp_stdp.cu:
// one thread per (lane, i, j) synapse, a block of TILE_PRE rows x TILE_POST
// columns of one lane's w, a warp along the contiguous post axis (coalesced
// w loads and stores), all lanes in one launch, ragged edges masked here.
// Each thread reads its w element before writing it, so w_out may alias w.
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

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gated_sum.cuh"

namespace {

constexpr int TILE_POST = 32;  // columns per block: one warp along a w row
constexpr int TILE_PRE = 8;    // rows per block
constexpr int MAX_DEPTH = 255; // counter words are uint8
constexpr int MAX_LANES = 65535;

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

// Stage the (2, depth) table into shared memory and point the sides at it.
template <int W>
__device__ __forceinline__ void stage_lut(float* s_lut, const float* __restrict__ lut,
                                          int depth, int tid, int threads, Side& ltp,
                                          Side& ltd) {
  if constexpr (W == IMSTDP) {
    for (int i = tid; i < 2 * depth; i += threads) s_lut[i] = lut[i];
    __syncthreads();
    ltp.lut = s_lut;
    ltd.lut = s_lut + depth;
  }
}

template <int W>
__global__ void __launch_bounds__(TILE_PRE * TILE_POST)
counter_stdp_kernel(float* w_out, const float* w,  // may alias: in place
                    const float* __restrict__ pre_spike,
                    const float* __restrict__ post_spike,
                    const uint8_t* __restrict__ pre_words,
                    const uint8_t* __restrict__ post_words,
                    const float* __restrict__ lut, Side ltp, Side ltd, int n_pre,
                    int n_post, int depth, float eta, float w_min, float w_max) {
  __shared__ float s_lut[2 * MAX_DEPTH];
  stage_lut<W>(s_lut, lut, depth, threadIdx.y * TILE_POST + threadIdx.x,
               TILE_PRE * TILE_POST, ltp, ltd);

  const int lane = blockIdx.z;
  const int i = blockIdx.y * TILE_PRE + threadIdx.y;
  const int j = blockIdx.x * TILE_POST + threadIdx.x;
  if (i >= n_pre || j >= n_post) return;

  // per-pair delays from the counter words, and both windows
  const size_t pre_at = static_cast<size_t>(lane) * n_pre + i;
  const size_t post_at = static_cast<size_t>(lane) * n_post + j;
  const float ltp_mag = window<W>(pre_words[pre_at], ltp, depth);
  const float ltd_mag = window<W>(post_words[post_at], ltd, depth);

  const bool pre_s = pre_spike[pre_at] != 0.0f;
  const bool post_s = post_spike[post_at] != 0.0f;
  const bool fire_xor = pre_s != post_s;
  const float ltp_en = (fire_xor && post_s) ? 1.0f : 0.0f;  // post fired alone
  const float ltd_en = (fire_xor && pre_s) ? 1.0f : 0.0f;   // pre fired alone
  const float dw = __fsub_rn(__fmul_rn(ltp_en, ltp_mag), __fmul_rn(ltd_en, ltd_mag));

  const size_t at = (static_cast<size_t>(lane) * n_pre + i) * n_post + j;
  const float x = __fadd_rn(w[at], __fmul_rn(eta, dw));
  w_out[at] = fminf(fmaxf(x, w_min), w_max);
}

// The windows of both counter-word operands as gated::contract's magnitude
// functor.
template <int W>
struct CounterRead {
  Side ltp, ltd;
  int depth;
  __device__ __forceinline__ float pre(const uint8_t* at, int) const {
    return window<W>(*at, ltp, depth);
  }
  __device__ __forceinline__ float post(const uint8_t* at, int) const {
    return window<W>(*at, ltd, depth);
  }
};

template <int W>
__global__ void __launch_bounds__(gated::THREADS, gated::MIN_BLOCKS)
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
  gated::contract(out, partial, pre, post, pre_words, post_words, lut, lut + depth, plan,
                  mag, smem);
}

Side side(float amp, float tau) { return Side{amp, tau, 2.0f * tau, nullptr}; }

template <int W>
int launch_update(float* w_out, const float* w, const float* pre_spike,
                  const float* post_spike, const uint8_t* pre_words,
                  const uint8_t* post_words, const float* lut, int lanes, int n_pre,
                  int n_post, int depth, Side ltp, Side ltd, float eta, float w_min,
                  float w_max, cudaStream_t s) {
  const dim3 block(TILE_POST, TILE_PRE);
  const dim3 grid((n_post + TILE_POST - 1) / TILE_POST,
                  (n_pre + TILE_PRE - 1) / TILE_PRE, lanes);
  counter_stdp_kernel<W><<<grid, block, 0, s>>>(w_out, w, pre_spike, post_spike,
                                                pre_words, post_words, lut, ltp, ltd,
                                                n_pre, n_post, depth, eta, w_min, w_max);
  return static_cast<int>(cudaGetLastError());
}

template <int W>
int launch_conv(float* out, double* partial, const float* pre, const float* post,
                const uint8_t* pre_words, const uint8_t* post_words, const float* lut,
                int M, int K, int C, int depth, Side ltp, Side ltd, int device,
                void* stream) {
  return gated::launch(counter_conv_delta_kernel<W>, M, K, C, 1, 1, W == IMSTDP ? depth : 0,
                       device, stream, out, partial, pre, post, pre_words, post_words, lut,
                       ltp, ltd, depth);
}

}  // namespace

extern "C" {

// The wrapper allocates partial as K * C * counter_conv_max_splits(M, K, C)
// float64 values (per call; no zeroing).
int counter_conv_max_splits(int M, int K, int C) { return gated::max_splits(M, K, C); }

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
  if (depth < 1 || depth > MAX_DEPTH || lanes > MAX_LANES || window < EXACT ||
      window > IMSTDP) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Side ltp = side(a_plus, tau_plus), ltd = side(a_minus, tau_minus);
  switch (window) {
    case EXACT:
      return launch_update<EXACT>(w_out, w, pre_spike, post_spike, pre_words,
                                  post_words, lut, lanes, n_pre, n_post, depth, ltp,
                                  ltd, eta, w_min, w_max, s);
    case LINEAR:
      return launch_update<LINEAR>(w_out, w, pre_spike, post_spike, pre_words,
                                   post_words, lut, lanes, n_pre, n_post, depth, ltp,
                                   ltd, eta, w_min, w_max, s);
    default:
      return launch_update<IMSTDP>(w_out, w, pre_spike, post_spike, pre_words,
                                   post_words, lut, lanes, n_pre, n_post, depth, ltp,
                                   ltd, eta, w_min, w_max, s);
  }
}

// pre: (M, K) f32, post: (M, C) f32, words: (M, K) / (M, C) uint8; lut and
// window as above; out: (K, C) f32; partial: f64 scratch, sized as above.
// Returns the cudaError_t of the launch (0 = success).
int counter_conv_delta(float* out, double* partial, const float* pre,
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
      return launch_conv<EXACT>(out, partial, pre, post, pre_words, post_words, lut,
                                M, K, C, depth, ltp, ltd, device, stream);
    case LINEAR:
      return launch_conv<LINEAR>(out, partial, pre, post, pre_words, post_words, lut,
                                 M, K, C, depth, ltp, ltd, device, stream);
    default:
      return launch_conv<IMSTDP>(out, partial, pre, post, pre_words, post_words, lut,
                                 M, K, C, depth, ltp, ltd, device, stream);
  }
}

const char* counter_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

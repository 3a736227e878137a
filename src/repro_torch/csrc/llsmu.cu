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
// kernel (kernels/llsmu/ops.py), as in the hardware.  Two variants, one
// body: b of a's length (element pairs), or one value of b for every
// element (kScalarB), whose split, leading-one counts and mantissas each
// thread then computes once.
//
// Bit control.  The kernel reproduces XLA's int32 semantics, which the
// Pallas body runs under and the plain version (kernels/llsmu/ref.py)
// shares, for every int32 operand: adds and subtracts wrap (done on
// uint32_t); a left shift by 32 or more gives 0 and a right shift is
// arithmetic with the sign filling from 32 on.  Every barrel shift
// x * 2^s (s in [-31, 32] here) is the low word of the 64-bit word (x, 0)
// shifted right arithmetically by 32 - s, which lies in [0, 63], so the C++
// is defined: a left shift wraps and reaches 0 at s = 32, a right shift
// floors; beyond 32 the amount is clamped to give 0.  The leading-one count
// is the Pallas threshold chain k = #{1 <= i < max_bits : x >= 2^i}: one
// bfind of max(x, 1) clamped at max_bits - 1 (max_bits = 2 n_bits + 10 from
// the wrapper); the low half, never negative, skips the max, and its k of
// -1 at zero is masked with the zero product.  cq = round(c * 2^frac_bits)
// is rounded on the host as Python rounds it; cq // 2 is its floor half.
//
// Bound: integer issue.  12 bytes move per element (two int32 operands
// read, one written; 8 with one b), and the datapath was 176 SASS
// instructions per element (tools/sass_count.py), nearly all integer, which
// an H100 SM issues on 64 lanes a clock, half its float32 lanes: at 2^24
// elements that took longer than the bytes.  Design: the fewest
// instructions per element (75 on element pairs, 43 with one b).
// No compare-and-select guards around the shifts (the funnel shift above);
// one bfind and one clamp per leading-one count; b's part computed once a
// thread when it is one value, and the low product m0 = mitchell(a_low,
// b_low), which then takes only the 2^n_bits values of a_low, read from a
// table each block fills in shared memory (4 KB at most).  Four elements a
// thread, read and written as 16-byte int4 vectors, give four independent
// datapaths to hide latency; a block of 256 threads per 1,024 elements; the
// last n % 4 elements go one a thread, as does every element when a base
// pointer is not 16-byte aligned (a grid-stride loop, never unrolled,
// covers a grid past its limit).

#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace {

// The constants of one call, derived on the host.
struct Params {
  int n_bits;       // the Karatsuba split
  int32_t mask;     // 2^n_bits - 1
  int32_t max_k;    // max_bits - 1: where the leading-one count saturates
  int32_t norm;     // 32 - frac_bits: the mantissa's shift is norm + k
  int32_t back;     // 32 + frac_bits: the product's shift is back - kx - ky
  int32_t one;      // 1 << frac_bits
  int32_t two_one;  // 2 * one
  int32_t up;       // one + cq: mant when delta < one is delta + up
  int32_t down;     // 2 * (cq // 2): otherwise 2 * delta + down
};

__device__ __forceinline__ int32_t wrap_add(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) + static_cast<uint32_t>(y));
}

__device__ __forceinline__ int32_t wrap_sub(int32_t x, int32_t y) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) - static_cast<uint32_t>(y));
}

// x << s for 0 <= s < 32, wrapping.
__device__ __forceinline__ int32_t shl(int32_t x, int s) {
  return static_cast<int32_t>(static_cast<uint32_t>(x) << s);
}

// floor(x * 2^(32 - m)) mod 2^32 for m in [0, 63]: XLA's barrel shift by
// s = 32 - m (see the header).
__device__ __forceinline__ int32_t barrel(int32_t x, int32_t m) {
  const int64_t wide =
      static_cast<int64_t>(static_cast<uint64_t>(static_cast<uint32_t>(x)) << 32);
  return static_cast<int32_t>(static_cast<uint32_t>(static_cast<uint64_t>(wide >> m)));
}

// The position of the most significant 1 bit, -1 for 0 (PTX bfind).
__device__ __forceinline__ int32_t bfind(int32_t x) {
  int32_t k;
  asm("bfind.u32 %0, %1;" : "=r"(k) : "r"(x));
  return k;
}

// One Mitchell operand: k = floor(log2 x) saturating at max_k (the threshold
// chain: 0 for x <= 0), the Q(frac_bits) mantissa f = x * 2^(frac_bits - k),
// and whether x is 0.  kNonNegative: x >= 0 is known, so its k may read -1
// at zero (masked with the product).
struct Log {
  int32_t k, f;
  bool zero;
};

template <bool kNonNegative>
__device__ __forceinline__ Log log_of(int32_t x, const Params& c) {
  const int32_t k = min(bfind(kNonNegative ? x : max(x, 1)), c.max_k);
  return {k, barrel(x, c.norm + k), x == 0};
}

// The three operands of the three Mitchell multiplies: the high half, the
// low half and their sum.
struct Split {
  Log h, l, s;
};

__device__ __forceinline__ Split split(int32_t x, const Params& c) {
  const int32_t h = x >> c.n_bits, l = x & c.mask;
  return {log_of<false>(h, c), log_of<true>(l, c), log_of<false>(wrap_add(h, l), c)};
}

__device__ __forceinline__ int32_t mitchell(const Log& x, const Log& y, const Params& c) {
  const int32_t delta = wrap_sub(wrap_add(x.f, y.f), c.two_one);
  const int32_t mant =
      delta < c.one ? wrap_add(delta, c.up) : wrap_add(wrap_add(delta, delta), c.down);
  const int32_t p = barrel(mant, max(c.back - x.k - y.k, 0));
  return (x.zero || y.zero) ? 0 : p;
}

__device__ __forceinline__ int32_t recombine(int32_t m0, int32_t m1, int32_t m2,
                                             const Params& c) {
  const int32_t s3 = wrap_sub(wrap_sub(m2, m0), m1);
  return wrap_add(wrap_add(shl(m1, 2 * c.n_bits), shl(s3, c.n_bits)), m0);
}

__device__ __forceinline__ int32_t llsmu(const Split& a, const Split& b, const Params& c) {
  return recombine(mitchell(a.l, b.l, c), mitchell(a.h, b.h, c), mitchell(a.s, b.s, c), c);
}

// With one b: the low product m0 = mitchell(a_low, b_low) takes only the
// 2^n_bits values of a_low, read from the block's table.
__device__ __forceinline__ int32_t llsmu(int32_t x, const Split& b, const int32_t* m0,
                                         const Params& c) {
  const int32_t h = x >> c.n_bits, l = x & c.mask;
  return recombine(m0[l], mitchell(log_of<false>(h, c), b.h, c),
                   mitchell(log_of<false>(wrap_add(h, l), c), b.s, c), c);
}

constexpr int MAX_N_BITS = 10;   // kernels/llsmu/ref.py: the widest split

// groups: the int4 groups read as vectors (n / 4 when every pointer is
// aligned, else 0); the elements from 4 * groups on go one a thread.
template <bool kScalarB>
__global__ void __launch_bounds__(elementwise::THREADS)
    llsmu_multiply_kernel(int32_t* __restrict__ out, const int32_t* __restrict__ a,
                          const int32_t* __restrict__ b, int64_t groups, int64_t n,
                          Params c) {
  const int64_t first = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int4* a4 = reinterpret_cast<const int4*>(a);
  if constexpr (kScalarB) {
    // the first group's load goes out before b's, so their latencies overlap
    int4 av = first < groups ? a4[first] : int4{};
    __shared__ int32_t m0[1 << MAX_N_BITS];
    const Split sb = split(b[0], c);
    for (int32_t l = threadIdx.x; l < (1 << c.n_bits); l += blockDim.x) {
      m0[l] = mitchell(log_of<true>(l, c), sb.l, c);
    }
    __syncthreads();
#pragma unroll 1
    for (int64_t g = first; g < groups; g += stride) {
      if (g != first) av = a4[g];
      int4 r;
      r.x = llsmu(av.x, sb, m0, c);
      r.y = llsmu(av.y, sb, m0, c);
      r.z = llsmu(av.z, sb, m0, c);
      r.w = llsmu(av.w, sb, m0, c);
      reinterpret_cast<int4*>(out)[g] = r;
    }
#pragma unroll 1
    for (int64_t k = 4 * groups + first; k < n; k += stride) {
      out[k] = llsmu(a[k], sb, m0, c);
    }
  } else {
#pragma unroll 1
    for (int64_t g = first; g < groups; g += stride) {
      const int4 av = a4[g];
      const int4 bv = reinterpret_cast<const int4*>(b)[g];
      int4 r;
      r.x = llsmu(split(av.x, c), split(bv.x, c), c);
      r.y = llsmu(split(av.y, c), split(bv.y, c), c);
      r.z = llsmu(split(av.z, c), split(bv.z, c), c);
      r.w = llsmu(split(av.w, c), split(bv.w, c), c);
      reinterpret_cast<int4*>(out)[g] = r;
    }
#pragma unroll 1
    for (int64_t k = 4 * groups + first; k < n; k += stride) {
      out[k] = llsmu(split(a[k], c), split(b[k], c), c);
    }
  }
}

template <bool kScalarB>
int launch(int32_t* out, const int32_t* a, const int32_t* b, int64_t n, const Params& c,
           int device, cudaStream_t stream) {
  const int err = elementwise::set_device(device);
  if (err != 0) return err;
  const bool vector = kScalarB ? elementwise::aligned16(out, a)
                               : elementwise::aligned16(out, a, b);
  const int64_t groups = vector ? n / 4 : 0;
  const int64_t tail = n - 4 * groups;
  const int blocks = elementwise::blocks(groups > tail ? groups : tail);
  llsmu_multiply_kernel<kScalarB><<<blocks, elementwise::THREADS, 0, stream>>>(
      out, a, b, groups, n, c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// out, a: (n,) int32; b: (n,) int32, or one int32 for every element when
// b_scalar is non-zero; a and b non-negative.  Returns the cudaError_t of
// the launch (0 = success).
int llsmu_multiply(int32_t* out, const int32_t* a, const int32_t* b, int64_t n,
                   int b_scalar, int n_bits, int frac_bits, int cq, int max_bits,
                   int device, void* stream) {
  if (n <= 0) return 0;
  const uint32_t one = 1u << frac_bits;
  Params c;
  c.n_bits = n_bits;
  c.mask = static_cast<int32_t>((1u << n_bits) - 1u);
  c.max_k = max_bits - 1;
  c.norm = 32 - frac_bits;
  c.back = 32 + frac_bits;
  c.one = static_cast<int32_t>(one);
  c.two_one = static_cast<int32_t>(2u * one);
  c.up = static_cast<int32_t>(one + static_cast<uint32_t>(cq));
  c.down = static_cast<int32_t>(2u * static_cast<uint32_t>(cq >> 1));
  const auto s = static_cast<cudaStream_t>(stream);
  return b_scalar ? launch<true>(out, a, b, n, c, device, s)
                  : launch<false>(out, a, b, n, c, device, s);
}

const char* llsmu_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

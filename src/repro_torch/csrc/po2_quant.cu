// Power-of-two (de)quantisation kernels for Hopper (sm_90a), plain C
// interface: the ITP quantiser sign * 2^round(log2|x|) and its 8-bit wire
// code (bit 7 the sign, bits 0-6 the biased exponent e + 64, 0 = zero).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/po2_quant/kernel.py:
//   po2_encode (_encode_kernel): float32 -> int32 code
//   po2_decode (_decode_kernel): int32 code -> float32.
//
// Bit control.  The encoder is the encoder circuit and reads the float's
// bits; no log2f.  e = exponent field - 127, plus one exactly when the 23
// mantissa bits are >= 0x3504F4, the smallest float32 mantissa above sqrt(2)
// (irrational, so never a tie): the correctly rounded round(log2|x|).  Then
// the clip to [-63, 63], +64, and the sign in bit 7.  +-0, subnormals and
// NaN give code 0 with no sign bit (the reference's XLA flushes subnormals
// and turns NaN into 0); +inf gives 127 and -inf 255 through the clip.  The
// decoder writes the exponent field (code & 127) - 64 + 127 and the sign from
// bit 7 directly (__uint_as_float), and +0 for code 0: exact, as the
// reference's decoder circuit.  Kernel and plain version
// (kernels/po2_quant/ref.py) compute the same integers and agree bit for bit.
//
// Bound: memory.  8 bytes move per element each way (float32 in and int32
// out, or the reverse) against a handful of integer operations.  Design: one
// thread per element, grid-stride over the flat arrays, at most
// BLOCKS_PER_SM blocks on each SM (the device set up by elementwise.cuh),
// ragged end masked, no shared memory; neighbouring threads touch
// neighbouring words.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "elementwise.cuh"

namespace {

constexpr int BIAS = 64;
constexpr uint32_t SQRT2_MANTISSA = 0x3504F4u;
constexpr int BLOCKS_PER_SM = 16;

__global__ void po2_encode_kernel(int32_t* __restrict__ out, const float* __restrict__ x,
                                  int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const uint32_t bits = __float_as_uint(x[k]);
    const int32_t field = static_cast<int32_t>((bits >> 23) & 0xFFu);
    const uint32_t mant = bits & 0x7FFFFFu;
    int32_t code = 0;                                  // +-0, subnormal, NaN
    if (field != 0 && !(field == 0xFF && mant != 0)) {
      int32_t e = field - 127 + (mant >= SQRT2_MANTISSA ? 1 : 0);
      e = e < 1 - BIAS ? 1 - BIAS : (e > 127 - BIAS ? 127 - BIAS : e);
      code = (e + BIAS) | static_cast<int32_t>((bits >> 24) & 128u);
    }
    out[k] = code;
  }
}

__global__ void po2_decode_kernel(float* __restrict__ out, const int32_t* __restrict__ c,
                                  int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const uint32_t code = static_cast<uint32_t>(c[k]);
    const uint32_t mag = code & 127u;
    const uint32_t sign = (code & 128u) << 24;
    out[k] = mag == 0 ? 0.0f : __uint_as_float(sign | ((mag - BIAS + 127u) << 23));
  }
}

constexpr int MAX_DEVICES = 64;

// Sets `sms` to the SM count of `device`, looked up once per device and
// kept in the library (relaxed atomics: a race computes the same value
// twice); returns the cudaError_t of the query (0 = success).
int sm_count(int device, int* sms) {
  static std::atomic<int> cache[MAX_DEVICES];
  const bool cached = device >= 0 && device < MAX_DEVICES;
  int count = cached ? cache[device].load(std::memory_order_relaxed) : 0;
  if (count == 0) {
    const cudaError_t err =
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (cached) cache[device].store(count, std::memory_order_relaxed);
  }
  *sms = count;
  return 0;
}

// Selects `device` and sets `blocks` for n > 0 elements, one a thread.
int grid(int64_t n, int device, int* blocks) {
  int sms = 0;
  int err = elementwise::set_device(device);
  if (err == 0) err = sm_count(device, &sms);
  if (err != 0) return err;
  *blocks = elementwise::blocks(n, static_cast<int64_t>(sms) * BLOCKS_PER_SM);
  return 0;
}

}  // namespace

extern "C" {

// out: (n,) int32 codes in [0, 255]; x: (n,) float32.  Returns the
// cudaError_t of the launch (0 = success).
int po2_encode(int32_t* out, const float* x, int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  const int err = grid(n, device, &blocks);
  if (err != 0) return err;
  po2_encode_kernel<<<blocks, elementwise::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      out, x, n);
  return static_cast<int>(cudaGetLastError());
}

// out: (n,) float32; c: (n,) int32 codes (only the low 8 bits are read).
int po2_decode(float* out, const int32_t* c, int64_t n, int device, void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  const int err = grid(n, device, &blocks);
  if (err != 0) return err;
  po2_decode_kernel<<<blocks, elementwise::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      out, c, n);
  return static_cast<int>(cudaGetLastError());
}

const char* po2_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

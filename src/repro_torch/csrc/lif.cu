// Fused LIF neuron update (paper eqs. 4-5) for Hopper (sm_90a), plain C
// interface.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif/kernel.py:
//   lif_update (_lif_kernel):
//   v' = alpha * (v - E) + E + I ;  s = v' > V_th ;  v'' = s ? E : v'
// with the spikes written as float32 {0, 1}, as the TPU kernel writes them.
//
// Rounding.  nvcc contracts a * b + c into one FMA by default; the eager
// reference and the plain version (kernels/lif/ref.py) round every step to
// float32.  So the step is written __fsub_rn, __fmul_rn, __fadd_rn, __fadd_rn
// in the reference's order, which no contraction may merge: the kernel, its
// plain version and the eager JAX lif_step agree bit for bit.  alpha, E and
// V_th arrive rounded to float32 from the host.
//
// Bound: memory.  16 bytes move per neuron (v and I read, v'' and s
// written, float32) against 4 float operations.  Design: four neurons a
// thread, read as one 16-byte float4 of v and of I and written as one
// float4 of v'' and of s, so a warp moves 512 contiguous bytes per access;
// a block of 256 threads per 1,024 neurons, the last n % 4 neurons by the
// first threads, one each; no loop.  When a base pointer is not 16-byte
// aligned (a view such as x[1:]) the same kernel takes every neuron one a
// thread.  No shared memory.  At 2^24 neurons this grid reaches 0.88-0.90
// of the byte bound, where one resident wave walking the array reached
// 0.82 (PERF.md).  At the DCSNN conv1 population (16 x 6,912 neurons) it
// is 108 blocks, and the byte time (about half a microsecond) lies below
// the card's fixed cost of one launch, which sets the kernel's time there.

#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace {

struct Lif {
  float alpha, e_rest, v_th;
};

// One neuron: the next membrane and the spike.
__device__ __forceinline__ void step(float v, float i_in, const Lif& p, float& v_next,
                                     float& spike) {
  const float leak = __fmul_rn(p.alpha, __fsub_rn(v, p.e_rest));
  const float x = __fadd_rn(__fadd_rn(leak, p.e_rest), i_in);
  const bool fired = x > p.v_th;
  v_next = fired ? p.e_rest : x;
  spike = fired ? 1.0f : 0.0f;
}

// groups: the float4 groups read as vectors (n / 4 when every pointer is
// aligned, else 0).  Thread t takes group t, its two loads issued first,
// and then neuron 4 * groups + t, so the neurons past the groups go one a
// thread; the grid covers both.
__global__ void __launch_bounds__(elementwise::THREADS)
    lif_update_kernel(float* __restrict__ v_out, float* __restrict__ s_out,
                      const float* __restrict__ v, const float* __restrict__ i_in,
                      int64_t groups, int64_t n, Lif p) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t < groups) {
    const float4 vv = reinterpret_cast<const float4*>(v)[t];
    const float4 ii = reinterpret_cast<const float4*>(i_in)[t];
    float4 vo, so;
    step(vv.x, ii.x, p, vo.x, so.x);
    step(vv.y, ii.y, p, vo.y, so.y);
    step(vv.z, ii.z, p, vo.z, so.z);
    step(vv.w, ii.w, p, vo.w, so.w);
    reinterpret_cast<float4*>(v_out)[t] = vo;
    reinterpret_cast<float4*>(s_out)[t] = so;
  }
  const int64_t k = 4 * groups + t;
  if (k < n) step(v[k], i_in[k], p, v_out[k], s_out[k]);
}

}  // namespace

extern "C" {

// v_out, s_out, v, i_in: (n,) float32, outputs not aliasing inputs.  Returns
// the cudaError_t of the launch (0 = success).
int lif_update(float* v_out, float* s_out, const float* v, const float* i_in, int64_t n,
               float alpha, float e_rest, float v_th, int device, void* stream) {
  if (n <= 0) return 0;
  const int err = elementwise::set_device(device);
  if (err != 0) return err;
  const int64_t groups = elementwise::aligned16(v_out, s_out, v, i_in) ? n / 4 : 0;
  const int64_t tail = n - 4 * groups;
  const int64_t items = groups > tail ? groups : tail;
  // one item a thread: a grid past its limit (about 2^39 items, more than
  // a card holds) is refused
  if (items > elementwise::MAX_BLOCKS * elementwise::THREADS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = elementwise::blocks(items);
  lif_update_kernel<<<blocks, elementwise::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v_out, s_out, v, i_in, groups, n, Lif{alpha, e_rest, v_th});
  return static_cast<int>(cudaGetLastError());
}

const char* lif_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

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
// written, float32) against 4 float operations.  Design: one thread per
// neuron, grid-stride over the flat arrays (elementwise.cuh), ragged end
// masked, no shared memory; neighbouring threads touch neighbouring words.  At the DCSNN conv1
// population (16 x 6,912 neurons) the byte time is about half a microsecond,
// so the launch itself sets the kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "elementwise.cuh"

namespace {

__global__ void lif_update_kernel(float* __restrict__ v_out, float* __restrict__ s_out,
                                  const float* __restrict__ v,
                                  const float* __restrict__ i_in, int64_t n, float alpha,
                                  float e_rest, float v_th) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x; k < n;
       k += stride) {
    const float leak = __fmul_rn(alpha, __fsub_rn(v[k], e_rest));
    const float x = __fadd_rn(__fadd_rn(leak, e_rest), i_in[k]);
    const bool spike = x > v_th;
    v_out[k] = spike ? e_rest : x;
    s_out[k] = spike ? 1.0f : 0.0f;
  }
}

}  // namespace

extern "C" {

// v_out, s_out, v, i_in: (n,) float32, outputs not aliasing inputs.  Returns
// the cudaError_t of the launch (0 = success).
int lif_update(float* v_out, float* s_out, const float* v, const float* i_in, int64_t n,
               float alpha, float e_rest, float v_th, int device, void* stream) {
  if (n <= 0) return 0;
  int blocks = 0;
  const int err = elementwise::grid(n, device, &blocks);
  if (err != 0) return err;
  lif_update_kernel<<<blocks, elementwise::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v_out, s_out, v, i_in, n, alpha, e_rest, v_th);
  return static_cast<int>(cudaGetLastError());
}

const char* lif_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"

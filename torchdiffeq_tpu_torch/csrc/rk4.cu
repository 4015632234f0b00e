// K-rk4: the whole fixed-grid RK4 (3/8 rule) time loop in one kernel.
//
// Replaces the TPU kernel torchdiffeq_tpu/ops/pallas_kernels.py:56
// (`rk4_integrate`, pallas_call at :161), which keeps a batch tile of
// trajectories in VMEM for all n_steps.  Here each thread owns one
// trajectory: its state y[D] and four slopes live in registers, the MLP
// weights are staged once per block in shared memory, and all n_steps run
// without touching device memory except for the strided trajectory rows.
//
// What bounds it on an H100: not bytes (a step reads no device memory) but
// the latency of each thread's dependent chain of FMA-free multiply-adds
// and tanh over H hidden units, four field evaluations per step.  At B=1024
// one thread per trajectory gives only 8 blocks of 128 threads for 132 SMs,
// so most of the card idles; larger batches fill it.  This kernel is the
// simple, correct first version.  Filling the card (a warp per group of
// trajectories with H split across lanes, mma for the two products) is
// later work.
//
// Arithmetic follows `_rk4_step_inline` (pallas_kernels.py:45-53) and the
// plain version `rk4_integrate_ref` in ops/kernels.py operation by
// operation, in the state dtype.
#include "mlp_field.cuh"

namespace {

template <typename T, int D>
__global__ void rk4_kernel(const T* __restrict__ y0, T* __restrict__ out,
                           int B, int H, int power,
                           const T* __restrict__ w1, const T* __restrict__ b1,
                           const T* __restrict__ w2, const T* __restrict__ b2,
                           T dt, int n_steps, int out_every) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  tdt::stage_mlp(smem, w1, b1, w2, b2, D, H);
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const auto f = tdt::mlp_from_shared<T, D>(smem, H, power);

  T y[D], k1[D], k2[D], k3[D], k4[D], tmp[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = y0[b * D + d];
  if (out_every > 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[b * D + d] = y[d];
  }

  // The field takes no time input, so the stage times are not formed.
  const T third = T(1.0 / 3);
  const T dt_third = dt * third;      // dt * one_third
  const T dt_eighth = dt * T(0.125);  // dt * 0.125
  for (int i = 0; i < n_steps; ++i) {
    f(y, k1);
#pragma unroll
    for (int d = 0; d < D; ++d) tmp[d] = y[d] + dt_third * k1[d];
    f(tmp, k2);
#pragma unroll
    for (int d = 0; d < D; ++d) tmp[d] = y[d] + dt * (k2[d] - third * k1[d]);
    f(tmp, k3);
#pragma unroll
    for (int d = 0; d < D; ++d) tmp[d] = y[d] + dt * (k1[d] - k2[d] + k3[d]);
    f(tmp, k4);
#pragma unroll
    for (int d = 0; d < D; ++d)
      y[d] = y[d] + dt_eighth * (k1[d] + T(3) * (k2[d] + k3[d]) + k4[d]);
    if (out_every > 0 && (i + 1) % out_every == 0) {
      const size_t row = (size_t)((i + 1) / out_every) * B * D;
#pragma unroll
      for (int d = 0; d < D; ++d) out[row + b * D + d] = y[d];
    }
  }
  if (out_every == 0) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[b * D + d] = y[d];
  }
}

template <typename T>
int launch(int B, int D, int H, int power, const void* y0, const void* w1,
           const void* b1, const void* w2, const void* b2, double dt,
           int n_steps, int out_every, void* out, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = (size_t)(2 * D * H + H + D) * sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TDT_LAUNCH_RK4(DD)                                                   \
  rk4_kernel<T, DD><<<blocks, threads, smem, st>>>(                          \
      static_cast<const T*>(y0), static_cast<T*>(out), B, H, power,          \
      static_cast<const T*>(w1), static_cast<const T*>(b1),                  \
      static_cast<const T*>(w2), static_cast<const T*>(b2), (T)dt, n_steps, \
      out_every)
  TDT_DISPATCH_D(D, TDT_LAUNCH_RK4)
#undef TDT_LAUNCH_RK4
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  y0 is (B, D); out is (B, D), or
// (n_steps / out_every + 1, B, D) when out_every > 0.  dt is the step in
// the state dtype, passed exactly as a double.  Returns cudaGetLastError().
extern "C" int tdt_rk4(int dtype, int B, int D, int H, int power,
                       const void* y0, const void* w1, const void* b1,
                       const void* w2, const void* b2, double dt, int n_steps,
                       int out_every, void* out, void* stream) {
  if (dtype == 0)
    return launch<float>(B, D, H, power, y0, w1, b1, w2, b2, dt, n_steps,
                         out_every, out, stream);
  if (dtype == 1)
    return launch<double>(B, D, H, power, y0, w1, b1, w2, b2, dt, n_steps,
                          out_every, out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

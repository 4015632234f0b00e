// K-rk4: the whole fixed-grid RK4 (3/8 rule) time loop in one kernel.
//
// Replaces the TPU kernel torchdiffeq_tpu/ops/pallas_kernels.py:56
// (`rk4_integrate`, pallas_call at :161), which keeps a batch tile of
// trajectories in VMEM for all n_steps.  Here a group of L lanes of one
// warp owns one trajectory (L a power of two from 1 to 32, chosen on the
// host by ops/kernels.py `_rk4_group_width`): every lane of the group holds
// the state y[D] and the four slopes in registers, the MLP weights are
// staged once per block in shared memory, and all n_steps run without
// touching device memory except for the strided trajectory rows, which
// lane 0 of the group writes.
//
// What bounds it on an H100: not bytes (a step reads no device memory) but
// the latency of the dependent chain of each field evaluation: H hidden
// units, each D multiplies and adds, a tanh and D more multiplies and adds,
// four evaluations a step, built with --fmad=false (so at most half the
// card's FMA rate is reachable).  The first version gave each trajectory
// one thread: at B=1024 that is 8 blocks of 128 threads on 132 SMs, and
// every evaluation walked all H units one after another.  This one splits
// the H units across the group (GroupMlpField, mlp_field.cuh): a lane walks
// H/L units and the group adds its D partial sums in log2(L) shuffle
// levels, so the chain is H/L units long and B*L threads fill the card.
// Every lane then forms the stage sums redundantly, which needs no shared
// memory and no __syncthreads inside the time loop; that redundancy is why
// the host picks L=1 at a large batch, where B threads already fill the
// card (L=1 runs MlpField's loop, the first version's).
//
// Arithmetic follows `_rk4_step_inline` (pallas_kernels.py:45-53) and the
// plain version `rk4_integrate_ref` in ops/kernels.py operation by
// operation, in the state dtype; only the hidden-unit summation order of
// the second product differs (the plain version's is a matmul's).
#include "mlp_field.cuh"

namespace {

// The time loop for trajectory b, with the field f (every lane of a group
// runs it; `writer` writes the trajectory rows).
template <typename T, int D, typename F>
__device__ __forceinline__ void integrate(const F& f, const T* __restrict__ y0,
                                          T* __restrict__ out, int B, int b, bool writer,
                                          T dt, int n_steps, int out_every) {
  T y[D], k1[D], k2[D], k3[D], k4[D], tmp[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = y0[b * D + d];
  if (out_every > 0 && writer) {
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
    if (out_every > 0 && (i + 1) % out_every == 0 && writer) {
      const size_t row = (size_t)((i + 1) / out_every) * B * D;
#pragma unroll
      for (int d = 0; d < D; ++d) out[row + b * D + d] = y[d];
    }
  }
  if (out_every == 0 && writer) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[b * D + d] = y[d];
  }
}

template <typename T, int D>
__global__ void rk4_kernel(const T* __restrict__ y0, T* __restrict__ out,
                           int B, int H, int power,
                           const T* __restrict__ w1, const T* __restrict__ b1,
                           const T* __restrict__ w2, const T* __restrict__ b2,
                           T dt, int n_steps, int out_every, int L) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  tdt::stage_mlp(smem, w1, b1, w2, b2, D, H);
  __syncthreads();

  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const auto f = tdt::mlp_from_shared<T, D>(smem, H, power);
  if (L == 1) {   // a thread a trajectory: MlpField's loop over all H units
    if (gid < B) integrate<T, D>(f, y0, out, B, gid, true, dt, n_steps, out_every);
    return;
  }
  // every group of a warp runs the same n_steps, so the shuffles name the
  // whole warp: a constant mask, where each group's own (tdt::group_mask)
  // would cost a sync of its lanes before every shuffle (1.4x the time at
  // B=1024).  So the warp stays whole: a warp whose every group lies past
  // the batch has nothing to do; in a warp that straddles the end, a group
  // past it runs row B-1 and writes nothing.
  if ((gid & ~31) / L >= B) return;
  const int lane = gid & (L - 1);
  const bool live = gid / L < B;
  const tdt::GroupMlpField<T, D> g{f.w1, f.b1, f.w2, f.b2, H, power, lane, L,
                                   0xffffffffu};
  integrate<T, D>(g, y0, out, B, live ? gid / L : B - 1, live && lane == 0, dt, n_steps,
                  out_every);
}

template <typename T>
int launch(int B, int D, int H, int power, const void* y0, const void* w1,
           const void* b1, const void* w2, const void* b2, double dt,
           int n_steps, int out_every, int L, void* out, void* stream) {
  const int threads = 128;
  const long long lanes = (long long)B * L;
  const int blocks = (int)((lanes + threads - 1) / threads);
  const size_t smem = (size_t)(2 * D * H + H + D) * sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TDT_LAUNCH_RK4(DD)                                                   \
  rk4_kernel<T, DD><<<blocks, threads, smem, st>>>(                          \
      static_cast<const T*>(y0), static_cast<T*>(out), B, H, power,          \
      static_cast<const T*>(w1), static_cast<const T*>(b1),                  \
      static_cast<const T*>(w2), static_cast<const T*>(b2), (T)dt, n_steps, \
      out_every, L)
  TDT_DISPATCH_D(D, TDT_LAUNCH_RK4)
#undef TDT_LAUNCH_RK4
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  y0 is (B, D); out is (B, D), or
// (n_steps / out_every + 1, B, D) when out_every > 0.  dt is the step in
// the state dtype, passed exactly as a double.  group is the lanes a
// trajectory, a power of two from 1 to 32.  Returns cudaGetLastError().
extern "C" int tdt_rk4(int dtype, int B, int D, int H, int power,
                       const void* y0, const void* w1, const void* b1,
                       const void* w2, const void* b2, double dt, int n_steps,
                       int out_every, int group, void* out, void* stream) {
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(B, D, H, power, y0, w1, b1, w2, b2, dt, n_steps,
                         out_every, group, out, stream);
  if (dtype == 1)
    return launch<double>(B, D, H, power, y0, w1, b1, w2, b2, dt, n_steps,
                          out_every, group, out, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

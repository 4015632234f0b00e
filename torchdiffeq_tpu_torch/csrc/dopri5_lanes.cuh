// K-dopri5: adaptive explicit Runge-Kutta with a step-size controller per
// trajectory, the whole solve in one kernel.
//
// Replaces the TPU kernel torchdiffeq_tpu/ops/pallas_kernels.py:336
// (`dopri5_integrate_batched`, pallas_call at :545; helpers `_make_lane_ops`
// :238-333 and `_tableau_consts` :182).  There each of a tile's 128 VPU
// lanes owns a trajectory and one tile-wide while_loop runs until every
// lane is done, stepping finished lanes with dt = 0.  Here a group of L
// lanes of one warp owns a trajectory (L a power of two from 1 to 32, at
// most H, chosen on the host by ops/kernels.py `_lane_group_width`) and
// runs its own `while (t < t1 && steps < max_steps)` loop, so a
// trajectory's result never depends on which others share its warp or
// block.
//
// Per trajectory, as in the TPU kernel: time in the state dtype; the
// Hairer initial step (`hairer_dt`) unless first_step is given; the
// tableau's stage sweep with the coefficient sums formed BEFORE the dt
// multiply; tol = atol + rtol * max(|y|, |y1|); the RMS of err/tol over the
// true D; accept = ratio <= 1; the I-controller factor
// min(ifactor, max(safety / max(ratio, tiny)^(1/order), dfactor on reject
// else 1)); quartic dense output for every output time t_s with
// t < t_s <= t + dt on an accepted step; outputs at or before t0 equal y0;
// NaN in every row whose time the trajectory never reached.
//
// The tableau arrives as a small array (any explicit method of up to
// TDT_PACK_STAGES stages: dopri5, tsit5, bosh3, fehlberg2, adaptive_heun,
// dopri8; a traced instance has it compiled in instead, below).  The per-trajectory numerics live in lane_ops.cuh, shared with
// the event kernel.  A problem of at most TDT_MAX_STAGES stages and D <=
// TDT_REG_MAX_D runs an instance that holds its state and slopes in
// registers (`lanes_kernel`, one per D); any other (dopri8's 14 stages, or
// D > 8) runs `lanes_wide_kernel`, which holds them in a shared-memory
// slice per trajectory (lane_ops.cuh `WideLane`) for a D known only at run
// time: registers that grow with D and the stage count would spill.  Its
// block holds as many trajectories as the card's shared memory takes (the
// host picks the block size).
//
// What bounds it on an H100: not bytes (the state, the slopes and the
// controller live in registers; device memory sees y0, the emitted rows and
// the counters only) but the latency of each step's dependent chain: 4-7
// field evaluations of H tanh units each, then the stage sums, the error
// ratio and the controller.  One thread a trajectory walked all H units of
// every evaluation in turn and, at B=1024, filled 8 of 132 SMs, and the
// lanes of a warp ran as long as its slowest (2-9 steps on the spiral).
// Here the group splits the H units (GroupMlpField, mlp_field.cuh), so an
// evaluation's chain is H/L units plus log2(L) shuffle levels, and B*L
// threads fill the card; the warp holds 32/L trajectories, so fewer of them
// wait for the slowest.  Every lane of the group runs the stage sums, the
// controller and the dense output redundantly on the same bits (the
// butterfly gives each the same sums), so every branch, the loop's end
// included, is the same across the group: the group stays converged with
// no vote, shared memory or barrier in the loop, and its shuffles name
// only its own lanes, so groups of a warp may leave the loop at different
// steps.  Lane 0 of the group writes the trajectory's rows and counters, in
// the (S, D, B) layout, trajectory index fastest.  The redundant work is why
// the host picks L=1 at a large batch, where B threads already fill the
// card; L=1 is an instance of its own (kGroup false) running MlpField's
// loop, the first version's, with no group code beside it.
//
// 16-bit states (bfloat16 and float16, as the TPU kernel runs them) are
// instances of the same templates on tdt::Lo (mlp_field.cuh): time, the
// tableau, the tolerances and every intermediate in the state dtype, each
// operation rounded to it, the sums of the field's products and of the norms
// accumulated in float and rounded once, as PyTorch's 16-bit operations
// (and the plain versions) do.  The step and accept counters stay int: the
// TPU kernel keeps them in the state dtype, where a bfloat16 count stops at
// 256 (float16: 2048) and its `max_steps` test can then never end a lane;
// here a lane stops after `max_steps` steps and its counts are exact
// (ROADMAP C10).
//
// The kernels and their host-side launch live here; dopri5_lanes.cu
// instantiates the float32 and float64 ones and holds the C entry point,
// dopri5_lanes_16bit.cu the bfloat16 and float16 ones (tdt::Lo), so that the
// build compiles the two halves in parallel.
//
// Any other field takes a traced instance: `lanes_traced_kernel` runs the
// same solve (`lanes_solve`) for a field functor that ops/traced.py emits
// from the Python field (its per-sample function traced by torch.fx into
// straight-line code of the state dtype, in the traced graph's operation
// order).  The tracer's source instantiates it, with its own C entry point,
// and is built at first use into a library of its own.
//
// What bounds a traced instance on an H100: one lane a trajectory, so a
// warp lasts as long as its slowest lane, and the kernel as long as the
// slowest lane of the batch: that lane's steps times one step's dependent
// chain (at B=1024 the batch is 32 warps, one an SM, with no other warp
// to hide a stall).  Bytes and operations are thousands of times below
// that.  So the design shortens the chain: the tableau is compiled into
// the instance (lane_ops.cuh), so the stage sums hold no shared-memory load
// and no branch on a coefficient, their zero terms are gone and the stage
// times are constants; the next output time is held in a register
// (`lanes_solve`), so shared memory is read only when an output is emitted.
// What is left is the arithmetic: the field's evaluations and the stage
// sums, then the error ratio's IEEE divides and square root and the
// controller's pow.  It stays one lane a trajectory: a traced field is a
// few operations on a state of a few rows (the ensemble's, 5 on D=2), so a
// group of lanes split by output row would spend a shuffle round on every
// stage, more than the work it splits; the hand-written instances' groups
// split an MLP's hidden units, which a traced field does not have.
#pragma once

#include "lane_ops.cuh"

namespace tdt_lanes {

// The solve of trajectory b for the field f (every lane of its group runs
// it; `writer`, lane 0 of the group, writes the rows and counters), from the
// tableau `tb` (either kind, lane_ops.cuh) and the output times staged in
// shared memory.
template <typename T, int D, typename F, typename Tab>
__device__ __forceinline__ void lanes_solve(const F& f, const Tab& tb,
                                            const T* __restrict__ y0,
                                            const T* __restrict__ s_ts, int S, int B,
                                            int b, bool writer, T t0, T t1, T rtol,
                                            T atol, T safety, T ifactor, T dfactor,
                                            T first_step, int use_first_step,
                                            int max_steps, T* __restrict__ ys,
                                            int* __restrict__ n_acc_out,
                                            int* __restrict__ n_steps_out) {
  T y[D], fc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = y0[d * B + b];
  T t = t0;

  // The next output time, s_ts[s_next]: a traced instance (a compiled
  // tableau) holds it in a register and reads shared memory only when an
  // output is emitted; the hand-written instances read it at each test,
  // their code as it was measured when they were redesigned.
  int s_next = 0;
  T t_next;
  if constexpr (Tab::kCompiled) t_next = S > 0 ? s_ts[0] : T(0);
  const auto next_time = [&]() -> T {
    if constexpr (Tab::kCompiled)
      return t_next;
    else
      return s_ts[s_next];
  };
  const auto emitted = [&]() {
    ++s_next;
    if constexpr (Tab::kCompiled) {
      if (s_next < S) t_next = s_ts[s_next];
    }
  };

  // outputs at or before the start time are the initial state
  while (s_next < S && next_time() <= t0) {
    if (writer) {
#pragma unroll
      for (int d = 0; d < D; ++d) ys[((size_t)s_next * D + d) * B + b] = y[d];
    }
    emitted();
  }

  f(t, y, fc);
  T dt = use_first_step ? first_step
                        : tdt::hairer_dt<T, D>(f, tb, t, y, fc, rtol, atol);

  int n_acc = 0, n_steps = 0;
  T k[TDT_MAX_STAGES][D];
  T y1[D], f1[D], err[D];
  while (t < t1 && n_steps < max_steps) {
    const T t_prop = t + dt;
    tdt::stage_sweep<T, D>(f, tb, t, y, fc, dt, k, y1, f1, err);
    const T ratio = tdt::error_ratio<T, D>(y, y1, err, rtol, atol);
    const bool accept = ratio <= T(1);

    // dense output for the output times this step covers
    if (accept && s_next < S && next_time() <= t_prop) {
      tdt::Quartic<T, D> q;
      tdt::fit_quartic<T, D>(tb, k, y, y1, fc, f1, dt, q);
      const T dt_safe = dt > T(0) ? dt : T(1);
      while (s_next < S && next_time() <= t_prop) {
        T val[D];
        tdt::eval_quartic<T, D>(q, (next_time() - t) / dt_safe, val);
        if (writer) {
#pragma unroll
          for (int d = 0; d < D; ++d) ys[((size_t)s_next * D + d) * B + b] = val[d];
        }
        emitted();
      }
    }

    if (accept) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        y[d] = y1[d];
        fc[d] = f1[d];
      }
      t = t_prop;
      ++n_acc;
    }
    dt = tdt::next_dt<T>(dt, ratio, safety, ifactor, dfactor, tb);
    ++n_steps;
  }

  if (!writer) return;
  // rows whose time this trajectory never reached (max_steps ran out)
  for (; s_next < S; ++s_next) {
#pragma unroll
    for (int d = 0; d < D; ++d) ys[((size_t)s_next * D + d) * B + b] = T(NAN);
  }
  n_acc_out[b] = n_acc;
  n_steps_out[b] = n_steps;
}

template <typename T, int D, bool kGroup>
__global__ void lanes_kernel(const T* __restrict__ y0, const T* __restrict__ ts,
                             int S, int B, T t0, T t1, T rtol, T atol,
                             T safety, T ifactor, T dfactor, T first_step,
                             int use_first_step, int max_steps,
                             const T* __restrict__ tab, int n_alpha, int order,
                             int fsal, int H, int power,
                             const T* __restrict__ w1, const T* __restrict__ b1,
                             const T* __restrict__ w2, const T* __restrict__ b2,
                             int L, T* __restrict__ ys, int* __restrict__ n_acc_out,
                             int* __restrict__ n_steps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n_mlp = tdt::stage_mlp(smem, w1, b1, w2, b2, D, H);
  T* s_tab = smem + n_mlp;
  T* s_ts = s_tab + TDT_TAB_SIZE;
  for (int i = threadIdx.x; i < TDT_TAB_SIZE; i += blockDim.x) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) s_ts[i] = ts[i];
  __syncthreads();

  // the L lanes of group b own trajectory b; a group past the batch returns
  // whole
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = gid / L;
  if (b >= B) return;
  const bool writer = (gid & (L - 1)) == 0;
  const tdt::Tableau<T> tb = tdt::tableau_from_shared<T>(s_tab, n_alpha, order, fsal);
  // L = 1 (kGroup false) is an instance of its own: a lane a trajectory
  // walks all H units in MlpField's loop, which the compiler unrolls further
  // than the group's strided one, and its registers and code are not sized
  // for the group's path
  if constexpr (kGroup)
    lanes_solve<T, D>(tdt::group_mlp_from_shared<T, D>(smem, H, power, L), tb, y0,
                      s_ts, S, B, b, writer, t0, t1, rtol, atol, safety, ifactor,
                      dfactor, first_step, use_first_step, max_steps, ys, n_acc_out,
                      n_steps_out);
  else
    lanes_solve<T, D>(tdt::mlp_from_shared<T, D>(smem, H, power), tb, y0, s_ts, S, B,
                      b, writer, t0, t1, rtol, atol, safety, ifactor, dfactor,
                      first_step, use_first_step, max_steps, ys, n_acc_out,
                      n_steps_out);
}

// The solve for a traced field F (ops/traced.py): one lane a trajectory,
// the field built for lane b from its per-lane values (`lane`, (P, B)
// lanes-major like the state) and the shared tensors (`shared`), which it
// reads from device memory; the tableau Tab compiled into the instance, so
// only the output times are staged in shared memory.  F holds D and T; its
// instance is compiled on its own, from the source the tracer emitted.
template <typename T, int D, typename F, typename Tab>
__global__ void lanes_traced_kernel(const T* __restrict__ y0, const T* __restrict__ ts,
                                    int S, int B, T t0, T t1, T rtol, T atol,
                                    T safety, T ifactor, T dfactor, T first_step,
                                    int use_first_step, int max_steps,
                                    const T* __restrict__ lane,
                                    const T* __restrict__ shared, T* __restrict__ ys,
                                    int* __restrict__ n_acc_out,
                                    int* __restrict__ n_steps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s_ts = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < S; i += blockDim.x) s_ts[i] = ts[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const F f(lane, shared, b, B);
  lanes_solve<T, D>(f, Tab(), y0, s_ts, S, B, b, true, t0, t1, rtol, atol, safety,
                    ifactor, dfactor, first_step, use_first_step, max_steps, ys,
                    n_acc_out, n_steps_out);
}

// The host launch of a traced instance: blocks of `threads` trajectories.
template <typename T, int D, typename F, typename Tab>
int launch_traced(int B, const void* y0, const void* ts, int S, double t0, double t1,
                  double rtol, double atol, double safety, double ifactor,
                  double dfactor, double first_step, int use_first_step, int max_steps,
                  const void* lane, const void* shared, int threads, void* ys,
                  void* n_acc, void* n_steps, void* stream) {
  static_assert(Tab::kCompiled && Tab::n_alpha >= 1 && Tab::n_alpha <= TDT_MAX_ALPHA,
                "a traced instance's tableau is compiled into it, and its stage "
                "slopes fit TDT_MAX_STAGES");
  if (B <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = (size_t)S * sizeof(T);
  auto kernel = lanes_traced_kernel<T, D, F, Tab>;
  const int code = tdt::allow_shared(kernel, smem);
  if (code) return code;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(y0), static_cast<const T*>(ts), S, B, (T)t0, (T)t1,
      (T)rtol, (T)atol, (T)safety, (T)ifactor, (T)dfactor, (T)first_step,
      use_first_step, max_steps, static_cast<const T*>(lane),
      static_cast<const T*>(shared), static_cast<T*>(ys), static_cast<int*>(n_acc),
      static_cast<int*>(n_steps));
  return (int)cudaGetLastError();
}

// The same solve for any D and up to TDT_PACK_STAGES stages, the state and
// slopes in a shared-memory slice of each trajectory (lane_ops.cuh
// `WideLane`).  The group splits every element-wise pass by state row and
// each field evaluation by hidden unit, then by output row; each lane writes
// its rows' outputs.
template <typename T>
__global__ void lanes_wide_kernel(const T* __restrict__ y0, const T* __restrict__ ts,
                                  int S, int B, int D, T t0, T t1, T rtol, T atol,
                                  T safety, T ifactor, T dfactor, T first_step,
                                  int use_first_step, int max_steps,
                                  const T* __restrict__ tab, int n_alpha, int order,
                                  int fsal, int H, int power,
                                  const T* __restrict__ w1, const T* __restrict__ b1,
                                  const T* __restrict__ w2, const T* __restrict__ b2,
                                  int L, T* __restrict__ ys, int* __restrict__ n_acc_out,
                                  int* __restrict__ n_steps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n_mlp = tdt::stage_mlp(smem, w1, b1, w2, b2, D, H);
  T* s_tab = smem + n_mlp;
  T* s_ts = s_tab + TDT_TAB_SIZE;
  T* s_slices = s_ts + S;
  for (int i = threadIdx.x; i < TDT_TAB_SIZE; i += blockDim.x) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) s_ts[i] = ts[i];
  __syncthreads();

  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = gid / L;
  if (b >= B) return;
  const tdt::Tableau<T> tb = tdt::tableau_from_shared<T>(s_tab, n_alpha, order, fsal);
  const int n_st = n_alpha + 1;
  const tdt::WideLane<T> w(
      smem, D, H, power,
      s_slices + (size_t)(threadIdx.x / L) * tdt::wide_slice_elems(D, H, n_st, false),
      n_st, tdt::lane_group(L));
  const int lane = w.g.lane;

  for (int d = lane; d < D; d += L) w.y[d] = y0[(size_t)d * B + b];
  w.g.sync();
  T t = t0;
  int s_next = 0;
  while (s_next < S && s_ts[s_next] <= t0) {
    for (int d = lane; d < D; d += L) ys[((size_t)s_next * D + d) * B + b] = w.y[d];
    ++s_next;
  }
  w.field(w.y, w.k);
  T dt = use_first_step ? first_step : w.hairer_dt(rtol, atol, tb.inv_order);

  int n_acc = 0, n_steps = 0;
  while (t < t1 && n_steps < max_steps) {
    const T t_prop = t + dt;
    w.stage_sweep(tb, dt);
    const T ratio = w.error_ratio(rtol, atol);
    const bool accept = ratio <= T(1);
    if (accept && s_next < S && s_ts[s_next] <= t_prop) {
      const T dt_safe = dt > T(0) ? dt : T(1);
      for (int d = lane; d < D; d += L) {
        T e, dd, c, bb, a;
        w.quartic_row(tb, dt, d, e, dd, c, bb, a);
        for (int s = s_next; s < S && s_ts[s] <= t_prop; ++s)
          ys[((size_t)s * D + d) * B + b] =
              tdt::quartic_at<T>(e, dd, c, bb, a, (s_ts[s] - t) / dt_safe);
      }
      while (s_next < S && s_ts[s_next] <= t_prop) ++s_next;
    }
    if (accept) {
      w.accept_step();
      t = t_prop;
      ++n_acc;
    }
    dt = tdt::next_dt<T>(dt, ratio, safety, ifactor, dfactor, tb);
    ++n_steps;
  }
  for (; s_next < S; ++s_next)
    for (int d = lane; d < D; d += L) ys[((size_t)s_next * D + d) * B + b] = T(NAN);
  if (lane != 0) return;
  n_acc_out[b] = n_acc;
  n_steps_out[b] = n_steps;
}

template <typename T>
int launch(int B, int D, int H, int power, const void* y0, const void* ts,
           int S, double t0, double t1, double rtol, double atol, double safety,
           double ifactor, double dfactor, double first_step, int use_first_step,
           int max_steps, const void* tab, int n_alpha, int order, int fsal,
           const void* w1, const void* b1, const void* w2, const void* b2, int L,
           int threads, void* ys, void* n_acc, void* n_steps, void* stream) {
  const int blocks = (int)(((long long)B * L + threads - 1) / threads);
  size_t smem = (size_t)(2 * D * H + H + D + TDT_TAB_SIZE + S) * sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > TDT_REG_MAX_D || n_alpha > TDT_MAX_ALPHA) {
    smem += (size_t)(threads / L) * tdt::wide_slice_elems(D, H, n_alpha + 1, false) *
            sizeof(T);
    const int code = tdt::allow_shared(lanes_wide_kernel<T>, smem);
    if (code) return code;
    lanes_wide_kernel<T><<<blocks, threads, smem, st>>>(
        static_cast<const T*>(y0), static_cast<const T*>(ts), S, B, D, (T)t0, (T)t1,
        (T)rtol, (T)atol, (T)safety, (T)ifactor, (T)dfactor, (T)first_step,
        use_first_step, max_steps, static_cast<const T*>(tab), n_alpha, order, fsal,
        H, power, static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(b2), L, static_cast<T*>(ys),
        static_cast<int*>(n_acc), static_cast<int*>(n_steps));
    return (int)cudaGetLastError();
  }
#define TDT_LAUNCH_LANES(DD)                                                    \
  {                                                                             \
    auto kernel = L == 1 ? lanes_kernel<T, DD, false> : lanes_kernel<T, DD, true>; \
    const int code = tdt::allow_shared(kernel, smem);                           \
    if (code) return code;                                                      \
    kernel<<<blocks, threads, smem, st>>>(                                      \
        static_cast<const T*>(y0), static_cast<const T*>(ts), S, B, (T)t0,      \
        (T)t1, (T)rtol, (T)atol, (T)safety, (T)ifactor, (T)dfactor,             \
        (T)first_step, use_first_step, max_steps, static_cast<const T*>(tab),   \
        n_alpha, order, fsal, H, power, static_cast<const T*>(w1),              \
        static_cast<const T*>(b1), static_cast<const T*>(w2),                   \
        static_cast<const T*>(b2), L, static_cast<T*>(ys),                      \
        static_cast<int*>(n_acc), static_cast<int*>(n_steps));                  \
  }
  TDT_DISPATCH_D(D, TDT_LAUNCH_LANES)
#undef TDT_LAUNCH_LANES
  return (int)cudaGetLastError();
}

}  // namespace tdt_lanes

// K-events: per-lane adaptive explicit Runge-Kutta until each trajectory's
// own event function changes sign, then a fixed-count bisection of the event
// time on the bracketing step's quartic interpolant, all in one kernel.
//
// Replaces the TPU kernel torchdiffeq_tpu/ops/pallas_kernels.py:580
// (`dopri5_events_batched`, pallas_call at :780).  There each of a tile's
// 128 VPU lanes owns a trajectory; one tile-wide while_loop runs while any
// lane is live (no event found, fewer than max_steps steps), stepping the
// others with dt = 0, and each step that hits records its quartic's five
// coefficient rows and its (t, dt) bracket for a vectorised bisection after
// the loop.  Here a group of L lanes of one warp owns a trajectory (L a
// power of two from 1 to 32, at most H, chosen on the host by
// ops/kernels.py `_lane_group_width`) and runs its own loop; since a
// trajectory freezes at its hit, its bracket is the step it just took, so
// the group leaves its loop with that step's stages still in registers,
// fits the quartic once and bisects right there.  No coefficient rows are
// carried through the loop.
//
// Per trajectory, as in the TPU kernel: time (t, dt, the event time) in
// the state dtype; the step, controller and quartic of K-dopri5
// (lane_ops.cuh); the event evaluated at (t + dt, y1) after every step; a
// hit is accept && sign(v1) != s0, with sign NaN at NaN (so a NaN event
// value on an accepted step is a hit, as in JAX); the bisection runs
// `bisect_iters` times on x in [0, 1]: xm = 0.5 * (lo + hi), keep the half
// whose event sign equals s0's; event_t = t + x * dt and y_event =
// quartic(x) with x = 0.5 * (lo + hi).  A trajectory that never fires returns event_t =
// NaN and its last accepted state.
//
// The event family is the one a CUDA kernel can evaluate: K <= 4 affine
// outputs e_k = (W[k,:] . y + c_k * t) + b_k (LinearEvent in
// models/neural_ode.py), sign-combined per lane as min_k(e_k * sign0_k) with
// the per-lane sign0 (K, B) computed at t0 by the caller (the JAX package's
// parallel/batched.py combination).  The MLP field, tableau and event
// weights are staged in shared memory.
//
// What bounds it on an H100: as K-dopri5 (dopri5_lanes.cuh), the latency of
// each step's dependent chain of field evaluations, not bytes; each step
// adds one event evaluation (K * D multiply-adds) and the bisection 40
// quartic and event evaluations at the end.  As there, the group splits
// each evaluation's H units and runs everything else redundantly on the
// same bits, so the hit, the `break` and the bisection are the same across
// the group; its shuffles name only its own lanes, so the groups of a warp
// may fire at different steps, and a warp holds 32/L trajectories, so
// fewer of them wait for its slowest.  Lane 0 of the group writes the
// outputs.  L=1 is an instance of its own (kGroup false), as there.  And as
// there, dopri8 and D > 8 run a shared-memory instance
// (`events_wide_kernel`), which also keeps the hit step's quartic there for
// the bisection.
//
// 16-bit states run instances on tdt::Lo, with int counters, as K-dopri5's
// (dopri5_lanes.cuh).
//
// The kernels and their host-side launch live here; dopri5_events.cu
// instantiates the float32 and float64 ones and holds the C entry point,
// dopri5_events_16bit.cu the bfloat16 and float16 ones (tdt::Lo), so that the
// build compiles the two halves in parallel.
//
// Any other field or event function takes a traced instance
// (`events_traced_kernel`, one lane a trajectory): the same solve
// (`events_solve`) for a field and an event functor that ops/traced.py emits,
// the event's K outputs sign-combined inside its functor, as
// parallel/batched.py combines them (min_k(e_k * sign0_k)); any K.  As
// K-dopri5's traced instance (dopri5_lanes.cuh), it lasts as long as its
// slowest lane's steps times one step's dependent chain, then that lane's
// bisection; its tableau is compiled into it, so it stages nothing in
// shared memory and its stage sums are straight-line arithmetic.
#pragma once

#include "lane_ops.cuh"

#define TDT_MAX_EVENTS 4

namespace tdt_events {

using tdt::nmax;
using tdt::nmin;

// sign with NaN at NaN (jnp.sign); 0 at +-0
template <typename T>
__device__ __forceinline__ T nsign(T x) {
  return x > T(0) ? T(1) : (x < T(0) ? T(-1) : (x == T(0) ? T(0) : x));
}

// min_k(e_k * s0_k) for the affine event outputs e_k at (t, y); NaN-propagating.
template <typename T, int D>
struct LinearEvent {
  const T* w;  // (K, D) row-major
  const T* c;  // (K,)
  const T* b;  // (K,)
  int K;

  __device__ __forceinline__ T operator()(T t, const T (&y)[D],
                                          const T (&s0)[TDT_MAX_EVENTS]) const {
    T out = T(0);
#pragma unroll
    for (int k = 0; k < TDT_MAX_EVENTS; ++k) {
      if (k < K) {
        // y @ W.T, one product: its sum in acc_t<T>
        tdt::acc_t<T> dot = tdt::acc(y[0]) * tdt::acc(w[k * D]);
#pragma unroll
        for (int d = 1; d < D; ++d) dot = dot + tdt::acc(y[d]) * tdt::acc(w[k * D + d]);
        const T e = (tdt::from_acc<T>(dot) + c[k] * t) + b[k];
        const T v = e * s0[k];
        out = k == 0 ? v : nmin(out, v);
      }
    }
    return out;
  }
};

// A LinearEvent with the lane's signs at t0: the lane's event `ev(t, y)`.
template <typename T, int D>
struct SignedLinearEvent {
  LinearEvent<T, D> ev;
  T s0[TDT_MAX_EVENTS];
  __device__ __forceinline__ T operator()(T t, const T (&y)[D]) const { return ev(t, y, s0); }
};

// The solve of trajectory b to its event for the field f and the lane's
// sign-combined event ev(t, y), then the bisection; `writer` (lane 0 of the
// group) writes the outputs.
template <typename T, int D, typename F, typename E, typename Tab>
__device__ __forceinline__ void events_solve(const F& f, const E& ev, const Tab& tb,
                                             const T* __restrict__ y0, int B, int b,
                                             bool writer, T t0, T rtol, T atol,
                                             T safety, T ifactor, T dfactor,
                                             T first_step, int use_first_step,
                                             int max_steps, int bisect_iters,
                                             T* __restrict__ event_t_out,
                                             T* __restrict__ y_event_out,
                                             int* __restrict__ found_out,
                                             int* __restrict__ n_acc_out,
                                             int* __restrict__ n_steps_out) {
  T y[D], fc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = y0[d * B + b];
  T t = t0;
  f(t, y, fc);
  const T s0 = nsign<T>(ev(t, y));
  T dt = use_first_step ? first_step
                        : tdt::hairer_dt<T, D>(f, tb, t, y, fc, rtol, atol);

  int n_acc = 0, n_steps = 0;
  bool found = false;
  T k[TDT_MAX_STAGES][D];
  T y1[D], f1[D], err[D];
  while (n_steps < max_steps) {
    const T t_prop = t + dt;
    tdt::stage_sweep<T, D>(f, tb, t, y, fc, dt, k, y1, f1, err);
    const T ratio = tdt::error_ratio<T, D>(y, y1, err, rtol, atol);
    const bool accept = ratio <= T(1);
    ++n_steps;
    if (accept) {
      ++n_acc;
      if (!(nsign<T>(ev(t_prop, y1)) == s0)) {
        // the hit: (t, dt) brackets the event, and y, fc, k, y1, f1 still
        // hold this step for the quartic below
        found = true;
        break;
      }
#pragma unroll
      for (int d = 0; d < D; ++d) {
        y[d] = y1[d];
        fc[d] = f1[d];
      }
      t = t_prop;
    }
    dt = tdt::next_dt<T>(dt, ratio, safety, ifactor, dfactor, tb);
  }

  T event_t = T(NAN);
  if (found) {
    tdt::Quartic<T, D> q;
    tdt::fit_quartic<T, D>(tb, k, y, y1, fc, f1, dt, q);
    T lo = T(0), hi = T(1), ym[D];
    for (int i = 0; i < bisect_iters; ++i) {
      const T xm = T(0.5) * (lo + hi);
      tdt::eval_quartic<T, D>(q, xm, ym);
      const bool same = nsign<T>(ev(t + xm * dt, ym)) == s0;
      lo = same ? xm : lo;
      hi = same ? hi : xm;
    }
    const T x = T(0.5) * (lo + hi);
    event_t = t + x * dt;
    tdt::eval_quartic<T, D>(q, x, y);
  }
  if (!writer) return;
  event_t_out[b] = event_t;
#pragma unroll
  for (int d = 0; d < D; ++d) y_event_out[(size_t)d * B + b] = y[d];
  found_out[b] = found ? 1 : 0;
  n_acc_out[b] = n_acc;
  n_steps_out[b] = n_steps;
}

template <typename T, int D, bool kGroup>
__global__ void events_kernel(const T* __restrict__ y0, int B, T t0, T rtol, T atol,
                              T safety, T ifactor, T dfactor, T first_step,
                              int use_first_step, int max_steps,
                              const T* __restrict__ tab, int n_alpha, int order,
                              int fsal, int H, int power,
                              const T* __restrict__ w1, const T* __restrict__ b1,
                              const T* __restrict__ w2, const T* __restrict__ b2,
                              int K, const T* __restrict__ ev_w,
                              const T* __restrict__ ev_c, const T* __restrict__ ev_b,
                              const T* __restrict__ sign0, int bisect_iters, int L,
                              T* __restrict__ event_t_out, T* __restrict__ y_event_out,
                              int* __restrict__ found_out, int* __restrict__ n_acc_out,
                              int* __restrict__ n_steps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n_mlp = tdt::stage_mlp(smem, w1, b1, w2, b2, D, H);
  T* s_tab = smem + n_mlp;
  T* s_ev = s_tab + TDT_TAB_SIZE;  // W (K*D) | c (K) | b (K)
  for (int i = threadIdx.x; i < TDT_TAB_SIZE; i += blockDim.x) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) s_ev[i] = ev_w[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    s_ev[K * D + i] = ev_c[i];
    s_ev[K * D + K + i] = ev_b[i];
  }
  __syncthreads();

  // the L lanes of group b own trajectory b; a group past the batch returns
  // whole
  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = gid / L;
  if (b >= B) return;
  const tdt::Tableau<T> tb = tdt::tableau_from_shared<T>(s_tab, n_alpha, order, fsal);
  SignedLinearEvent<T, D> ev{{s_ev, s_ev + K * D, s_ev + K * D + K, K}, {}};
#pragma unroll
  for (int k = 0; k < TDT_MAX_EVENTS; ++k) ev.s0[k] = k < K ? sign0[(size_t)k * B + b] : T(0);
  const bool writer = (gid & (L - 1)) == 0;
  // L = 1 (kGroup false) is an instance of its own: a lane a trajectory
  // walks all H units in MlpField's loop, which the compiler unrolls further
  // than the group's strided one, and its registers and code are not sized
  // for the group's path
  if constexpr (kGroup)
    events_solve<T, D>(tdt::group_mlp_from_shared<T, D>(smem, H, power, L), ev, tb, y0, B,
                       b, writer, t0, rtol, atol, safety, ifactor, dfactor, first_step,
                       use_first_step, max_steps, bisect_iters, event_t_out,
                       y_event_out, found_out, n_acc_out, n_steps_out);
  else
    events_solve<T, D>(tdt::mlp_from_shared<T, D>(smem, H, power), ev, tb, y0, B, b,
                       writer, t0, rtol, atol, safety, ifactor, dfactor, first_step,
                       use_first_step, max_steps, bisect_iters, event_t_out,
                       y_event_out, found_out, n_acc_out, n_steps_out);
}

// The event solve for a traced field F and a traced event E (ops/traced.py):
// one lane a trajectory, F built for lane b as in lanes_traced_kernel, E
// from the lane's signs at t0 (`sign0`, (K, B)) and its own shared tensors;
// E sign-combines its K outputs, min_k(e_k * s0_k).  The tableau Tab is
// compiled into the instance: the kernel stages nothing in shared memory.
template <typename T, int D, typename F, typename E, typename Tab>
__global__ void events_traced_kernel(const T* __restrict__ y0, int B, T t0, T rtol,
                                     T atol, T safety, T ifactor, T dfactor,
                                     T first_step, int use_first_step, int max_steps,
                                     const T* __restrict__ lane,
                                     const T* __restrict__ shared,
                                     const T* __restrict__ sign0,
                                     const T* __restrict__ ev_shared, int bisect_iters,
                                     T* __restrict__ event_t_out,
                                     T* __restrict__ y_event_out,
                                     int* __restrict__ found_out,
                                     int* __restrict__ n_acc_out,
                                     int* __restrict__ n_steps_out) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const F f(lane, shared, b, B);
  const E ev(sign0, ev_shared, b, B);
  events_solve<T, D>(f, ev, Tab(), y0, B, b, true, t0, rtol, atol, safety, ifactor,
                     dfactor, first_step, use_first_step, max_steps, bisect_iters,
                     event_t_out, y_event_out, found_out, n_acc_out, n_steps_out);
}

// The host launch of a traced event instance: blocks of `threads`
// trajectories.
template <typename T, int D, typename F, typename E, typename Tab>
int launch_traced(int B, const void* y0, double t0, double rtol, double atol,
                  double safety, double ifactor, double dfactor, double first_step,
                  int use_first_step, int max_steps, const void* lane,
                  const void* shared, const void* sign0, const void* ev_shared,
                  int bisect_iters, int threads, void* event_t, void* y_event,
                  void* found, void* n_acc, void* n_steps, void* stream) {
  static_assert(Tab::kCompiled && Tab::n_alpha >= 1 && Tab::n_alpha <= TDT_MAX_ALPHA,
                "a traced instance's tableau is compiled into it, and its stage "
                "slopes fit TDT_MAX_STAGES");
  if (B <= 0 || threads < 32 || threads > 1024 || threads % 32 != 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (B + threads - 1) / threads;
  events_traced_kernel<T, D, F, E, Tab>
      <<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(y0), B, (T)t0, (T)rtol, (T)atol, (T)safety, (T)ifactor,
          (T)dfactor, (T)first_step, use_first_step, max_steps,
          static_cast<const T*>(lane), static_cast<const T*>(shared),
          static_cast<const T*>(sign0), static_cast<const T*>(ev_shared), bisect_iters,
          static_cast<T*>(event_t), static_cast<T*>(y_event), static_cast<int*>(found),
          static_cast<int*>(n_acc), static_cast<int*>(n_steps));
  return (int)cudaGetLastError();
}

// LinearEvent for a state of D rows known at run time, in shared memory;
// every lane computes it whole, in the register instance's order.
template <typename T>
__device__ __forceinline__ T wide_event(const LinearEvent<T, 1>& ev, int D, T t,
                                        const T* y, const T (&s0)[TDT_MAX_EVENTS]) {
  T out = T(0);
  for (int k = 0; k < ev.K; ++k) {
    tdt::acc_t<T> dot = tdt::acc(y[0]) * tdt::acc(ev.w[k * D]);
    for (int d = 1; d < D; ++d) dot = dot + tdt::acc(y[d]) * tdt::acc(ev.w[k * D + d]);
    const T e = (tdt::from_acc<T>(dot) + ev.c[k] * t) + ev.b[k];
    const T v = e * s0[k];
    out = k == 0 ? v : nmin(out, v);
  }
  return out;
}

// The same solve for any D and up to TDT_PACK_STAGES stages, the state,
// slopes and the hit step's quartic in a shared-memory slice of each
// trajectory (lane_ops.cuh `WideLane`), as lanes_wide_kernel.
template <typename T>
__global__ void events_wide_kernel(const T* __restrict__ y0, int B, int D, T t0,
                                   T rtol, T atol, T safety, T ifactor, T dfactor,
                                   T first_step, int use_first_step, int max_steps,
                                   const T* __restrict__ tab, int n_alpha, int order,
                                   int fsal, int H, int power,
                                   const T* __restrict__ w1, const T* __restrict__ b1,
                                   const T* __restrict__ w2, const T* __restrict__ b2,
                                   int K, const T* __restrict__ ev_w,
                                   const T* __restrict__ ev_c,
                                   const T* __restrict__ ev_b,
                                   const T* __restrict__ sign0, int bisect_iters,
                                   int L, T* __restrict__ event_t_out,
                                   T* __restrict__ y_event_out, int* __restrict__ found_out,
                                   int* __restrict__ n_acc_out,
                                   int* __restrict__ n_steps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n_mlp = tdt::stage_mlp(smem, w1, b1, w2, b2, D, H);
  T* s_tab = smem + n_mlp;
  T* s_ev = s_tab + TDT_TAB_SIZE;  // W (K*D) | c (K) | b (K)
  T* s_slices = s_ev + K * D + 2 * K;
  for (int i = threadIdx.x; i < TDT_TAB_SIZE; i += blockDim.x) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < K * D; i += blockDim.x) s_ev[i] = ev_w[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) {
    s_ev[K * D + i] = ev_c[i];
    s_ev[K * D + K + i] = ev_b[i];
  }
  __syncthreads();

  const int gid = blockIdx.x * blockDim.x + threadIdx.x;
  const int b = gid / L;
  if (b >= B) return;
  const tdt::Tableau<T> tb = tdt::tableau_from_shared<T>(s_tab, n_alpha, order, fsal);
  const LinearEvent<T, 1> ev{s_ev, s_ev + K * D, s_ev + K * D + K, K};
  const int n_st = n_alpha + 1;
  const tdt::WideLane<T> w(
      smem, D, H, power,
      s_slices + (size_t)(threadIdx.x / L) * tdt::wide_slice_elems(D, H, n_st, true),
      n_st, tdt::lane_group(L));
  const int lane = w.g.lane;

  T s0k[TDT_MAX_EVENTS];
#pragma unroll
  for (int k = 0; k < TDT_MAX_EVENTS; ++k) s0k[k] = k < K ? sign0[(size_t)k * B + b] : T(0);

  for (int d = lane; d < D; d += L) w.y[d] = y0[(size_t)d * B + b];
  w.g.sync();
  T t = t0;
  w.field(w.y, w.k);
  const T s0 = nsign<T>(wide_event<T>(ev, D, t, w.y, s0k));
  T dt = use_first_step ? first_step : w.hairer_dt(rtol, atol, tb.inv_order);

  int n_acc = 0, n_steps = 0;
  bool found = false;
  while (n_steps < max_steps) {
    const T t_prop = t + dt;
    w.stage_sweep(tb, dt);
    const T ratio = w.error_ratio(rtol, atol);
    const bool accept = ratio <= T(1);
    ++n_steps;
    if (accept) {
      ++n_acc;
      if (!(nsign<T>(wide_event<T>(ev, D, t_prop, w.y1, s0k)) == s0)) {
        found = true;   // y, k, y1, f1 still hold this step for the quartic
        break;
      }
      w.accept_step();
      t = t_prop;
    }
    dt = tdt::next_dt<T>(dt, ratio, safety, ifactor, dfactor, tb);
  }

  T event_t = T(NAN);
  if (found) {
    T* q = w.q;   // rows e | d | c | b | a
    for (int d = lane; d < D; d += L)
      w.quartic_row(tb, dt, d, q[d], q[D + d], q[2 * D + d], q[3 * D + d], q[4 * D + d]);
    T lo = T(0), hi = T(1);
    for (int i = 0; i < bisect_iters; ++i) {
      const T xm = T(0.5) * (lo + hi);
      for (int d = lane; d < D; d += L)
        w.yi[d] = tdt::quartic_at<T>(q[d], q[D + d], q[2 * D + d], q[3 * D + d],
                                     q[4 * D + d], xm);
      w.g.sync();
      const bool same = nsign<T>(wide_event<T>(ev, D, t + xm * dt, w.yi, s0k)) == s0;
      w.g.sync();
      lo = same ? xm : lo;
      hi = same ? hi : xm;
    }
    const T x = T(0.5) * (lo + hi);
    event_t = t + x * dt;
    for (int d = lane; d < D; d += L)
      w.y[d] = tdt::quartic_at<T>(q[d], q[D + d], q[2 * D + d], q[3 * D + d],
                                  q[4 * D + d], x);
  }
  for (int d = lane; d < D; d += L) y_event_out[(size_t)d * B + b] = w.y[d];
  if (lane != 0) return;
  event_t_out[b] = event_t;
  found_out[b] = found ? 1 : 0;
  n_acc_out[b] = n_acc;
  n_steps_out[b] = n_steps;
}

template <typename T>
int launch(int B, int D, int H, int power, const void* y0, double t0, double rtol,
           double atol, double safety, double ifactor, double dfactor,
           double first_step, int use_first_step, int max_steps, const void* tab,
           int n_alpha, int order, int fsal, const void* w1, const void* b1,
           const void* w2, const void* b2, int K, const void* ev_w,
           const void* ev_c, const void* ev_b, const void* sign0,
           int bisect_iters, int L, int threads, void* event_t, void* y_event,
           void* found, void* n_acc, void* n_steps, void* stream) {
  const int blocks = (int)(((long long)B * L + threads - 1) / threads);
  size_t smem = (size_t)(2 * D * H + H + D + TDT_TAB_SIZE + K * D + 2 * K) * sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D > TDT_REG_MAX_D || n_alpha > TDT_MAX_ALPHA) {
    smem += (size_t)(threads / L) * tdt::wide_slice_elems(D, H, n_alpha + 1, true) *
            sizeof(T);
    const int code = tdt::allow_shared(events_wide_kernel<T>, smem);
    if (code) return code;
    events_wide_kernel<T><<<blocks, threads, smem, st>>>(
        static_cast<const T*>(y0), B, D, (T)t0, (T)rtol, (T)atol, (T)safety,
        (T)ifactor, (T)dfactor, (T)first_step, use_first_step, max_steps,
        static_cast<const T*>(tab), n_alpha, order, fsal, H, power,
        static_cast<const T*>(w1), static_cast<const T*>(b1),
        static_cast<const T*>(w2), static_cast<const T*>(b2), K,
        static_cast<const T*>(ev_w), static_cast<const T*>(ev_c),
        static_cast<const T*>(ev_b), static_cast<const T*>(sign0), bisect_iters, L,
        static_cast<T*>(event_t), static_cast<T*>(y_event), static_cast<int*>(found),
        static_cast<int*>(n_acc), static_cast<int*>(n_steps));
    return (int)cudaGetLastError();
  }
#define TDT_LAUNCH_EVENTS(DD)                                                  \
  {                                                                            \
    auto kernel = L == 1 ? events_kernel<T, DD, false> : events_kernel<T, DD, true>; \
    const int code = tdt::allow_shared(kernel, smem);                          \
    if (code) return code;                                                     \
    kernel<<<blocks, threads, smem, st>>>(                                     \
        static_cast<const T*>(y0), B, (T)t0, (T)rtol, (T)atol, (T)safety,      \
        (T)ifactor, (T)dfactor, (T)first_step, use_first_step, max_steps,      \
        static_cast<const T*>(tab), n_alpha, order, fsal, H, power,            \
        static_cast<const T*>(w1), static_cast<const T*>(b1),                  \
        static_cast<const T*>(w2), static_cast<const T*>(b2), K,               \
        static_cast<const T*>(ev_w), static_cast<const T*>(ev_c),              \
        static_cast<const T*>(ev_b), static_cast<const T*>(sign0),             \
        bisect_iters, L, static_cast<T*>(event_t), static_cast<T*>(y_event),   \
        static_cast<int*>(found), static_cast<int*>(n_acc),                    \
        static_cast<int*>(n_steps));                                           \
  }
  TDT_DISPATCH_D(D, TDT_LAUNCH_EVENTS)
#undef TDT_LAUNCH_EVENTS
  return (int)cudaGetLastError();
}

}  // namespace tdt_events

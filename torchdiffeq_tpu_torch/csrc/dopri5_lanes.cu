// K-dopri5: adaptive explicit Runge-Kutta with a step-size controller per
// trajectory, the whole solve in one kernel.
//
// Replaces the TPU kernel torchdiffeq_tpu/ops/pallas_kernels.py:336
// (`dopri5_integrate_batched`, pallas_call at :545; helpers `_make_lane_ops`
// :238-333 and `_tableau_consts` :182).  There each of a tile's 128 VPU
// lanes owns a trajectory and one tile-wide while_loop runs until every
// lane is done, stepping finished lanes with dt = 0.  Here each thread owns
// one lane and runs its own `while (t < t1 && steps < max_steps)` loop, so
// a lane's result never depends on which other lanes share its block.
//
// Per lane, as in the TPU kernel: time in the state dtype; the Hairer
// initial step (`hairer_dt`) unless first_step is given; the tableau's
// stage sweep with the coefficient sums formed BEFORE the dt multiply;
// tol = atol + rtol * max(|y|, |y1|); the RMS of err/tol over the true D;
// accept = ratio <= 1; the I-controller factor
// min(ifactor, max(safety / max(ratio, tiny)^(1/order), dfactor on reject
// else 1)); quartic dense output for every output time t_s with
// t < t_s <= t + dt on an accepted step; outputs at or before t0 equal y0;
// NaN in every row whose time the lane never reached.
//
// The tableau arrives as a small array (any explicit method of up to
// TDT_MAX_STAGES stages: dopri5, tsit5, bosh3, fehlberg2, adaptive_heun).
//
// What bounds it on an H100: like K-rk4, the latency of one thread's
// dependent chain (stage sweeps of 4-7 field evaluations of H tanh units
// each), not bytes: the state, the slopes and the controller live in
// registers, and device memory sees y0, the emitted rows and the counters
// only.  At B=1024 one thread per lane occupies 8 of 132 SMs; lanes of one
// warp that need different step counts also diverge.  Filling the card
// (a warp per lane group with H split across lanes, mma for the products)
// is later work.  Outputs are stored in the (S, D, B) layout, lane index
// fastest, so a warp's stores to one row coalesce.
#include "mlp_field.cuh"

#define TDT_MAX_ALPHA 6
#define TDT_MAX_STAGES (TDT_MAX_ALPHA + 1)
// packed tableau: alpha[6] | beta[6][6] | c_sol[7] | c_err[7] | c_mid[7]
#define TDT_TAB_BETA TDT_MAX_ALPHA
#define TDT_TAB_CSOL (TDT_TAB_BETA + TDT_MAX_ALPHA * TDT_MAX_ALPHA)
#define TDT_TAB_CERR (TDT_TAB_CSOL + TDT_MAX_STAGES)
#define TDT_TAB_CMID (TDT_TAB_CERR + TDT_MAX_STAGES)
#define TDT_TAB_SIZE (TDT_TAB_CMID + TDT_MAX_STAGES)

namespace {

using tdt::nmax;
using tdt::nmin;

template <typename T, int D>
__device__ __forceinline__ T rms_of_scaled(const T (&v)[D], const T (&scale)[D]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const T q = v[d] / scale[d];
    s = d == 0 ? q * q : s + q * q;
  }
  return tdt::dsqrt<T>(s / T(D));
}

template <typename T, int D>
__global__ void lanes_kernel(const T* __restrict__ y0, const T* __restrict__ ts,
                             int S, int B, T t0, T t1, T rtol, T atol,
                             T safety, T ifactor, T dfactor, T first_step,
                             int use_first_step, int max_steps,
                             const T* __restrict__ tab, int n_alpha, int order,
                             int fsal, int H, int power,
                             const T* __restrict__ w1, const T* __restrict__ b1,
                             const T* __restrict__ w2, const T* __restrict__ b2,
                             T* __restrict__ ys, int* __restrict__ n_acc_out,
                             int* __restrict__ n_steps_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int n_mlp = tdt::stage_mlp(smem, w1, b1, w2, b2, D, H);
  T* s_tab = smem + n_mlp;
  T* s_ts = s_tab + TDT_TAB_SIZE;
  for (int i = threadIdx.x; i < TDT_TAB_SIZE; i += blockDim.x) s_tab[i] = tab[i];
  for (int i = threadIdx.x; i < S; i += blockDim.x) s_ts[i] = ts[i];
  __syncthreads();

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const auto f = tdt::mlp_from_shared<T, D>(smem, H, power);
  const T* alpha = s_tab;
  const T* beta = s_tab + TDT_TAB_BETA;
  const T* c_sol = s_tab + TDT_TAB_CSOL;
  const T* c_err = s_tab + TDT_TAB_CERR;
  const T* c_mid = s_tab + TDT_TAB_CMID;
  (void)alpha;  // the field takes no time input: stage times are not formed
  const T tiny = sizeof(T) == 4 ? T(1.17549435e-38f) : T(2.2250738585072014e-308);
  const T inv_order = T(1.0 / (double)order);

  T y[D], fc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) y[d] = y0[d * B + b];
  T t = t0;

  // outputs at or before the start time are the initial state
  int s_next = 0;
  while (s_next < S && s_ts[s_next] <= t0) {
#pragma unroll
    for (int d = 0; d < D; ++d) ys[((size_t)s_next * D + d) * B + b] = y[d];
    ++s_next;
  }

  f(y, fc);
  T dt;
  if (use_first_step) {
    dt = first_step;
  } else {  // `hairer_dt` (pallas_kernels.py:305-321)
    T scale[D], yp[D], fp[D], df[D];
#pragma unroll
    for (int d = 0; d < D; ++d) scale[d] = atol + rtol * tdt::dabs(y[d]);
    const T d0 = rms_of_scaled<T, D>(y, scale);
    const T d1 = rms_of_scaled<T, D>(fc, scale);
    const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6)
                                                 : T(0.01) * d0 / nmax(d1, tiny);
#pragma unroll
    for (int d = 0; d < D; ++d) yp[d] = y[d] + h0 * fc[d];
    f(yp, fp);
#pragma unroll
    for (int d = 0; d < D; ++d) df[d] = fp[d] - fc[d];
    const T d2 = rms_of_scaled<T, D>(df, scale) / nmax(h0, tiny);
    const T d_max = nmax(d1, d2);
    const T h1 = (d1 <= T(1e-15) && d2 <= T(1e-15))
                     ? nmax(T(1e-6), h0 * T(1e-3))
                     : tdt::dpow<T>(T(0.01) / nmax(d_max, tiny), inv_order);
    dt = nmin(T(100) * h0, h1);
  }

  int n_acc = 0, n_steps = 0;
  T k[TDT_MAX_STAGES][D];
  T yi[D], y1[D], f1[D], err[D];
  while (t < t1 && n_steps < max_steps) {
    const T t_prop = t + dt;

    // --- stage sweep (`stage_sweep`, pallas_kernels.py:250-279) ---------
#pragma unroll
    for (int d = 0; d < D; ++d) k[0][d] = fc[d];
#pragma unroll
    for (int i = 0; i < TDT_MAX_ALPHA; ++i) {
      if (i < n_alpha) {
        T acc[D];
        bool have = false;
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          const T c = beta[i * TDT_MAX_ALPHA + j];
          if (c != T(0)) {
#pragma unroll
            for (int d = 0; d < D; ++d) acc[d] = have ? acc[d] + c * k[j][d] : c * k[j][d];
            have = true;
          }
        }
#pragma unroll
        for (int d = 0; d < D; ++d) yi[d] = y[d] + dt * acc[d];
        f(yi, k[i + 1]);
        if (i + 1 == n_alpha) {
#pragma unroll
          for (int d = 0; d < D; ++d) f1[d] = k[i + 1][d];
        }
      }
    }
    if (fsal) {
#pragma unroll
      for (int d = 0; d < D; ++d) y1[d] = yi[d];
    } else {
      T acc[D];
      bool have = false;
#pragma unroll
      for (int j = 0; j < TDT_MAX_STAGES; ++j) {
        const T c = c_sol[j];
        if (j <= n_alpha && c != T(0)) {
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = have ? acc[d] + c * k[j][d] : c * k[j][d];
          have = true;
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) y1[d] = y[d] + dt * acc[d];
      f(y1, f1);
    }
    {
      T acc[D];
      bool have = false;
#pragma unroll
      for (int j = 0; j < TDT_MAX_STAGES; ++j) {
        const T c = c_err[j];
        if (j <= n_alpha && c != T(0)) {
#pragma unroll
          for (int d = 0; d < D; ++d) acc[d] = have ? acc[d] + c * k[j][d] : c * k[j][d];
          have = true;
        }
      }
#pragma unroll
      for (int d = 0; d < D; ++d) err[d] = dt * acc[d];
    }

    // --- error ratio and accept ----------------------------------------
    T tol[D];
#pragma unroll
    for (int d = 0; d < D; ++d) tol[d] = atol + rtol * nmax(tdt::dabs(y[d]), tdt::dabs(y1[d]));
    const T ratio = rms_of_scaled<T, D>(err, tol);
    const bool accept = ratio <= T(1);

    // --- dense output for the output times this step covers -------------
    if (accept && s_next < S && s_ts[s_next] <= t_prop) {
      T mid[D];
      bool have = false;
#pragma unroll
      for (int j = 0; j < TDT_MAX_STAGES; ++j) {
        const T c = c_mid[j];
        if (j <= n_alpha && c != T(0)) {
#pragma unroll
          for (int d = 0; d < D; ++d) mid[d] = have ? mid[d] + c * k[j][d] : c * k[j][d];
          have = true;
        }
      }
      T ce[D], cd[D], cc[D], cb[D], ca[D];
#pragma unroll
      for (int d = 0; d < D; ++d) {  // `interp_coeffs`, pallas_kernels.py:290-294
        const T y_mid = y[d] + dt * mid[d];
        ca[d] = T(2) * dt * (f1[d] - fc[d]) - T(8) * (y1[d] + y[d]) + T(16) * y_mid;
        cb[d] = dt * (T(5) * fc[d] - T(3) * f1[d]) + T(18) * y[d] + T(14) * y1[d] -
                T(32) * y_mid;
        cc[d] = dt * (f1[d] - T(4) * fc[d]) - T(11) * y[d] - T(5) * y1[d] + T(16) * y_mid;
        cd[d] = dt * fc[d];
        ce[d] = y[d];
      }
      const T dt_safe = dt > T(0) ? dt : T(1);
      while (s_next < S && s_ts[s_next] <= t_prop) {
        const T x = (s_ts[s_next] - t) / dt_safe;
#pragma unroll
        for (int d = 0; d < D; ++d) {  // `interp_at`
          T total = ce[d] + x * cd[d];
          T xp = x * x;
          total = total + xp * cc[d];
          xp = xp * x;
          total = total + xp * cb[d];
          xp = xp * x;
          total = total + xp * ca[d];
          ys[((size_t)s_next * D + d) * B + b] = total;
        }
        ++s_next;
      }
    }

    // --- controller -----------------------------------------------------
    if (accept) {
#pragma unroll
      for (int d = 0; d < D; ++d) {
        y[d] = y1[d];
        fc[d] = f1[d];
      }
      t = t_prop;
      ++n_acc;
    }
    const T dfac = ratio < T(1) ? T(1) : dfactor;
    const T factor = nmin(ifactor, nmax(safety / tdt::dpow<T>(nmax(ratio, tiny), inv_order), dfac));
    dt = dt * factor;
    ++n_steps;
  }

  // rows whose time this lane never reached (max_steps ran out)
  for (; s_next < S; ++s_next) {
#pragma unroll
    for (int d = 0; d < D; ++d) ys[((size_t)s_next * D + d) * B + b] = T(NAN);
  }
  n_acc_out[b] = n_acc;
  n_steps_out[b] = n_steps;
}

template <typename T>
int launch(int B, int D, int H, int power, const void* y0, const void* ts,
           int S, double t0, double t1, double rtol, double atol, double safety,
           double ifactor, double dfactor, double first_step, int use_first_step,
           int max_steps, const void* tab, int n_alpha, int order, int fsal,
           const void* w1, const void* b1, const void* w2, const void* b2,
           void* ys, void* n_acc, void* n_steps, void* stream) {
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  const size_t smem = (size_t)(2 * D * H + H + D + TDT_TAB_SIZE + S) * sizeof(T);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define TDT_LAUNCH_LANES(DD)                                                    \
  lanes_kernel<T, DD><<<blocks, threads, smem, st>>>(                           \
      static_cast<const T*>(y0), static_cast<const T*>(ts), S, B, (T)t0, (T)t1, \
      (T)rtol, (T)atol, (T)safety, (T)ifactor, (T)dfactor, (T)first_step,       \
      use_first_step, max_steps, static_cast<const T*>(tab), n_alpha, order,    \
      fsal, H, power, static_cast<const T*>(w1), static_cast<const T*>(b1),     \
      static_cast<const T*>(w2), static_cast<const T*>(b2), static_cast<T*>(ys), \
      static_cast<int*>(n_acc), static_cast<int*>(n_steps))
  TDT_DISPATCH_D(D, TDT_LAUNCH_LANES)
#undef TDT_LAUNCH_LANES
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = float64.  y0 is (D, B), ts (S,) increasing, ys
// (S, D, B); n_acc and n_steps are (B,) int32.  Scalars are values of the
// state dtype passed exactly as doubles; `tab` is the packed tableau in the
// state dtype.  Returns cudaGetLastError().
extern "C" int tdt_dopri5_lanes(int dtype, int B, int D, int H, int power,
                                const void* y0, const void* ts, int S, double t0,
                                double t1, double rtol, double atol,
                                double safety, double ifactor, double dfactor,
                                double first_step, int use_first_step,
                                int max_steps, const void* tab, int n_alpha,
                                int order, int fsal, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                void* ys, void* n_acc, void* n_steps,
                                void* stream) {
  if (n_alpha < 1 || n_alpha > TDT_MAX_ALPHA) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(B, D, H, power, y0, ts, S, t0, t1, rtol, atol, safety,
                         ifactor, dfactor, first_step, use_first_step, max_steps,
                         tab, n_alpha, order, fsal, w1, b1, w2, b2, ys, n_acc,
                         n_steps, stream);
  if (dtype == 1)
    return launch<double>(B, D, H, power, y0, ts, S, t0, t1, rtol, atol, safety,
                          ifactor, dfactor, first_step, use_first_step, max_steps,
                          tab, n_alpha, order, fsal, w1, b1, w2, b2, ys, n_acc,
                          n_steps, stream);
  return (int)cudaErrorInvalidValue;
}

// Per-lane adaptive Runge-Kutta numerics shared by the two per-lane kernels
// (dopri5_lanes.cu and dopri5_events.cu), as the TPU kernels share
// `_make_lane_ops` (torchdiffeq_tpu/ops/pallas_kernels.py:238-333): the
// lane RMS norm, the tableau's stage sweep, the error ratio, the Hairer
// initial step, the I-controller, and the quartic dense-output fit and
// evaluation.  A group of L lanes owns a trajectory (the TPU kernel's lane);
// everything here works on values in a lane's registers, in the state
// dtype, in the TPU kernel's operation order.  Only the field `f` (a
// GroupMlpField) divides work across the group; every lane runs the rest
// redundantly on the same bits, so its branches, and those of the loops
// around it, are the same across the group.  What bounds the kernels, and
// why the group, is in dopri5_lanes.cu.
#pragma once

#include "mlp_field.cuh"

#define TDT_MAX_ALPHA 6
#define TDT_MAX_STAGES (TDT_MAX_ALPHA + 1)
// packed tableau: alpha[6] | beta[6][6] | c_sol[7] | c_err[7] | c_mid[7]
#define TDT_TAB_BETA TDT_MAX_ALPHA
#define TDT_TAB_CSOL (TDT_TAB_BETA + TDT_MAX_ALPHA * TDT_MAX_ALPHA)
#define TDT_TAB_CERR (TDT_TAB_CSOL + TDT_MAX_STAGES)
#define TDT_TAB_CMID (TDT_TAB_CERR + TDT_MAX_STAGES)
#define TDT_TAB_SIZE (TDT_TAB_CMID + TDT_MAX_STAGES)

namespace tdt {

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return 1.17549435e-38f; }
template <> __device__ __forceinline__ double tiny<double>() { return 2.2250738585072014e-308; }

// The packed tableau, staged in shared memory.
template <typename T>
struct Tableau {
  const T* beta;
  const T* c_sol;
  const T* c_err;
  const T* c_mid;
  int n_alpha;
  int fsal;
  T inv_order;  // 1 / order, in the state dtype
};

template <typename T>
__device__ __forceinline__ Tableau<T> tableau_from_shared(const T* s, int n_alpha,
                                                          int order, int fsal) {
  return Tableau<T>{s + TDT_TAB_BETA, s + TDT_TAB_CSOL, s + TDT_TAB_CERR,
                    s + TDT_TAB_CMID, n_alpha, fsal, T(1.0 / (double)order)};
}

// sqrt(sum_d (v/scale)^2 / D): `lane_rms` over the true state size.
template <typename T, int D>
__device__ __forceinline__ T rms_of_scaled(const T (&v)[D], const T (&scale)[D]) {
  T s = T(0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const T q = v[d] / scale[d];
    s = d == 0 ? q * q : s + q * q;
  }
  return dsqrt<T>(s / T(D));
}

// acc = sum_j c[j] * k[j] over the nonzero c[j], j < n, in order (the sums
// are formed before any dt multiply).  Every coefficient row used here has
// at least one nonzero entry.
template <typename T, int D>
__device__ __forceinline__ void coeff_sum(const T* c, const T (&k)[TDT_MAX_STAGES][D],
                                          int n, T (&acc)[D]) {
  bool have = false;
#pragma unroll
  for (int j = 0; j < TDT_MAX_STAGES; ++j) {
    const T cj = j < n ? c[j] : T(0);
    if (cj != T(0)) {
#pragma unroll
      for (int d = 0; d < D; ++d) acc[d] = have ? acc[d] + cj * k[j][d] : cj * k[j][d];
      have = true;
    }
  }
}

// `hairer_dt` (pallas_kernels.py:305-321): the initial step from y, f(y).
template <typename T, int D, typename F>
__device__ __forceinline__ T hairer_dt(const F& f, const T (&y)[D], const T (&fc)[D],
                                       T rtol, T atol, T inv_order) {
  T scale[D], yp[D], fp[D], df[D];
#pragma unroll
  for (int d = 0; d < D; ++d) scale[d] = atol + rtol * dabs(y[d]);
  const T d0 = rms_of_scaled<T, D>(y, scale);
  const T d1 = rms_of_scaled<T, D>(fc, scale);
  const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6) : T(0.01) * d0 / nmax(d1, tiny<T>());
#pragma unroll
  for (int d = 0; d < D; ++d) yp[d] = y[d] + h0 * fc[d];
  f(yp, fp);
#pragma unroll
  for (int d = 0; d < D; ++d) df[d] = fp[d] - fc[d];
  const T d2 = rms_of_scaled<T, D>(df, scale) / nmax(h0, tiny<T>());
  const T d_max = nmax(d1, d2);
  const T h1 = (d1 <= T(1e-15) && d2 <= T(1e-15))
                   ? nmax(T(1e-6), h0 * T(1e-3))
                   : dpow<T>(T(0.01) / nmax(d_max, tiny<T>()), inv_order);
  return nmin(T(100) * h0, h1);
}

// `stage_sweep` (pallas_kernels.py:250-279): the stages k (k[0] = fc), the
// proposed y1 and f1 = f(y1), and the embedded error estimate.
template <typename T, int D, typename F>
__device__ __forceinline__ void stage_sweep(const F& f, const Tableau<T>& tab,
                                            const T (&y)[D], const T (&fc)[D], T dt,
                                            T (&k)[TDT_MAX_STAGES][D], T (&y1)[D],
                                            T (&f1)[D], T (&err)[D]) {
  T yi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) k[0][d] = fc[d];
#pragma unroll
  for (int i = 0; i < TDT_MAX_ALPHA; ++i) {
    if (i < tab.n_alpha) {
      T acc[D];
      coeff_sum<T, D>(tab.beta + i * TDT_MAX_ALPHA, k, i + 1, acc);
#pragma unroll
      for (int d = 0; d < D; ++d) yi[d] = y[d] + dt * acc[d];
      f(yi, k[i + 1]);
      if (i + 1 == tab.n_alpha) {
#pragma unroll
        for (int d = 0; d < D; ++d) f1[d] = k[i + 1][d];
      }
    }
  }
  if (tab.fsal) {
#pragma unroll
    for (int d = 0; d < D; ++d) y1[d] = yi[d];
  } else {
    T acc[D];
    coeff_sum<T, D>(tab.c_sol, k, tab.n_alpha + 1, acc);
#pragma unroll
    for (int d = 0; d < D; ++d) y1[d] = y[d] + dt * acc[d];
    f(y1, f1);
  }
  T acc[D];
  coeff_sum<T, D>(tab.c_err, k, tab.n_alpha + 1, acc);
#pragma unroll
  for (int d = 0; d < D; ++d) err[d] = dt * acc[d];
}

// RMS of err / (atol + rtol * max(|y|, |y1|)); a step is accepted at <= 1.
template <typename T, int D>
__device__ __forceinline__ T error_ratio(const T (&y)[D], const T (&y1)[D],
                                         const T (&err)[D], T rtol, T atol) {
  T tol[D];
#pragma unroll
  for (int d = 0; d < D; ++d) tol[d] = atol + rtol * nmax(dabs(y[d]), dabs(y1[d]));
  return rms_of_scaled<T, D>(err, tol);
}

// The I-controller: dt * min(ifactor, max(safety / max(ratio, tiny)^(1/order),
// dfactor on a rejected step else 1)), NaN-propagating like the TPU kernel.
template <typename T>
__device__ __forceinline__ T next_dt(T dt, T ratio, T safety, T ifactor, T dfactor,
                                     T inv_order) {
  const T dfac = ratio < T(1) ? T(1) : dfactor;
  return dt * nmin(ifactor, nmax(safety / dpow<T>(nmax(ratio, tiny<T>()), inv_order), dfac));
}

// Quartic dense output on [t, t + dt], ascending powers of x in [0, 1]
// (`y_mid_of` and `interp_coeffs`, pallas_kernels.py:281-294).
template <typename T, int D>
struct Quartic {
  T e[D], d[D], c[D], b[D], a[D];
};

template <typename T, int D>
__device__ __forceinline__ void fit_quartic(const Tableau<T>& tab,
                                            const T (&k)[TDT_MAX_STAGES][D],
                                            const T (&y)[D], const T (&y1)[D],
                                            const T (&fc)[D], const T (&f1)[D], T dt,
                                            Quartic<T, D>& q) {
  T mid[D];
  coeff_sum<T, D>(tab.c_mid, k, tab.n_alpha + 1, mid);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const T y_mid = y[d] + dt * mid[d];
    q.a[d] = T(2) * dt * (f1[d] - fc[d]) - T(8) * (y1[d] + y[d]) + T(16) * y_mid;
    q.b[d] = dt * (T(5) * fc[d] - T(3) * f1[d]) + T(18) * y[d] + T(14) * y1[d] -
             T(32) * y_mid;
    q.c[d] = dt * (f1[d] - T(4) * fc[d]) - T(11) * y[d] - T(5) * y1[d] + T(16) * y_mid;
    q.d[d] = dt * fc[d];
    q.e[d] = y[d];
  }
}

// `interp_at`: e + x*d + x^2*c + x^3*b + x^4*a, the powers formed by repeated
// multiplication.
template <typename T, int D>
__device__ __forceinline__ void eval_quartic(const Quartic<T, D>& q, T x, T (&out)[D]) {
#pragma unroll
  for (int d = 0; d < D; ++d) {
    T total = q.e[d] + x * q.d[d];
    T xp = x * x;
    total = total + xp * q.c[d];
    xp = xp * x;
    total = total + xp * q.b[d];
    xp = xp * x;
    total = total + xp * q.a[d];
    out[d] = total;
  }
}

}  // namespace tdt

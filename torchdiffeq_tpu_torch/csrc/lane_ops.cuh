// Per-lane adaptive Runge-Kutta numerics shared by the two per-lane kernels
// (dopri5_lanes.cuh and dopri5_events.cuh), as the TPU kernels share
// `_make_lane_ops` (torchdiffeq_tpu/ops/pallas_kernels.py:238-333): the
// lane RMS norm, the tableau's stage sweep, the error ratio, the Hairer
// initial step, the I-controller, and the quartic dense-output fit and
// evaluation.  A group of L lanes owns a trajectory (the TPU kernel's lane);
// everything here works on values in a lane's registers, in the state
// dtype, in the TPU kernel's operation order.  Only the field `f` (a
// GroupMlpField) divides work across the group; every lane runs the rest
// redundantly on the same bits, so its branches, and those of the loops
// around it, are the same across the group.  What bounds the kernels, and
// why the group, is in dopri5_lanes.cuh.
//
// The field is any functor `f(t, y, out)` over a state of D values in
// registers: an MlpField (which takes no time), or a field the tracer
// (ops/traced.py) emitted from a Python function.  The stage times
// t + alpha_i * dt are formed as the TPU kernel forms them; a field that
// never reads its time leaves them to the compiler to drop.
//
// The tableau is a type parameter `Tab` of every function here that reads
// a coefficient (`stage_sweep`, `fit_quartic`, `hairer_dt`, `next_dt`, and
// the sums under them), of one of two kinds:
// - `Tableau<T>`, the packed tableau staged in shared memory and read at
//   run time, each coefficient tested against zero as it is read: the
//   hand-written instances, which take any method at run time;
// - a tableau compiled into its instance (`kCompiled`): a traced instance
//   is a translation unit of its own whose method is known when
//   ops/traced.py emits it, as the TPU kernel's tableau was known when
//   Pallas traced it (`_tableau_consts`, pallas_kernels.py:182-190).  Its
//   coefficients are constants of the source, each the state dtype's value
//   of the packed one, and its zero terms are dropped at compile time (as
//   the TPU kernel's `if beta[i, j] == 0.0: continue`, :250-279), so a
//   step's stage sums are straight-line arithmetic with no load and no
//   branch between them.
// Either way each sum runs over its nonzero terms in j order and is formed
// before the dt multiply, so the two kinds compute the same bits.
#pragma once

#include "mlp_field.cuh"

// packed tableau of up to 14 stages (dopri8's 13 alphas): alpha[13] |
// beta[13][13] | c_sol[14] | c_err[14] | c_mid[14], zero-padded
// (ops/kernels.py `packed_tableau`)
#define TDT_PACK_ALPHA 13
#define TDT_PACK_STAGES (TDT_PACK_ALPHA + 1)
#define TDT_TAB_BETA TDT_PACK_ALPHA
#define TDT_TAB_CSOL (TDT_TAB_BETA + TDT_PACK_ALPHA * TDT_PACK_ALPHA)
#define TDT_TAB_CERR (TDT_TAB_CSOL + TDT_PACK_STAGES)
#define TDT_TAB_CMID (TDT_TAB_CERR + TDT_PACK_STAGES)
#define TDT_TAB_SIZE (TDT_TAB_CMID + TDT_PACK_STAGES)
// The register instances hold a trajectory's state and stage slopes in
// registers: D <= TDT_REG_MAX_D and at most TDT_REG_STAGES stages.  Every
// other problem (dopri8, or D > 8) runs the shared-memory instance below
// (`WideLane`), whose registers do not grow with D or the stage count.
// A traced instance (a translation unit of its own) may define
// TDT_MAX_ALPHA first, to hold a longer tableau (dopri8) in registers.
#define TDT_REG_MAX_D 8
#ifndef TDT_MAX_ALPHA
#define TDT_MAX_ALPHA 6
#endif
#define TDT_MAX_STAGES (TDT_MAX_ALPHA + 1)

namespace tdt {

template <typename T> __device__ __forceinline__ T tiny();
template <> __device__ __forceinline__ float tiny<float>() { return 1.17549435e-38f; }
template <> __device__ __forceinline__ double tiny<double>() { return 2.2250738585072014e-308; }
template <> __device__ __forceinline__ bf16 tiny<bf16>() { return bf16(1.17549435e-38f); }
template <> __device__ __forceinline__ f16 tiny<f16>() { return f16(6.103515625e-05f); }

// The packed tableau, staged in shared memory (the run-time kind).
template <typename T>
struct Tableau {
  static constexpr bool kCompiled = false;
  const T* alpha;
  const T* beta;
  const T* c_sol;
  const T* c_err;
  const T* c_mid;
  int n_alpha;
  int fsal;
  T inv_order;  // 1 / order, in the state dtype

  // the packed layout from entry `i` (alpha starts it)
  __device__ __forceinline__ const T* row(int i) const { return alpha + i; }
};

template <typename T>
__device__ __forceinline__ Tableau<T> tableau_from_shared(const T* s, int n_alpha,
                                                          int order, int fsal) {
  return Tableau<T>{s, s + TDT_TAB_BETA, s + TDT_TAB_CSOL, s + TDT_TAB_CERR,
                    s + TDT_TAB_CMID, n_alpha, fsal, T(1.0 / (double)order)};
}

// sqrt(sum_d (v/scale)^2 / D): `lane_rms` over the true state size (the
// squares in the state dtype, their sum accumulated in acc_t<T>).
template <typename T, int D>
__device__ __forceinline__ T rms_of_scaled(const T (&v)[D], const T (&scale)[D]) {
  acc_t<T> s = acc_t<T>(0);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const T q = v[d] / scale[d];
    s = d == 0 ? acc(q * q) : s + acc(q * q);
  }
  return dsqrt<T>(from_acc<T>(s) / T(D));
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

// Compile-time iteration: f(Int<I>()) for I = B, ..., E - 1, in order.
template <int I>
struct Int {
  static constexpr int value = I;
};
template <int B, int E, typename F>
__device__ __forceinline__ void static_for(F&& f) {
  if constexpr (B < E) {
    f(Int<B>());
    static_for<B + 1, E>(f);
  }
}

// The first nonzero entry of the n entries from `off` of a compiled
// tableau's packed layout (n if none).
template <typename Tab>
__host__ __device__ constexpr int first_nonzero(int off, int n) {
  int j = 0;
  while (j < n && Tab::coef(off + j) == 0.0) ++j;
  return j;
}

// coeff_sum of a compiled tableau's row at `Off` (N entries): its zero
// terms dropped at compile time, each nonzero one a constant.
template <typename Tab, int Off, int N, typename T, int D>
__device__ __forceinline__ void compiled_sum(const T (&k)[TDT_MAX_STAGES][D], T (&acc)[D]) {
  constexpr int first = first_nonzero<Tab>(Off, N);
  static_for<0, N>([&](auto J) {
    constexpr int j = decltype(J)::value;
    constexpr double c = Tab::coef(Off + j);
    if constexpr (c != 0.0) {
      const T cj = T(c);
#pragma unroll
      for (int d = 0; d < D; ++d) {
        if constexpr (j == first)
          acc[d] = cj * k[j][d];
        else
          acc[d] = acc[d] + cj * k[j][d];
      }
    }
  });
}

// Whether the method is FSAL, of either kind of tableau.
template <typename Tab>
__device__ __forceinline__ bool fsal_of(const Tab& tab) {
  if constexpr (Tab::kCompiled)
    return Tab::fsal;
  else
    return tab.fsal;
}

// x^(1/order), the power of the initial step and of the controller, as
// PyTorch's power by a scalar computes it (the plain versions'
// `x ** inv_order`): the square root for order 2 (fehlberg2,
// adaptive_heun), pow otherwise.  A run-time tableau (the hand-written
// instances) makes the choice at run time, a compiled one at compile time.
template <typename T>
__device__ __forceinline__ T pow_inv_order_rt(T x, T inv_order) {
  return inv_order == T(0.5) ? dsqrt<T>(x) : dpow<T>(x, inv_order);
}

template <typename T, typename Tab>
__device__ __forceinline__ T pow_inv_order(const Tab& tab, T x) {
  if constexpr (!Tab::kCompiled)
    return pow_inv_order_rt<T>(x, tab.inv_order);
  else if constexpr (Tab::inv_order == 0.5)
    return dsqrt<T>(x);
  else
    return dpow<T>(x, T(Tab::inv_order));
}

// sum_j c[j] * k[j] over the n_alpha + 1 entries of the packed tableau's
// row at `Off` (c_sol, c_err or c_mid), for either kind of tableau.
template <int Off, typename T, int D, typename Tab>
__device__ __forceinline__ void row_sum(const Tab& tab, const T (&k)[TDT_MAX_STAGES][D],
                                        T (&acc)[D]) {
  if constexpr (Tab::kCompiled)
    compiled_sum<Tab, Off, Tab::n_alpha + 1>(k, acc);
  else
    coeff_sum<T, D>(tab.row(Off), k, tab.n_alpha + 1, acc);
}

// `hairer_dt` (pallas_kernels.py:305-321): the initial step from y, f(t, y).
template <typename T, int D, typename F, typename Tab>
__device__ __forceinline__ T hairer_dt(const F& f, const Tab& tab, T t, const T (&y)[D],
                                       const T (&fc)[D], T rtol, T atol) {
  T scale[D], yp[D], fp[D], df[D];
#pragma unroll
  for (int d = 0; d < D; ++d) scale[d] = atol + rtol * dabs(y[d]);
  const T d0 = rms_of_scaled<T, D>(y, scale);
  const T d1 = rms_of_scaled<T, D>(fc, scale);
  const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6) : T(0.01) * d0 / nmax(d1, tiny<T>());
#pragma unroll
  for (int d = 0; d < D; ++d) yp[d] = y[d] + h0 * fc[d];
  f(t + h0, yp, fp);
#pragma unroll
  for (int d = 0; d < D; ++d) df[d] = fp[d] - fc[d];
  const T d2 = rms_of_scaled<T, D>(df, scale) / nmax(h0, tiny<T>());
  const T d_max = nmax(d1, d2);
  const T h1 = (d1 <= T(1e-15) && d2 <= T(1e-15))
                   ? nmax(T(1e-6), h0 * T(1e-3))
                   : pow_inv_order<T>(tab, T(0.01) / nmax(d_max, tiny<T>()));
  return nmin(T(100) * h0, h1);
}

// `stage_sweep` (pallas_kernels.py:250-279): the stages k (k[0] = fc), the
// proposed y1 and f1 = f(t + dt, y1), and the embedded error estimate.
template <typename T, int D, typename F, typename Tab>
__device__ __forceinline__ void stage_sweep(const F& f, const Tab& tab, T t,
                                            const T (&y)[D], const T (&fc)[D], T dt,
                                            T (&k)[TDT_MAX_STAGES][D], T (&y1)[D],
                                            T (&f1)[D], T (&err)[D]) {
  T yi[D];
#pragma unroll
  for (int d = 0; d < D; ++d) k[0][d] = fc[d];
  if constexpr (Tab::kCompiled) {
    // the stages unrolled at compile time: each row's sum over its nonzero
    // betas, the stage time from its constant alpha
    static_for<0, Tab::n_alpha>([&](auto I) {
      constexpr int i = decltype(I)::value;
      constexpr double alpha = Tab::coef(i);
      T acc[D];
      compiled_sum<Tab, TDT_TAB_BETA + i * TDT_PACK_ALPHA, i + 1>(k, acc);
#pragma unroll
      for (int d = 0; d < D; ++d) yi[d] = y[d] + dt * acc[d];
      f(t + T(alpha) * dt, yi, k[i + 1]);
    });
#pragma unroll
    for (int d = 0; d < D; ++d) f1[d] = k[Tab::n_alpha][d];
  } else {
#pragma unroll
    for (int i = 0; i < TDT_MAX_ALPHA; ++i) {
      if (i < tab.n_alpha) {
        T acc[D];
        coeff_sum<T, D>(tab.beta + i * TDT_PACK_ALPHA, k, i + 1, acc);
#pragma unroll
        for (int d = 0; d < D; ++d) yi[d] = y[d] + dt * acc[d];
        f(t + tab.alpha[i] * dt, yi, k[i + 1]);
        if (i + 1 == tab.n_alpha) {
#pragma unroll
          for (int d = 0; d < D; ++d) f1[d] = k[i + 1][d];
        }
      }
    }
  }
  if (fsal_of(tab)) {
#pragma unroll
    for (int d = 0; d < D; ++d) y1[d] = yi[d];
  } else {
    T acc[D];
    row_sum<TDT_TAB_CSOL, T, D>(tab, k, acc);
#pragma unroll
    for (int d = 0; d < D; ++d) y1[d] = y[d] + dt * acc[d];
    f(t + dt, y1, f1);
  }
  T acc[D];
  row_sum<TDT_TAB_CERR, T, D>(tab, k, acc);
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
template <typename T, typename Tab>
__device__ __forceinline__ T next_dt(T dt, T ratio, T safety, T ifactor, T dfactor,
                                     const Tab& tab) {
  const T dfac = ratio < T(1) ? T(1) : dfactor;
  return dt * nmin(ifactor,
                   nmax(safety / pow_inv_order<T>(tab, nmax(ratio, tiny<T>())), dfac));
}

// Quartic dense output on [t, t + dt], ascending powers of x in [0, 1]
// (`y_mid_of` and `interp_coeffs`, pallas_kernels.py:281-294).
template <typename T, int D>
struct Quartic {
  T e[D], d[D], c[D], b[D], a[D];
};

template <typename T, int D, typename Tab>
__device__ __forceinline__ void fit_quartic(const Tab& tab,
                                            const T (&k)[TDT_MAX_STAGES][D],
                                            const T (&y)[D], const T (&y1)[D],
                                            const T (&fc)[D], const T (&f1)[D], T dt,
                                            Quartic<T, D>& q) {
  T mid[D];
  row_sum<TDT_TAB_CMID, T, D>(tab, k, mid);
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


// ---------------------------------------------------------------------------
// The shared-memory instance: any D and up to TDT_PACK_STAGES stages.
//
// A trajectory's state, stage slopes, field input and hidden layer live in
// shared memory, in a slice of `wide_slice_elems` elements that its group
// of L lanes owns.  Element-wise work is split across the group by state
// row (lane j takes rows j, j + L, ...), so each row is written by one lane;
// reductions over the rows (the RMS norms, an event's dot product) are run
// by every lane on its own, in the register instances' order, so every
// lane holds the same bits and takes the same branches, as there.  The
// group meets at __syncwarp(mask) wherever a lane reads a row another lane
// wrote, or writes one another lane may still read.
// ---------------------------------------------------------------------------

// The group of L lanes (a power of two up to 32, aligned in the warp) that
// owns a trajectory.
struct LaneGroup {
  int lane;        // this lane's index in the group
  int L;
  unsigned mask;   // group_mask(L)
  __device__ __forceinline__ void sync() const { __syncwarp(mask); }
};

__device__ __forceinline__ LaneGroup lane_group(int L) {
  return LaneGroup{(int)(threadIdx.x & (L - 1)), L, group_mask(L)};
}

// Elements of one trajectory's slice: the slopes k[n_stages][D] (k[0] is
// the slope at y), y, yi, y1, f1, err, the field input x (D each), the
// hidden layer (H), and with `quartic` the five coefficient rows (5 D).
__host__ __device__ __forceinline__ int wide_slice_elems(int D, int H, int n_stages,
                                                         bool quartic) {
  return (n_stages + 6 + (quartic ? 5 : 0)) * D + H;
}

template <typename T>
struct WideLane {
  // the field's weights (shared memory) and the trajectory's slice
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  int D, H, power;
  T* k;
  T* y;
  T* yi;
  T* y1;
  T* f1;
  T* err;
  T* x;
  T* hid;
  T* q;   // e | d | c | b | a rows, or null
  LaneGroup g;

  __device__ __forceinline__ WideLane(const T* s_mlp, int D_, int H_, int power_,
                                      T* slice, int n_stages, LaneGroup g_)
      : w1(s_mlp), b1(s_mlp + D_ * H_), w2(s_mlp + D_ * H_ + H_),
        b2(s_mlp + 2 * D_ * H_ + H_), D(D_), H(H_), power(power_), g(g_) {
    k = slice;
    y = k + n_stages * D;
    yi = y + D;
    y1 = yi + D;
    f1 = y1 + D;
    err = f1 + D;
    x = err + D;
    hid = x + D;
    q = hid + H;
  }

  // out = f(in) (rows of shared memory, `out` not `in`): the input power by
  // row, each hidden unit by one lane (MlpField's pre-activation order),
  // then each output row by one lane, summing the hidden units in order
  // from 0 (MlpField's order, whatever L).
  __device__ void field(const T* in, T* out) const {
    using A = acc_t<T>;
    for (int j = g.lane; j < D; j += g.L) x[j] = field_power<T>(in[j], power);
    g.sync();
    for (int h = g.lane; h < H; h += g.L) {
      A s = acc(x[0]) * acc(w1[h]);
      for (int j = 1; j < D; ++j) s = s + acc(x[j]) * acc(w1[j * H + h]);
      hid[h] = dtanh<T>(from_acc<T>(s) + b1[h]);
    }
    g.sync();
    for (int d = g.lane; d < D; d += g.L) {
      A o = A(0);
      for (int h = 0; h < H; ++h) o = o + acc(hid[h]) * acc(w2[h * D + d]);
      out[d] = from_acc<T>(o) + b2[d];
    }
    g.sync();
  }

  // coeff_sum for row d: sum_j c[j] * k[j][d] over the nonzero c[j], j < n
  __device__ __forceinline__ T coeff_sum_row(const T* c, int n, int d) const {
    T acc = T(0);
    bool have = false;
    for (int j = 0; j < n; ++j) {
      const T cj = c[j];
      if (cj != T(0)) {
        acc = have ? acc + cj * k[j * D + d] : cj * k[j * D + d];
        have = true;
      }
    }
    return acc;
  }

  // rms_of_scaled over all rows of v / (atol + rtol * |y|) (scale_y1 false)
  // or of v / (atol + rtol * max(|y|, |y1|)); v - sub when sub is given.
  // Every lane computes it whole.
  __device__ __forceinline__ T rms(const T* v, const T* sub, T rtol, T atol,
                                   bool scale_y1) const {
    acc_t<T> s = acc_t<T>(0);
    for (int d = 0; d < D; ++d) {
      const T scale = scale_y1 ? atol + rtol * nmax(dabs(y[d]), dabs(y1[d]))
                               : atol + rtol * dabs(y[d]);
      const T q_ = (sub ? v[d] - sub[d] : v[d]) / scale;
      s = d == 0 ? acc(q_ * q_) : s + acc(q_ * q_);
    }
    return dsqrt<T>(from_acc<T>(s) / T(D));
  }

  // `hairer_dt` from y and k[0] = f(y); uses yi and y1 as scratch
  __device__ T hairer_dt(T rtol, T atol, T inv_order) const {
    const T d0 = rms(y, nullptr, rtol, atol, false);
    const T d1 = rms(k, nullptr, rtol, atol, false);
    const T h0 = (d0 < T(1e-5) || d1 < T(1e-5)) ? T(1e-6) : T(0.01) * d0 / nmax(d1, tiny<T>());
    for (int d = g.lane; d < D; d += g.L) yi[d] = y[d] + h0 * k[d];
    g.sync();
    field(yi, y1);
    const T d2 = rms(y1, k, rtol, atol, false) / nmax(h0, tiny<T>());
    const T d_max = nmax(d1, d2);
    const T h1 = (d1 <= T(1e-15) && d2 <= T(1e-15))
                     ? nmax(T(1e-6), h0 * T(1e-3))
                     : pow_inv_order_rt<T>(T(0.01) / nmax(d_max, tiny<T>()), inv_order);
    g.sync();
    return nmin(T(100) * h0, h1);
  }

  // `stage_sweep`: k[1..], y1, f1 and err from y, k[0] and dt
  __device__ void stage_sweep(const Tableau<T>& tab, T dt) const {
    const int n_st = tab.n_alpha + 1;
    for (int i = 0; i < tab.n_alpha; ++i) {
      for (int d = g.lane; d < D; d += g.L)
        yi[d] = y[d] + dt * coeff_sum_row(tab.beta + i * TDT_PACK_ALPHA, i + 1, d);
      g.sync();
      field(yi, k + (i + 1) * D);
    }
    if (tab.fsal) {
      for (int d = g.lane; d < D; d += g.L) {
        y1[d] = yi[d];
        f1[d] = k[tab.n_alpha * D + d];
      }
    } else {
      for (int d = g.lane; d < D; d += g.L)
        y1[d] = y[d] + dt * coeff_sum_row(tab.c_sol, n_st, d);
      g.sync();
      field(y1, f1);
    }
    for (int d = g.lane; d < D; d += g.L) err[d] = dt * coeff_sum_row(tab.c_err, n_st, d);
    g.sync();
  }

  // the error ratio of the step just swept, whole in every lane
  __device__ __forceinline__ T error_ratio(T rtol, T atol) const {
    const T r = rms(err, nullptr, rtol, atol, true);
    g.sync();
    return r;
  }

  // the step's quartic coefficients of row d (fit_quartic)
  __device__ __forceinline__ void quartic_row(const Tableau<T>& tab, T dt, int d,
                                              T& e, T& dd, T& c, T& b, T& a) const {
    const T y_mid = y[d] + dt * coeff_sum_row(tab.c_mid, tab.n_alpha + 1, d);
    const T fc = k[d];
    a = T(2) * dt * (f1[d] - fc) - T(8) * (y1[d] + y[d]) + T(16) * y_mid;
    b = dt * (T(5) * fc - T(3) * f1[d]) + T(18) * y[d] + T(14) * y1[d] - T(32) * y_mid;
    c = dt * (f1[d] - T(4) * fc) - T(11) * y[d] - T(5) * y1[d] + T(16) * y_mid;
    dd = dt * fc;
    e = y[d];
  }

  // y, k[0] = y1, f1 (an accepted step)
  __device__ __forceinline__ void accept_step() const {
    for (int d = g.lane; d < D; d += g.L) {
      y[d] = y1[d];
      k[d] = f1[d];
    }
    g.sync();
  }
};

// eval_quartic of one row
template <typename T>
__device__ __forceinline__ T quartic_at(T e, T d, T c, T b, T a, T x) {
  T total = e + x * d;
  T xp = x * x;
  total = total + xp * c;
  xp = xp * x;
  total = total + xp * b;
  xp = xp * x;
  return total + xp * a;
}

// Set a kernel's dynamic shared memory limit when a launch needs more than
// the default 48 KB (up to the card's opt-in limit, which the host checks).
template <typename K>
__host__ __forceinline__ int allow_shared(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   (int)smem);
}

}  // namespace tdt

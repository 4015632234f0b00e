// Device helpers shared by the port's CUDA kernels (rk4.cu, dopri5_lanes.cu
// and dopri5_events.cu): the MLP vector field evaluated on one trajectory,
// by one thread (MlpField) or by a group of lanes that split its hidden
// units (GroupMlpField), with its weights staged in shared memory, and math
// that keeps the NaN semantics of the plain PyTorch versions.
//
// The field is f(t, y) = tanh(y**p @ W1 + b1) @ W2 + b2 (the MLPField family
// of torchdiffeq_tpu_torch/models/neural_ode.py with one hidden layer), in
// the JAX layout: W1 is (D, H) and W2 is (H, D), both row-major.  The
// kernels are compiled with --fmad=false so that every a*b+c rounds twice,
// exactly as the separate PyTorch operations of the plain versions do; only
// the summation order of the two small matrix products differs from theirs.
//
// 16-bit states (bfloat16, float16) are `Lo<S>` values: every operation on
// them is computed in float and rounded back to S, as PyTorch's operations
// on a 16-bit tensor round each result (and as the TPU kernel's arithmetic
// in the state dtype does).  A matrix product is one operation there, its
// sum accumulated in float and rounded once: the field's two products and
// the RMS norms' sums accumulate in `acc_t<T>` (float for a 16-bit T, T
// itself otherwise, so the float32 and float64 instances are unchanged).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace tdt {

__host__ __device__ __forceinline__ float lo_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__host__ __device__ __forceinline__ float lo_float(__half x) { return __half2float(x); }
template <typename S> __host__ __device__ __forceinline__ S lo_round(float x);
template <> __host__ __device__ __forceinline__ __nv_bfloat16 lo_round<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __host__ __device__ __forceinline__ __half lo_round<__half>(float x) {
  return __float2half_rn(x);
}

// A bfloat16 or float16 value (S) whose arithmetic rounds each result to S;
// a double converts through float, as PyTorch converts one.
template <typename S>
struct Lo {
  S v;
  Lo() = default;
  __host__ __device__ __forceinline__ explicit Lo(float x) : v(lo_round<S>(x)) {}
  __host__ __device__ __forceinline__ explicit Lo(double x) : v(lo_round<S>((float)x)) {}
  __host__ __device__ __forceinline__ explicit Lo(int x) : v(lo_round<S>((float)x)) {}
  __host__ __device__ __forceinline__ float f() const { return lo_float(v); }
};
using bf16 = Lo<__nv_bfloat16>;
using f16 = Lo<__half>;

#define TDT_LO_BINARY(OP)                                                     \
  template <typename S>                                                       \
  __device__ __forceinline__ Lo<S> operator OP(Lo<S> a, Lo<S> b) {            \
    return Lo<S>(a.f() OP b.f());                                             \
  }
TDT_LO_BINARY(+)
TDT_LO_BINARY(-)
TDT_LO_BINARY(*)
TDT_LO_BINARY(/)
#undef TDT_LO_BINARY
#define TDT_LO_COMPARE(OP)                                                    \
  template <typename S>                                                       \
  __device__ __forceinline__ bool operator OP(Lo<S> a, Lo<S> b) {             \
    return a.f() OP b.f();                                                    \
  }
TDT_LO_COMPARE(<)
TDT_LO_COMPARE(<=)
TDT_LO_COMPARE(>)
TDT_LO_COMPARE(>=)
TDT_LO_COMPARE(==)
TDT_LO_COMPARE(!=)
#undef TDT_LO_COMPARE
template <typename S>
__device__ __forceinline__ Lo<S> operator-(Lo<S> a) {
  return Lo<S>(-a.f());
}

// The accumulator of a sum over products: float for a 16-bit T.
template <typename T> struct AccOf { using type = T; };
template <typename S> struct AccOf<Lo<S>> { using type = float; };
template <typename T> using acc_t = typename AccOf<T>::type;
template <typename T> __device__ __forceinline__ acc_t<T> acc(T x) { return x; }
template <typename S> __device__ __forceinline__ float acc(Lo<S> x) { return x.f(); }
template <typename T> __device__ __forceinline__ T from_acc(acc_t<T> x) { return T(x); }

// y**3 as PyTorch computes it: (y*y)*y, rounded after each product, for
// float, double and bfloat16; in float, rounded once, for float16.
template <typename T> __device__ __forceinline__ T cube(T v) { return v * v * v; }
template <> __device__ __forceinline__ f16 cube<f16>(f16 v) {
  return f16(v.f() * v.f() * v.f());
}
template <typename T> __device__ __forceinline__ T field_power(T v, int power) {
  return power == 1 ? v : (power == 2 ? v * v : cube<T>(v));
}

template <typename T> __device__ __forceinline__ T dtanh(T x);
template <> __device__ __forceinline__ float dtanh<float>(float x) { return tanhf(x); }
template <> __device__ __forceinline__ double dtanh<double>(double x) { return tanh(x); }

template <typename T> __device__ __forceinline__ T dsqrt(T x);
template <> __device__ __forceinline__ float dsqrt<float>(float x) { return sqrtf(x); }
template <> __device__ __forceinline__ double dsqrt<double>(double x) { return sqrt(x); }

template <typename T> __device__ __forceinline__ T dabs(T x);
template <> __device__ __forceinline__ float dabs<float>(float x) { return fabsf(x); }
template <> __device__ __forceinline__ double dabs<double>(double x) { return fabs(x); }

template <typename T> __device__ __forceinline__ T dpow(T x, T y);
template <> __device__ __forceinline__ float dpow<float>(float x, float y) { return powf(x, y); }
template <> __device__ __forceinline__ double dpow<double>(double x, double y) { return pow(x, y); }
#define TDT_LO_MATH(TYPE)                                                               \
  template <> __device__ __forceinline__ TYPE dtanh<TYPE>(TYPE x) { return TYPE(tanhf(x.f())); } \
  template <> __device__ __forceinline__ TYPE dsqrt<TYPE>(TYPE x) { return TYPE(sqrtf(x.f())); } \
  template <> __device__ __forceinline__ TYPE dabs<TYPE>(TYPE x) { return TYPE(fabsf(x.f())); }  \
  template <> __device__ __forceinline__ TYPE dpow<TYPE>(TYPE x, TYPE y) {                       \
    return TYPE(powf(x.f(), y.f()));                                                             \
  }
TDT_LO_MATH(bf16)
TDT_LO_MATH(f16)
#undef TDT_LO_MATH

// max/min that propagate NaN like torch.maximum/torch.minimum (fmax/fmin
// would drop it).
template <typename T> __device__ __forceinline__ T nmax(T a, T b) {
  return (a != a || a > b) ? a : b;
}
template <typename T> __device__ __forceinline__ T nmin(T a, T b) {
  return (a != a || a < b) ? a : b;
}

// Shared-memory staging of the MLP weights: W1 (D*H), b1 (H), W2 (H*D),
// b2 (D).  Returns the element count, so a kernel can place more after it.
template <typename T>
__device__ int stage_mlp(T* s, const T* w1, const T* b1, const T* w2,
                         const T* b2, int D, int H) {
  const int n_w1 = D * H, n_b1 = H, n_w2 = H * D, n_b2 = D;
  for (int i = threadIdx.x; i < n_w1; i += blockDim.x) s[i] = w1[i];
  for (int i = threadIdx.x; i < n_b1; i += blockDim.x) s[n_w1 + i] = b1[i];
  for (int i = threadIdx.x; i < n_w2; i += blockDim.x) s[n_w1 + n_b1 + i] = w2[i];
  for (int i = threadIdx.x; i < n_b2; i += blockDim.x)
    s[n_w1 + n_b1 + n_w2 + i] = b2[i];
  return n_w1 + n_b1 + n_w2 + n_b2;
}

// One field evaluation, out = f(y), for a state of compile-time size D held
// in registers.  The hidden layer is never stored: each hidden unit's
// activation is folded into the D output sums as soon as it is computed.
template <typename T, int D>
struct MlpField {
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  int H;
  int power;

  // the per-lane kernels' call: the field takes no time
  __device__ __forceinline__ void operator()(T, const T (&y)[D], T (&out)[D]) const {
    (*this)(y, out);
  }

  __device__ __forceinline__ void operator()(const T (&y)[D], T (&out)[D]) const {
    using A = acc_t<T>;
    T x[D];
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = field_power<T>(y[j], power);
    A o[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = A(0);
    for (int h = 0; h < H; ++h) {
      A s = acc(x[0]) * acc(w1[h]);
#pragma unroll
      for (int j = 1; j < D; ++j) s = s + acc(x[j]) * acc(w1[j * H + h]);
      const A a = acc(dtanh<T>(from_acc<T>(s) + b1[h]));
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = o[d] + a * acc(w2[h * D + d]);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = from_acc<T>(o[d]) + b2[d];
  }
};

// The shuffle mask of the group of L lanes that holds this thread (L a
// power of two up to 32, the groups aligned in the warp, blockDim.x a
// multiple of 32): the L bits from this lane's group start.
__device__ __forceinline__ unsigned group_mask(int L) {
  return L == 32 ? 0xffffffffu
                 : ((1u << L) - 1u) << ((threadIdx.x & 31) & ~(L - 1));
}

// out[d] plus the other partial sums of the L lanes named in `mask`, by an
// xor butterfly: every lane ends with the same bits (IEEE addition
// commutes).
template <typename T, int D>
__device__ __forceinline__ void group_sum(T (&out)[D], unsigned mask, int L) {
  for (int m = 1; m < L; m <<= 1) {
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = out[d] + __shfl_xor_sync(mask, out[d], m);
  }
}

// The same field evaluated by a group of L lanes of one warp (as for
// group_mask), all holding the same y: lane j of the group takes the hidden
// units j, j + L, j + 2L, ..., sums its units' terms of each output in that
// order, and the group adds the L partial sums by an xor butterfly over
// __shfl_xor_sync (group_sum).  IEEE addition is commutative, so every lane
// of the group ends with the same bits of out, whatever the mask; with
// L = 1 the order is MlpField's.  The shuffles name the lanes of `mask`,
// which must all call it together: with the group's own mask
// (group_mask(L)) that is the group alone, so the groups of one warp may
// run their loops for different numbers of steps, or have returned; with
// the whole warp (0xffffffff, the faster constant) it is every lane of the
// warp, as in K-rk4, whose groups all run the same steps.
template <typename T, int D>
struct GroupMlpField {
  const T* w1;
  const T* b1;
  const T* w2;
  const T* b2;
  int H;
  int power;
  int lane;        // this lane's index in its group, 0..L-1
  int L;
  unsigned mask;   // the lanes the shuffles name (see above)

  __device__ __forceinline__ void operator()(T, const T (&y)[D], T (&out)[D]) const {
    (*this)(y, out);
  }

  __device__ __forceinline__ void operator()(const T (&y)[D], T (&out)[D]) const {
    using A = acc_t<T>;
    T x[D];
#pragma unroll
    for (int j = 0; j < D; ++j) x[j] = field_power<T>(y[j], power);
    A o[D];
#pragma unroll
    for (int d = 0; d < D; ++d) o[d] = A(0);
#pragma unroll 2
    for (int h = lane; h < H; h += L) {
      A s = acc(x[0]) * acc(w1[h]);
#pragma unroll
      for (int j = 1; j < D; ++j) s = s + acc(x[j]) * acc(w1[j * H + h]);
      const A a = acc(dtanh<T>(from_acc<T>(s) + b1[h]));
#pragma unroll
      for (int d = 0; d < D; ++d) o[d] = o[d] + a * acc(w2[h * D + d]);
    }
    // a mask that names the whole warp goes in as the constant: with a mask
    // known only at run time the compiler syncs the named lanes before each
    // shuffle
    if (mask == 0xffffffffu)
      group_sum<A, D>(o, 0xffffffffu, L);
    else
      group_sum<A, D>(o, mask, L);
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = from_acc<T>(o[d]) + b2[d];
  }
};

template <typename T, int D>
__device__ __forceinline__ MlpField<T, D> mlp_from_shared(const T* s, int H, int power) {
  return MlpField<T, D>{s, s + D * H, s + D * H + H, s + 2 * D * H + H, H, power};
}

// This thread's lane of its group of L, evaluating the weights staged at s.
template <typename T, int D>
__device__ __forceinline__ GroupMlpField<T, D> group_mlp_from_shared(const T* s, int H,
                                                                     int power, int L) {
  return GroupMlpField<T, D>{s, s + D * H, s + D * H + H, s + 2 * D * H + H, H, power,
                             (int)(threadIdx.x & (L - 1)), L, group_mask(L)};
}

}  // namespace tdt

// Dispatch a templated launch over the state sizes of the register
// instances (1..8: the bound on the registers a thread spends on its state
// and slopes).  K-rk4 takes these D only (ops/kernels.py checks it before a
// launch); K-dopri5 and K-events run larger D in their shared-memory
// instances (lane_ops.cuh `WideLane`).
#define TDT_DISPATCH_D(D, LAUNCH)            \
  switch (D) {                               \
    case 1: LAUNCH(1); break;                \
    case 2: LAUNCH(2); break;                \
    case 3: LAUNCH(3); break;                \
    case 4: LAUNCH(4); break;                \
    case 5: LAUNCH(5); break;                \
    case 6: LAUNCH(6); break;                \
    case 7: LAUNCH(7); break;                \
    case 8: LAUNCH(8); break;                \
    default: return (int)cudaErrorInvalidValue; \
  }

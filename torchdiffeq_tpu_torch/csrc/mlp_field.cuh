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
#pragma once

#include <cuda_runtime.h>

namespace tdt {

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

  __device__ __forceinline__ void operator()(const T (&y)[D], T (&out)[D]) const {
    T x[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T v = y[j];
      // y*y*y is (y*y)*y, as torch's pow(y, 3) computes it
      x[j] = power == 1 ? v : (power == 2 ? v * v : v * v * v);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = T(0);
    for (int h = 0; h < H; ++h) {
      T s = x[0] * w1[h];
#pragma unroll
      for (int j = 1; j < D; ++j) s = s + x[j] * w1[j * H + h];
      const T a = dtanh<T>(s + b1[h]);
#pragma unroll
      for (int d = 0; d < D; ++d) out[d] = out[d] + a * w2[h * D + d];
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = out[d] + b2[d];
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

  __device__ __forceinline__ void operator()(const T (&y)[D], T (&out)[D]) const {
    T x[D];
#pragma unroll
    for (int j = 0; j < D; ++j) {
      const T v = y[j];
      x[j] = power == 1 ? v : (power == 2 ? v * v : v * v * v);
    }
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = T(0);
#pragma unroll 2
    for (int h = lane; h < H; h += L) {
      T s = x[0] * w1[h];
#pragma unroll
      for (int j = 1; j < D; ++j) s = s + x[j] * w1[j * H + h];
      const T a = dtanh<T>(s + b1[h]);
#pragma unroll
      for (int d = 0; d < D; ++d) out[d] = out[d] + a * w2[h * D + d];
    }
    // a mask that names the whole warp goes in as the constant: with a mask
    // known only at run time the compiler syncs the named lanes before each
    // shuffle
    if (mask == 0xffffffffu)
      group_sum<T, D>(out, 0xffffffffu, L);
    else
      group_sum<T, D>(out, mask, L);
#pragma unroll
    for (int d = 0; d < D; ++d) out[d] = out[d] + b2[d];
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

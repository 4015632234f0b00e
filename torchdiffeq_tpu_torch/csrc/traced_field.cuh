// What a traced instance of K-dopri5 and K-events includes: the two lane
// templates and the math of the traced op set (ops/traced.py), in float,
// double, bfloat16 and float16 (tdt::Lo, mlp_field.cuh: each operation in
// float, rounded once to the state dtype; a sum or a matrix product
// accumulated in float and rounded once).
//
// ops/traced.py traces a per-sample field f(t, y, *args) (and an event
// function e(t, y)) with torch.fx into a graph of ATen operations and emits
// it as a functor of straight-line code: one `const T vN = ...;` a value,
// in the graph's order, each operation rounded to the state dtype as
// PyTorch rounds it (the build's --fmad=false keeps every a*b+c two
// roundings).  The emitted translation unit defines `Field` (and `Event`),
// the method's tableau compiled into the instance (`MethodTableau`, the
// compiled kind of lane_ops.cuh: each nonzero coefficient a constant, the
// zero ones dropped at compile time) and the C entry points
// `tdt_traced_lanes` / `tdt_traced_events`, which instantiate
// `tdt_lanes::launch_traced` / `tdt_events::launch_traced` and take no
// tableau; ops/_build.py compiles it alone into a library keyed by the hash
// of its source, which names the method.
//
// What bounds an instance is its slowest lane's steps times one step's
// dependent chain (dopri5_lanes.cuh): with the tableau compiled in, that
// chain is the field's straight-line code, the stage sums, and the error
// ratio's and controller's divides, square root and pow.
//
// Replaces the "any traceable field(t, y, *params)" of the TPU kernels
// torchdiffeq_tpu/ops/pallas_kernels.py:336 and :580, which trace a JAX
// field into the Pallas kernel; a CUDA kernel cannot run a Python callable,
// so the tracer compiles one.
#pragma once

#include "dopri5_events.cuh"
#include "dopri5_lanes.cuh"

namespace tdt {

// The traced op set's functions of one value.  PyTorch's own kernels call
// the same libm functions on the card; on the CPU they may differ in the
// last bit (the plain version's tolerance covers it).
template <typename T> __device__ __forceinline__ T tsin(T x);
template <typename T> __device__ __forceinline__ T tcos(T x);
template <typename T> __device__ __forceinline__ T texp(T x);
template <typename T> __device__ __forceinline__ T tlog(T x);
template <> __device__ __forceinline__ float tsin<float>(float x) { return sinf(x); }
template <> __device__ __forceinline__ double tsin<double>(double x) { return sin(x); }
template <> __device__ __forceinline__ float tcos<float>(float x) { return cosf(x); }
template <> __device__ __forceinline__ double tcos<double>(double x) { return cos(x); }
template <> __device__ __forceinline__ float texp<float>(float x) { return expf(x); }
template <> __device__ __forceinline__ double texp<double>(double x) { return exp(x); }
template <> __device__ __forceinline__ float tlog<float>(float x) { return logf(x); }
template <> __device__ __forceinline__ double tlog<double>(double x) { return log(x); }
// bfloat16 and float16 (tdt::Lo): computed in float, rounded once to the
// state dtype, as PyTorch's 16-bit kernels and JAX's arithmetic in that
// dtype compute them.
#define TDT_LO_TRACED_MATH(TYPE)                                                     \
  template <> __device__ __forceinline__ TYPE tsin<TYPE>(TYPE x) { return TYPE(sinf(x.f())); } \
  template <> __device__ __forceinline__ TYPE tcos<TYPE>(TYPE x) { return TYPE(cosf(x.f())); } \
  template <> __device__ __forceinline__ TYPE texp<TYPE>(TYPE x) { return TYPE(expf(x.f())); } \
  template <> __device__ __forceinline__ TYPE tlog<TYPE>(TYPE x) { return TYPE(logf(x.f())); }
TDT_LO_TRACED_MATH(bf16)
TDT_LO_TRACED_MATH(f16)
#undef TDT_LO_TRACED_MATH

}  // namespace tdt

extern "C" const char* tdt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K-dopri5's float32 and float64 instances and its C entry point; the
// kernels are in dopri5_lanes.cuh, the 16-bit instances in
// dopri5_lanes_16bit.cu.
#include "dopri5_lanes.cuh"

namespace tdt_lanes {
// instantiated in dopri5_lanes_16bit.cu
extern template int launch<tdt::bf16>(
    int B, int D, int H, int power, const void* y0, const void* ts, int S,
    double t0, double t1, double rtol, double atol, double safety,
    double ifactor, double dfactor, double first_step, int use_first_step,
    int max_steps, const void* tab, int n_alpha, int order, int fsal,
    const void* w1, const void* b1, const void* w2, const void* b2, int L,
    int threads, void* ys, void* n_acc, void* n_steps, void* stream);
extern template int launch<tdt::f16>(
    int B, int D, int H, int power, const void* y0, const void* ts, int S,
    double t0, double t1, double rtol, double atol, double safety,
    double ifactor, double dfactor, double first_step, int use_first_step,
    int max_steps, const void* tab, int n_alpha, int order, int fsal,
    const void* w1, const void* b1, const void* w2, const void* b2, int L,
    int threads, void* ys, void* n_acc, void* n_steps, void* stream);
}  // namespace tdt_lanes

using namespace tdt_lanes;


// dtype: 0 = float32, 1 = float64, 2 = bfloat16, 3 = float16 (tdt::Lo).  y0
// is (D, B), ts (S,) increasing, ys
// (S, D, B); n_acc and n_steps are (B,) int32.  Scalars are values of the
// state dtype passed exactly as doubles; `tab` is the packed tableau in the
// state dtype.  group is the lanes a trajectory, a power of two from 1 to
// 32; threads the block size, a multiple of group up to 128 (the host sizes
// it to the shared memory of the shared-memory instance).  Returns a CUDA
// error code (0 on success).
extern "C" int tdt_dopri5_lanes(int dtype, int B, int D, int H, int power,
                                const void* y0, const void* ts, int S, double t0,
                                double t1, double rtol, double atol,
                                double safety, double ifactor, double dfactor,
                                double first_step, int use_first_step,
                                int max_steps, const void* tab, int n_alpha,
                                int order, int fsal, const void* w1,
                                const void* b1, const void* w2, const void* b2,
                                int group, int threads, void* ys, void* n_acc,
                                void* n_steps, void* stream) {
  if (n_alpha < 1 || n_alpha > TDT_PACK_ALPHA || D < 1) return (int)cudaErrorInvalidValue;
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (threads < group || threads > 128 || threads % group != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(B, D, H, power, y0, ts, S, t0, t1, rtol, atol, safety,
                         ifactor, dfactor, first_step, use_first_step, max_steps,
                         tab, n_alpha, order, fsal, w1, b1, w2, b2, group, threads,
                         ys, n_acc, n_steps, stream);
  if (dtype == 1)
    return launch<double>(B, D, H, power, y0, ts, S, t0, t1, rtol, atol, safety,
                          ifactor, dfactor, first_step, use_first_step, max_steps,
                          tab, n_alpha, order, fsal, w1, b1, w2, b2, group,
                          threads, ys, n_acc, n_steps, stream);
  if (dtype == 2)
    return launch<tdt::bf16>(B, D, H, power, y0, ts, S, t0, t1, rtol, atol, safety,
                              ifactor, dfactor, first_step, use_first_step, max_steps,
                              tab, n_alpha, order, fsal, w1, b1, w2, b2, group,
                              threads, ys, n_acc, n_steps, stream);
  if (dtype == 3)
    return launch<tdt::f16>(B, D, H, power, y0, ts, S, t0, t1, rtol, atol, safety,
                             ifactor, dfactor, first_step, use_first_step, max_steps,
                             tab, n_alpha, order, fsal, w1, b1, w2, b2, group,
                             threads, ys, n_acc, n_steps, stream);
  return (int)cudaErrorInvalidValue;
}

// The card's limit on a block's dynamic shared memory (the opt-in maximum of
// the current device), for the host's sizing of a launch.
extern "C" int tdt_max_shared_bytes(int* out) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(out, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  return (int)err;
}

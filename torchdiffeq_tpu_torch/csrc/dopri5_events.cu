// K-events' float32 and float64 instances and its C entry point; the
// kernels are in dopri5_events.cuh, the 16-bit instances in
// dopri5_events_16bit.cu.
#include "dopri5_events.cuh"

namespace tdt_events {
// instantiated in dopri5_events_16bit.cu
extern template int launch<tdt::bf16>(
    int B, int D, int H, int power, const void* y0, double t0, double rtol,
    double atol, double safety, double ifactor, double dfactor,
    double first_step, int use_first_step, int max_steps, const void* tab,
    int n_alpha, int order, int fsal, const void* w1, const void* b1,
    const void* w2, const void* b2, int K, const void* ev_w, const void* ev_c,
    const void* ev_b, const void* sign0, int bisect_iters, int L, int threads,
    void* event_t, void* y_event, void* found, void* n_acc, void* n_steps,
    void* stream);
extern template int launch<tdt::f16>(
    int B, int D, int H, int power, const void* y0, double t0, double rtol,
    double atol, double safety, double ifactor, double dfactor,
    double first_step, int use_first_step, int max_steps, const void* tab,
    int n_alpha, int order, int fsal, const void* w1, const void* b1,
    const void* w2, const void* b2, int K, const void* ev_w, const void* ev_c,
    const void* ev_b, const void* sign0, int bisect_iters, int L, int threads,
    void* event_t, void* y_event, void* found, void* n_acc, void* n_steps,
    void* stream);
}  // namespace tdt_events

using namespace tdt_events;


// dtype: 0 = float32, 1 = float64, 2 = bfloat16, 3 = float16 (tdt::Lo).  y0
// and y_event are (D, B); sign0 is
// (K, B); event_t, found, n_acc and n_steps are (B,) (found and the counts
// int32).  The event weights are W (K, D), c (K,), b (K,), 1 <= K <= 4.
// Scalars are values of the state dtype passed exactly as doubles; `tab` is
// the packed tableau in the state dtype.  group is the lanes a trajectory, a
// power of two from 1 to 32; threads the block size, as for
// tdt_dopri5_lanes.  Returns a CUDA error code (0 on success).
extern "C" int tdt_dopri5_events(int dtype, int B, int D, int H, int power,
                                 const void* y0, double t0, double rtol,
                                 double atol, double safety, double ifactor,
                                 double dfactor, double first_step,
                                 int use_first_step, int max_steps,
                                 const void* tab, int n_alpha, int order,
                                 int fsal, const void* w1, const void* b1,
                                 const void* w2, const void* b2, int K,
                                 const void* ev_w, const void* ev_c,
                                 const void* ev_b, const void* sign0,
                                 int bisect_iters, int group, int threads,
                                 void* event_t, void* y_event, void* found,
                                 void* n_acc, void* n_steps, void* stream) {
  if (n_alpha < 1 || n_alpha > TDT_PACK_ALPHA || D < 1) return (int)cudaErrorInvalidValue;
  if (K < 1 || K > TDT_MAX_EVENTS) return (int)cudaErrorInvalidValue;
  if (group < 1 || group > 32 || (group & (group - 1)) != 0 || B <= 0)
    return (int)cudaErrorInvalidValue;
  if (threads < group || threads > 128 || threads % group != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(B, D, H, power, y0, t0, rtol, atol, safety, ifactor,
                         dfactor, first_step, use_first_step, max_steps, tab,
                         n_alpha, order, fsal, w1, b1, w2, b2, K, ev_w, ev_c,
                         ev_b, sign0, bisect_iters, group, threads, event_t,
                         y_event, found, n_acc, n_steps, stream);
  if (dtype == 1)
    return launch<double>(B, D, H, power, y0, t0, rtol, atol, safety, ifactor,
                          dfactor, first_step, use_first_step, max_steps, tab,
                          n_alpha, order, fsal, w1, b1, w2, b2, K, ev_w, ev_c,
                          ev_b, sign0, bisect_iters, group, threads, event_t,
                          y_event, found, n_acc, n_steps, stream);
  if (dtype == 2)
    return launch<tdt::bf16>(B, D, H, power, y0, t0, rtol, atol, safety, ifactor,
                              dfactor, first_step, use_first_step, max_steps, tab,
                              n_alpha, order, fsal, w1, b1, w2, b2, K, ev_w, ev_c,
                              ev_b, sign0, bisect_iters, group, threads, event_t,
                              y_event, found, n_acc, n_steps, stream);
  if (dtype == 3)
    return launch<tdt::f16>(B, D, H, power, y0, t0, rtol, atol, safety, ifactor,
                             dfactor, first_step, use_first_step, max_steps, tab,
                             n_alpha, order, fsal, w1, b1, w2, b2, K, ev_w, ev_c,
                             ev_b, sign0, bisect_iters, group, threads, event_t,
                             y_event, found, n_acc, n_steps, stream);
  return (int)cudaErrorInvalidValue;
}

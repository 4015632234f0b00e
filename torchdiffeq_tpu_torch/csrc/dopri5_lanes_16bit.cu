// K-dopri5's bfloat16 and float16 instances (tdt::Lo, mlp_field.cuh):
// the kernels of dopri5_lanes.cuh, compiled apart from the float32 and float64
// ones so that the build runs both halves at once.
#include "dopri5_lanes.cuh"

namespace tdt_lanes {
template int launch<tdt::bf16>(
    int B, int D, int H, int power, const void* y0, const void* ts, int S,
    double t0, double t1, double rtol, double atol, double safety,
    double ifactor, double dfactor, double first_step, int use_first_step,
    int max_steps, const void* tab, int n_alpha, int order, int fsal,
    const void* w1, const void* b1, const void* w2, const void* b2, int L,
    int threads, void* ys, void* n_acc, void* n_steps, void* stream);
template int launch<tdt::f16>(
    int B, int D, int H, int power, const void* y0, const void* ts, int S,
    double t0, double t1, double rtol, double atol, double safety,
    double ifactor, double dfactor, double first_step, int use_first_step,
    int max_steps, const void* tab, int n_alpha, int order, int fsal,
    const void* w1, const void* b1, const void* w2, const void* b2, int L,
    int threads, void* ys, void* n_acc, void* n_steps, void* stream);
}  // namespace tdt_lanes

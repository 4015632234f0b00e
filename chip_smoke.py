#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main path at the spiral neural-ODE's full width (an MLP
field 2 -> 64 -> 2 on y**3, B=1024 trajectories, T=10 output times on
[0, 1], rtol=1e-7, atol=1e-9; weights from a numpy seed) through the
public entry points -- the forward solve, and the training step of the JAX
package's bench.py (continuous-adjoint gradients and an SGD update) --,
the three per-trajectory CUDA kernels through the routes that run them,
and the fused-step kernel through the chain of the JAX package's
benchmarks/bench_fused_field.py at its full width:

  1. the card, the torch/CUDA versions, and the kernels' build, with each
     K-rk4, K-dopri5, K-events and K-fused instance's registers and spills
     (the ptxas log) and whether its SASS (`cuobjdump -sass`) holds
     tensor-core instructions (HGMMA, HMMA) and asynchronous copies
     (UTMALDG, LDGSTS): every K-fused instance must copy asynchronously and
     every bfloat16 one run HGMMA, and no instance that a later phase
     launches may spill;
  2. TF32 off for matmuls and convolutions (full float32);
  3. the main path and the kernel routes, once, with the kernels' launch
     counts reset before and read after: `odeint_with_stats` (dopri5),
     `odeint(method='rk4', options=dict(pallas=True, num_steps=1000))` and
     `odeint_per_sample_with_stats(options=dict(pallas=True))`;
  4. the main path on CUDA against the same call on the CPU, float32 and
     float64;
  5. K-rk4 against its plain PyTorch version on the same CUDA tensors, and
     both timed at B=1024 and B=65536, with the group width (lanes a
     trajectory) the host picks at each;
  6. K-dopri5 likewise, with per-lane step counts, the group width (lanes
     a trajectory) the host picks at each batch, and three times: through
     the wrapper, the bare launch (the C call with its arguments prepared
     once) and the device time alone (CUDA events around launches queued
     behind a sleep, so that no host time falls inside); and dopri8 (14
     stages, the shared-memory instance) in float64 against the plain
     version at B=1024, with its device time in that run;
  7. the event path: `odeint_event` over the whole batch (one controller)
     with a two-output event -- a threshold on the batch mean of y[:, 0]
     that fires first, and a time cut-off -- and `odeint_dense` on [0, 1],
     each against the same call on the CPU in float32 and float64, and the
     dense solution against phase 3's `odeint` values;
  8. K-events: `odeint_per_sample_with_stats(event_fn=LinearEvent(...),
     options=dict(pallas=True, ...))` with a per-lane state threshold and a
     time cut-off that ends every lane, its launch count reset before and
     read after; the kernel against its plain version (per-lane `found`,
     step and accept counts), and both timed at B=1024 and B=65536, the
     kernel three ways, as in phase 6, and dopri8 as there; (8b)
     K-dopri5 and K-events in float64 with the order-2 methods (fehlberg2,
     adaptive_heun) on a field with no sum to reorder, every output, count
     and NaN equal to the plain version's (`_order2_vs_plain`);
  9. K-fused: the bench's chain at B=4096, D=256, H=1024 (tanh MLP field
     `ops.fused_field.mlp_field`, weights randn * 0.05 and biases 0, y0
     randn, all from numpy RandomState(1); the bfloat16 copies rounded from
     float32 to nearest even), dopri5, dt=1e-4, in float32 and bfloat16:
     20 steps of `fused_stage_step` with the launch count reset before and
     read after, and the same 20 steps of the stock `runge_kutta_step(...,
     error_dtype=float32)`, with sum|y| of both; one step of the kernel
     against its plain version `fused_stage_step_ref` on the same CUDA
     tensors at dt=1e-4, and in float32 at dt=0.75 too, where the error
     estimate is truncation and not rounding noise; per-step times of the
     kernel (through its wrapper, and its bare launch alone), the plain
     version and the stock step, with TFLOP/s, the share of the bound and
     the weight stream's rate;
 10. the training step of bench.py at full width, float32: `odeint_adjoint`
     (dopri5, rtol=1e-7, atol=1e-9) of the spiral field from bench.py's
     `make_shared_init` (RandomState(0)), loss mean((ys - target)**2),
     backward, p -= 1e-3 * grad; the launch counts reset before and read
     after (the step runs no kernel of the port); its gradients against the
     same step on the CPU in float64, the loss over 5 steps, the float64
     forward and backward counters on the card against the CPU's; the warm
     step's median wall time and spread over 12 steps, split into forward
     and backward (CUDA events, the step ending in a synchronize), the
     forward and backward steps and NFE, VF evals/s, and the device-busy
     share and launch count from one `torch.profiler` trace of a step; and
     one `odeint_event` gradient on the card against the CPU;
 11-13. the fixed-grid tier, the Adams and implicit tiers and the conv
     ODE-Net's training step (each phase's function says what it runs);
 14. the per-sample batched driver (`solvers/batched_rk.py`, the route of
     every per-sample problem the kernels do not take): examples/ensemble.py
     at its defaults (B=1024 damped oscillators with a frequency per sample,
     args_axes=(-1,), dopri5 rtol=1e-6, float32) with its per-sample first
     zeros as events, timed, with the driver's iterations, its host reads
     and launches an iteration and the device's busy share; the driver
     against K-dopri5 and K-events on the spiral at B=1024 in float32 and
     float64; the per-sample gradient (float64 card against CPU, through
     the solve and through the oscillators' per-sample events, and a timed
     float32 step at B=1024); and benchmarks/bench_ensemble.py's
     scalar field at B=65536 against its closed form;
 15. the per-sample stiff, implicit and 16-bit route: (a) phase 12c's
     linear relaxation at B=1024 through `odeint_per_sample_with_stats`
     with kvaerno5 and radau5a (each sample its own controller and 1x1
     Newton solves) against its exact solution, timed beside phase 12c's
     one-controller dense-LU solve; (b) a stiff van der Pol ensemble (mu
     per sample) at B=1024, timed, 8 of its samples card against CPU;
     (c) implicit_adams, gl4 (Broyden) and trbdf2 (Newton) per sample,
     card against CPU, every sample finite; (d) kvaerno5's per-sample gradients by the continuous
     adjoint, replay_grad and forward_grad, card against CPU; (e) a
     callback, a grid_constructor and a fixed-grid event gradient, card
     against CPU; (f) K-dopri5 and K-events in bfloat16 and float16 through
     `odeint_per_sample(..., options=dict(pallas=True))` with the launch
     counts reset before and read after, each against its plain version
     and timed three ways at B=1024 and B=65536; (g) the phase's seconds;
 16. a JSON line with one entry per kernel (its launches on its path, its
     error against its plain version, its time, the plain version's time,
     its bound on this card and the PyTorch call that computes the same
     function, where one exists; the 16-bit instances as entries of their
     own, the traced instances of phases 17 and 18 too), the card's name
     and power limit, then the result line; printed after phase 18.
 17. the examples (torchdiffeq_tpu_torch/examples/) at their default widths,
     only iteration counts cut: (a) examples/ensemble.py through its `main`
     (B=1024, float32) with the launch counts reset before and read after,
     its two kernel calls launching the traced K-dopri5 and K-events
     instances of its field and event (ops/traced.py), each against its
     plain version in float32 and float64 and timed three ways beside
     phase 14 (a)'s driver, with the instances' first-use build times and
     their bounds; (b) ode_demo with `odeint` and `--adjoint`; (c)
     latent_ode (100 spirals, a solve per trajectory); (d) cnf with `odeint`
     and `--adjoint`; (e) odenet_mnist (the ODE-Net with and without
     `--adjoint`, and the residual network), each timed with its NFE, and a
     float64 step card against CPU for (b)-(d); (f) bouncing_ball whole in
     float64; (g) learn_physics, EX_STEPS of its 300 iterations; (h) the
     phase's seconds;
 18. every state dtype: (a) complex states on a discretised 1-D
     Schroedinger equation (64 wavepackets on 256 points, complex128):
     the dopri5 solve card against CPU and against unitarity, complex64
     against complex128, the odeint_adjoint training step (default and
     interpolated) with respect to the potential's coefficients and psi0,
     an event solve, the per-sample driver, and one wavepacket of 512
     points through kvaerno5, radau5a and gl4 (their stage systems on the
     stacked real view), each timed, with the device's busy share and the
     linear solves' share; (b) the bfloat16 and float16 traced instances
     of K-dopri5 and K-events on examples/ensemble.py's field and event,
     launched through `odeint_per_sample(pallas=True)` with the counts
     reset before and read after, each against its plain version on the
     card and timed three ways at B=1024 and B=65536; (c) the phase's
     seconds.
 19. Parareal and the training loops (no kernel; the launch counts reset
     before and read after): (a) `odeint_parareal_with_info` on phase
     10's spiral field (H=64) with its B=1024 spirals as one state of 2048
     values, t = linspace(0, 1, 10) (9 slices), dopri5 fine at rtol 1e-7,
     atol 1e-9, rk4 coarse with 2 steps: in float64 with n_iters = 9 its
     values and the gradient of sum(ys[-1]**2) in y0, the MLP's
     parameters and t against the slice-restarted chain of `odeint` /
     `odeint_adjoint`; in float32 with n_iters = 3 its correction norms,
     the driver's iterations, device time (CUDA events), wall time and
     busy share beside the chain's; (b) the parareal_demo's `main` whole;
     (c) phase 10's training step through `training.make_sgd_step` under
     `scan_steps` (3 steps) against the same step by hand, `fit` (5 steps,
     2 a dispatch) against one scan, `make_optax_step` with the port's
     Adam in float64 against the same optimizer by hand, a bfloat16
     parameter kept bfloat16, and the time a step beside phase 10's; the
     phase's seconds (budget PAR_BUDGET_S).
 20. the device mesh on torch.distributed (`parallel/sharding.py`, one
     process a rank): (a) a world of one rank with NCCL on the card:
     `data_parallel_odeint`, `sharded_independent_odeint` and Parareal's
     ``mesh=`` against their unsharded solves bit for bit, and the
     per-sample K-dopri5 route under `sharded_independent_odeint` (its
     launch count reset before and read after) against its plain version;
     (b) MESH_RANKS ranks on the one card, subprocesses on gloo (NCCL
     refuses two ranks on one device): `data_parallel_odeint` in float64
     against the single solve on the card, each rank's result, then the
     decisions it makes global (kvaerno5, implicit_adams, an event solve)
     and Parareal's mesh gradient against the single solve
     (`_mesh_checks`); a collective that gloo refuses on CUDA tensors
     fails the phase, named;
     (c) the phase's seconds (budget MESH_BUDGET_S).
 21. the sharded training step of the JAX package's
     `__graft_entry__.dryrun_multichip` (examples/sharded_step.py; no
     kernel, the launch counts reset before and read after): (a) a world
     of one rank on NCCL, mesh {'data': 1, 'model': 1}: phase 10's step
     through `data_parallel_odeint` and `tensor_parallel_mlp` against the
     unsharded step, bit for bit with equal forward and backward counters,
     and so is the step of a field of STEP_DEEP hidden layers, and its
     median time a step beside phase 10's; (b) STEP_RANKS ranks on the
     card, subprocesses on gloo: the dry run's float64 step on {'data': 1,
     'model': 2} and {'data': 2, 'model': 1}, and the deeper field's on
     the first, against the single step (STEP_F64_REL, counters equal),
     and the refused gradient route (an implicit adjoint method with a
     `tensor_parallel_mlp` field) raising on every rank; the phase's
     seconds (budget STEP_BUDGET_S); (c) the gradient
     routes that run their backward over each rank's block (no kernel,
     the launch counts reset before and read after): (a) on a world of
     one rank on NCCL, phase 11's fixed-grid training step through
     `data_parallel_odeint` against the unsharded step, bit for bit, and
     the two timed in alternating pairs, beside phase 11's median; (b)
     ROUTE_RANKS ranks on the card, subprocesses on gloo: each of ROUTES'
     float64 gradients (the fixed grid, the implicit fixed grid, the
     replay, forward_grad's jvp, an event solve, the interpolated,
     callable-norm and SciPy adjoints, and an implicit (kvaerno5) and an
     Adams (implicit_adams) adjoint method) against the single solve
     (ROUTE_F64_REL, counters equal); the part's seconds (budget
     ROUTE_BUDGET_S).

``torchrun --nproc_per_node=N chip_smoke.py --mesh-cards`` instead runs
the device mesh and the sharded training step across N cards, one rank a
card, with `_mesh_checks` and Parareal's forward and gradient step timed
on the N cards against one (`_mesh_cards`).

Each phase prints one line; any failure raises and the script exits
non-zero.  It needs one CUDA device and the CUDA toolkit (nvcc), and
exits non-zero without a result when there is no device.

    python3 chip_smoke.py
"""
import json
import re
import subprocess
import sys
import time

import numpy as np

B, H, T = 1024, 64, 10
RTOL, ATOL = 1e-7, 1e-9
RK4_STEPS, RK4_T = 1000, 11   # the rk4 route needs num_steps % (T-1) == 0
BIG_B = 65536

# Tolerances, each with its reason:
# - float64, kernel or CUDA against its plain version or the CPU: the same
#   operations in the same order except the two small matrix products'
#   summation order and tanh's last ULP, so step counts are exactly equal
#   and values agree to 1e-10 (a 1e-16 difference amplified over a solve).
F64_VALUES = 1e-10
# - float32, the fixed-step K-rk4: the same per-step ULP differences summed
#   over 1000 steps on |y| ~ 3.
F32_RK4 = 1e-4
# - float32 adaptive solves: a one-ULP difference in a stage slope moves the
#   embedded error estimate (a near-cancelling sum) by far more than one ULP
#   and with it the step sizes, so values agree to the solver's tolerance
#   scaled by |y|, and step counts within a few steps (up to 2 measured on
#   the H100 for K-dopri5 at B=1024, none for the main path).
F32_ADAPTIVE_VALUES = 1e-4
F32_ADAPTIVE_STEPS = 5
# - float32 event times: the event is where a state crosses a level, so a
#   difference of F32_ADAPTIVE_VALUES in the state moves it by that over
#   the state's rate of change (about 0.1 per unit time for the batch mean
#   of this field, and at least that for the lanes that cross their
#   threshold): 1e-3.  Time cut-offs are exact to float32 rounding.
F32_EVENT_T = 1e-3
# - the dense solution against odeint at the same output times: the same
#   accepted steps and the same quartic, evaluated in the same order, so
#   they agree to float32 rounding of |y| ~ 3.
F32_DENSE_VS_ODEINT = 1e-6
# - K-fused against its plain version, one step (phase 9): each output
#   within `ops.fused_field.kernel_bounds` (the float32 products' summation
#   order, and in bfloat16 the flips of a hidden unit's or a slope's
#   rounding that it can cause; the reasons stand beside KERNEL_F32_SLOPE
#   there).  At the bench's dt=1e-4 the error estimate y1_err is rounding
#   noise (median |y1_err| about 1e-12 in float32), below its bound, so a
#   kernel that wrote a wrong y1_err would pass that bound.  Two checks
#   hold it instead:
#   * float32, one more step at FUSED_TRUNC_DT, where the estimate is
#     truncation (median |y1_err| about 7e-5 at D=256, H=1024): the bound
#     must be at most ERR_MEDIAN_SHARE of the median |y1_err|, so a zero or
#     a dropped c_error term falls outside it;
#   * bfloat16, at dt=1e-4: a slope moves by 1e-4 * |f|, far under a
#     bfloat16 ULP of the state, so a stage input never flips and an
#     element's y1_err differs only where one of its slopes flipped (under
#     2% of elements): the median |kernel - plain| must be at most
#     ERR_MEDIAN_SHARE of the median |y1_err|.  (The bfloat16 bound itself
#     is a slope ULP wide, larger than the estimate at any step size.)
FUSED_TRUNC_DT = 0.75
ERR_MEDIAN_SHARE = 0.1
# - the 20-step chains of K-fused and of the stock step, sum|y|: the same
#   method with the same float32 stage sums in float32, so they agree to a
#   few float32 ULPs relative.  In bfloat16 a step moves the state by
#   1e-4 * |f|, under a bfloat16 ULP of |y|, so both chains end where they
#   start in nearly every element: their sum|y| is printed, as the bench
#   prints it, and checks nothing.
CHAIN_F32_REL = 1e-5
# - dopri8 in K-dopri5 and K-events against the plain version, float64
#   (phases 6 and 8): dopri8's embedded error estimate is a near-cancelling
#   sum of 14 slopes, rounding noise on lanes where the field is nearly
#   linear over a step (the y**3 field is flat near 0), and the next step
#   size follows it: two summation orders of the hidden units take steps of
#   slightly different sizes there, agree to the solver's tolerance (1.8e-6
#   measured on this batch on the CPU between two such orders) and can flip
#   an accept (ROADMAP C7).  Values are held to 1e-4 and the share of lanes
#   whose counts differ to 1%.
DOPRI8_VALUES = 1e-4
DOPRI8_FLIP_SHARE = 0.01
# - the training step's float32 gradients on the card against the float64
#   gradients of the same step on the CPU (phase 10): float32 rounding moves
#   the step sizes of both solves (float32 takes 11 backward steps where
#   float64 takes 10, on the CPU), so they agree to the solvers' tolerance
#   relative to the gradient, not to float32's epsilon: 3.4e-7 of max|g|
#   measured between float32 and float64 on the CPU.  Held to 1e-5 of max|g|.
GRAD_F32_REL = 1e-5
# - float64 gradients on the card against the CPU (the training step and
#   odeint_event, phase 10): the same steps, differing in the products'
#   summation order and tanh's last ULP, carried through a forward and a
#   backward solve: 1e-9 of max|g|.
GRAD_F64_REL = 1e-9
# - phase 11, the fixed grid.  float64 solves, gradients and event times on
#   the card against the CPU: as above (F64_VALUES, GRAD_F64_REL), Stats
#   exactly equal.  K-rk4 against the float32 loop's rk4: the kernel forms
#   every stage in float32, while the loop, as JAX, forms the stages after
#   the first in float64 (the time dtype) and rounds each increment back;
#   over 36 steps on |y| <= 3.6 the plain version and the loop agree to
#   3.6e-7 on the CPU: 1e-5.  The fixed-grid training step's float32
#   gradients against the CPU's float64: no step size moves on a fixed
#   grid, so float32 rounding of the states alone, 6.8e-7 of max|g| on the
#   CPU: GRAD_F32_REL.  remat=True against the plain loop on the card: the
#   same kernels on the same inputs, recomputed, so bit for bit.
F32_RK4_LOOP = 1e-5
# - a bfloat16 state with float32 error control against the float32 state
#   at the same tolerances (BF16_RTOL, BF16_ATOL: the main path's 1e-7 is
#   under bfloat16's rounding of the stages, where no step is accepted):
#   bfloat16 keeps 8 bits, so each accepted step rounds |y| <= 3.6 by up to
#   2^-9 relative: values within BF16_VALUES of max|y| over the solve's
#   steps; the float32 error estimate sees the stages' bfloat16 rounding,
#   so it takes more steps (5 against 3 on the CPU): at most BF16_STEPS
#   times the float32 count.
BF16_RTOL, BF16_ATOL = 1e-3, 1e-5
BF16_VALUES = 3e-2
BF16_STEPS = 3
# - phase 12, the Adams and implicit tiers.  float64 card against CPU:
#   values within F64_VALUES of max|y| (the stage solves end within their
#   1e-8 of the roots by the same iterates, rounding apart: LU pivoting,
#   the products' summation order and tanh's last ULP), Stats equal,
#   gradients within GRAD_F64_REL.  The implicit_adams step's float32
#   gradients against the card's float64 step: float32 rounding of the
#   states and of the corrector's convergence tests: 4.9e-7 of max|g|
#   measured on the H100, held to GRAD_F32_REL.  The batched stiff problem
#   against its exact solution, rtol 1e-8 and atol 1e-10 on |y| <= 5:
#   7.8e-11 (B=1024) to 2.8e-10 (kvaerno3, B=256) measured on the H100,
#   held to STIFF_EXACT.
STIFF_EXACT = 1e-8
FIXED_STEPS = 36          # phase 11's num_steps (4 an output interval)
FIXED_EVENT_STEP = 0.01   # and the fixed-grid event solve's step_size
TRAIN_STEPS = 12         # phase 10's timed warm steps
LOSS_STEPS = 5           # and the steps over which the loss must fall
EVENT_CUT = 0.9          # phase 7's time cut-off
EVENT_MAX_STEPS = 1000   # phase 8's max_num_steps
FB, FD, FH = 4096, 256, 1024   # bench_fused_field.py:25
FUSED_DT, FUSED_STEPS = 1e-4, 20
IMPLICIT_B = 32          # phase 12's card-vs-CPU batch (the CPU side stays
#                          quick)
STIFF_B = 1024           # phase 12's batched stiff problem
# kvaerno3's batch there: at B=1024 its warm solve alone took 3272 steps
# and 56.3 s on the H100, past the phase's STIFF_BUDGET_S
KVAERNO3_B = 256
STIFF_BUDGET_S = 60
TRACE_STEPS = 20         # the steps of a batched stiff solve that are traced
STIFF_RTOL, STIFF_ATOL = 1e-8, 1e-10
# - phase 13, the conv ODE-Net.  Its field on the card against the CPU in
#   float64: the convolutions' and GroupNorm's reductions sum in other
#   orders, and the last GroupNorm divides by a group's spread: 1e-12 of
#   max|f| (CONV_F64_FIELD).  The solve: the same steps (Stats equal),
#   values within F64_VALUES.  The gradients of the three modes (the
#   continuous and the interpolated adjoint, the replay) and forward_grad's
#   jvp: the same rounding over the solves, GRAD_F64_REL.  The SciPy bridge
#   from a CUDA state: SciPy gets float64 evaluations that differ in their
#   last bits and takes the same steps, nfe equal and values within
#   CONV_F64_FIELD of max|y| of the CPU call's.
CONV_F64_FIELD = 1e-12
CONV_B, CONV_DIM, CONV_HW = 128, 64, 6   # bench.py:215-217: (128, 6, 6, 64)
CONV_TOL = 1e-3                          # bench.py:218, the example's --tol
CONV_CHECK_B = 4                         # the card-vs-CPU batch, float64
# JAX's count of bench.py's conv step on the host CPU backend
# (bench.py:300-330): field evaluations of the forward and of the backward
JAX_CONV_NFE = (32, 33)
CONV_STEPS = 12
# - phase 14, the per-sample driver (examples/ensemble.py and
#   benchmarks/bench_ensemble.py's "scalar" field, both at their defaults).
#   The ensemble against its closed form x(t) = exp(-t/20) (cos(w_d t) +
#   sin(w_d t) / (20 w_d)), w_d^2 = w^2 - 1/400: rtol 1e-6 over up to 700
#   steps of a float32 state, 2.1e-5 measured on the CPU at B=256; held to
#   ENS_EXACT.  Its event times within 5% of pi/(2w), the example's own
#   check (the damping moves the first zero).  The scalar field against its
#   closed form at rtol 1e-4 on |y| <= 1: 7.6e-5 measured on the CPU at
#   B=4096; held to SCALAR_EXACT.  The driver against K-dopri5 and K-events
#   (B3, B4): float32 values within F32_ADAPTIVE_VALUES and steps within
#   F32_ADAPTIVE_STEPS, as kernel against plain (the kernel keeps its time
#   and controller in the state dtype, the driver in float64); float64
#   counts equal on every lane away from an accept boundary, the share of
#   lanes that differ held to C7's dopri5 bound (DRIVER_FLIP_SHARE,
#   tests/test_torch_cuda.py), and values within F64_VALUES on the lanes
#   whose counts agree; event times there within ATOL, the driver's
#   bisection tolerance (it halves each sample's last step until the
#   bracket is under atol, as JAX's vmap route does; the kernel halves it
#   40 times).  The per-sample gradient card against CPU in
#   float64: GRAD_F64_REL.
ENS_B, ENS_RTOL, ENS_OMEGA_MAX = 1024, 1e-6, 60.0   # examples/ensemble.py
ENS_EXACT = 1e-3
ENS_EVENT_REL = 0.05
ENS_REPS = 1     # timed repetitions, few to keep the script in its limit
SCALAR_B, SCALAR_LAM_MAX = 65536, 300.0     # benchmarks/bench_ensemble.py
SCALAR_RTOL, SCALAR_ATOL = 1e-4, 1e-6
SCALAR_EXACT = 1e-3
DRIVER_FLIP_SHARE = 0.015
PS_GRAD_B = 8

# - phase 15, the per-sample stiff, implicit and 16-bit route.  (a) each
#   sample's error against the exact solution as phase 12c (STIFF_EXACT);
#   (b)-(e) float64 card against CPU as phase 12 (F64_VALUES, Stats equal,
#   GRAD_F64_REL); (f) the 16-bit kernels against their plain versions on
#   the CPU (the rounding the CPU tests hold to JAX's kernel): a 16-bit
#   error estimate and step size are coarse, so a last-bit difference (the
#   products' summation order, tanhf against the CPU's tanh) flips an
#   accept on some lanes, whose counts then differ (C7), or moves a step
#   size by a unit, after which the lane takes other steps of the same
#   count.  The share of lanes whose counts differ is held to
#   LANE16_FLIP_SHARE, and every other lane to LANE16_ULPS units in the
#   last place of max|y| of its dtype (32 bfloat16 units are 256 float16
#   ones: 2**-5 of max|y|'s binade), both from the largest readings on an
#   H100 (PERF.md §6): 1.76% of the lanes with other counts (the GPU
#   tests, float16, D=12), the others within 13.0 bfloat16 units (this
#   phase, B=65536) and 157.88 float16 units (the GPU tests, D=12).
PS_STIFF_B = 1024
VDP_B, VDP_CHECK_B, VDP_T = 1024, 8, 10.0
PS_IMPLICIT_B = 32
PS_FIXED_STEPS = 100
PS_OPT_B = 8
PS_GRAD_T = 0.005
LANE16_RTOL, LANE16_ATOL = 1e-2, 1e-2
LANE16_TS = np.linspace(0.0, 10.0, 5)
LANE16_FLIP_SHARE = 0.025
LANE16_ULPS = {"bf16": 32, "f16": 256}
PS_BUDGET_S = 60
# - phase 19, Parareal and the training loops.  With n_iters = S the
#   scheme's iterate is the slice-restarted fine chain exactly (finite
#   termination; the last correction adds F - G to the G of the same
#   state), so float64 values agree with the chain's to rounding: 1e-10 of
#   max|y| (PAR_VALUES).  The gradient is the linearised recursion's, which
#   terminates at the same iteration; each slice's continuous adjoint is
#   the chain's, solved in a batch, so rounding carried through S backward
#   solves: 1e-8 of max|g| (PAR_GRAD_REL).  The training loops run the same
#   operations on the same tensors as the steps by hand: bit for bit.
PAR_T, PAR_FAST_ITERS = 10, 3
PAR_VALUES = 1e-10
PAR_GRAD_REL = 1e-8
PAR_BUDGET_S = 90

# - phase 20, the device mesh.  (a) A world of one rank: the wrappers and
#   Parareal's mesh run the unsharded solve's operations on the same
#   tensors (the global norm of one shard is `rms_norm` bit for bit), so
#   bit for bit.  The sharded K-dopri5 route against its plain version: as
#   phase 6 (F32_ADAPTIVE_VALUES, F32_ADAPTIVE_STEPS).  (b) Two ranks on
#   the card: each sums its block's squares, so the global norm differs
#   from the one-rank sum in its last bits, and the same steps give float64
#   values within 1e-12 of max|y| (MESH_F64_REL; 1.5e-15 measured between 2
#   CPU ranks and one process on the tests' problem).
#   The same bound holds the decisions made global (kvaerno5's stage
#   solves, implicit_adams' corrector, an event's signs) on MESH_DEC_B
#   spirals, an event's time included (its bisection to atol 1e-12), and
#   Parareal's mesh gradient on MESH_PAR_B spirals, 2 slices a rank,
#   against mesh=None (the ranks' slices' parameter cotangents summed in
#   another order).
MESH_B, MESH_RANKS = 1024, 2
MESH_DEC_B, MESH_PAR_B = 64, 4
MESH_F64_REL = 1e-12
MESH_BUDGET_S = 45
MESH_PAR_REPS = 3        # --mesh-cards: timed Parareal steps

# - phase 21, the sharded training step (examples/sharded_step.py).  (a) A
#   world of one rank: the tensor-parallel field runs the MLPField's
#   operations, and every collective sums over one rank, so the step is
#   the unsharded one's bit for bit.  (b) Two ranks on the card: each
#   block's batch sums and each shard's partial products add in another
#   order than one process's, carried through a forward and a backward
#   solve with the same steps: float64 losses and gradients within 1e-12
#   of max|g| (STEP_F64_REL; 3.8e-16 measured between 4 CPU ranks and one
#   process on the dry run's problem), counters equal.  Across cards
#   (--mesh-cards) the float32 step is held to the JAX dry run's own
#   bounds against one device (examples/sharded_step.py LOSS_REL,
#   GRAD_REL).
STEP_RANKS = 2
STEP_F64_REL = 1e-12
STEP_TIMED = 5           # phase 21 (a)'s timed steps
STEP_BUDGET_S = 30

# - phase 21 (c), gradients through data_parallel_odeint's routes that run
#   their backward over each rank's block.  (a) A world of one rank: the
#   entry's copy of the replicated inputs and y0's rows are the identity,
#   and their backward collectives sum over one rank, so the fixed-grid
#   training step is the unsharded one's bit for bit.  (b) Two ranks on
#   the card: each block's field products and the parameter cotangents'
#   all-reduce add in another order than one process's: float64 gradients
#   within 1e-12 of max|g| (ROUTE_F64_REL; 2.9e-15 measured between 4 CPU
#   ranks and one process on the tests' problem), counters equal.
ROUTE_RANKS = 2
ROUTE_B = 64
ROUTE_F64_REL = 1e-12
ROUTE_TIMED = 8          # (a)'s timed pairs
ROUTE_BUDGET_S = 60

# the kernel instances at the widths the phases run (both dtypes of D=2,
# each per-trajectory kernel with and without lane groups, and K-fused at
# the bench's D): none may spill (phase 1)
SMOKE_INSTANCES = ("rk4<f,D=2>", "rk4<d,D=2>", "lanes<f,D=2>", "lanes<d,D=2>",
                   "lanes<f,D=2,group>", "lanes<d,D=2,group>", "events<f,D=2>",
                   "events<d,D=2>", "events<f,D=2,group>",
                   "events<d,D=2,group>", "lanes_wide<d>", "events_wide<d>",
                   "lanes<bf16,D=2>", "lanes<f16,D=2>", "lanes<bf16,D=2,group>",
                   "lanes<f16,D=2,group>", "events<bf16,D=2>",
                   "events<f16,D=2>", "events<bf16,D=2,group>",
                   "events<f16,D=2,group>",
                   "fused_step<f,D=256>", "fused_step<bf16,D=256>")

# Peak rates of one H100 SXM (NVIDIA's data sheet, dense, at 700 W), for
# each kernel's bound: the larger of its operations over the peak rate of
# their type and its bytes (each input read once, each output written once)
# over the memory rate.
PEAK_F32 = 67e12       # float32 FLOP/s outside the tensor cores
PEAK_F16 = 133.8e12    # float16/bfloat16 FLOP/s outside the tensor cores
#                        (NVIDIA's Hopper whitepaper: twice float32's)
PEAK_BF16 = 989e12     # bfloat16 FLOP/s of the tensor cores
PEAK_BYTES = 3.35e12   # HBM bytes/s


def _card():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def _spiral(torch, dtype, device):
    """The spiral field and states at full width (bench.py's init)."""
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    rng = np.random.RandomState(0)
    w1 = rng.randn(2, H) * 0.1
    w2 = rng.randn(H, 2) * 0.1
    y0 = rng.randn(BIG_B, 2)
    params = [dict(w=w1, b=np.zeros(H)), dict(w=w2, b=np.zeros(2))]
    npd = np.float32 if dtype == torch.float32 else np.float64
    params = [{k: v.astype(npd) for k, v in p.items()} for p in params]
    model = mlp_params_from_jax(params, power=3, device=device)
    model.requires_grad_(False)
    return model, torch.from_numpy(y0.astype(npd)).to(device)


def _ptxas_by_instance(log):
    """Registers and spill-store bytes of each kernel instance, from the
    `-Xptxas -v` lines of the kernels' build, by a short name
    (`rk4<f,D=2>`, `fused_step<bf16,D=256>`, ...)."""
    regs, spills, name = {}, {}, None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            name = _instance_name(m.group(1))
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spills[name] = max(spills.get(name, 0), int(m.group(1)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    return regs, spills


def _instance_name(mangled):
    """`lanes<f,D=2>`, `lanes<f,D=2,group>` for the instance of K-dopri5
    or K-events that runs lane groups (its `kGroup` template argument), and
    `lanes_wide<f>` for their shared-memory instances (any D, dopri8)."""
    types = r"(f|d|13__nv_bfloat16|N3tdt2LoI13__nv_bfloat16EE|N3tdt2LoI6__halfEE)"
    w = re.search(r"(lanes|events)_wide_kernelI" + types, mangled)
    if w:
        return f"{w.group(1)}_wide<{_type_name(w.group(2))}>"
    k = re.search(r"(rk4|lanes|events|fused_step)_kernelI" + types
                  + r"Li(\d+)E(Lb1E)?", mangled)
    if not k:
        return None
    kind, ty, d, group = k.groups()
    return (f"{kind}<{_type_name(ty)},D={d}"
            f"{',group' if group else ''}>")


def _type_name(mangled_type):
    """f, d, bf16 (a raw __nv_bfloat16, or tdt::Lo of one: the per-trajectory
    kernels' 16-bit instances) or f16 (tdt::Lo<__half>)."""
    if "bfloat" in mangled_type:
        return "bf16"
    return "f16" if "half" in mangled_type else mangled_type


def _sass_by_instance(build, so_path):
    """Whether each kernel instance's SASS (`cuobjdump -sass` of the built
    library; the tool sits beside nvcc) holds tensor-core instructions
    (HGMMA: wgmma; HMMA: mma.sync), asynchronous copies (UTMALDG: TMA;
    LDGSTS: cp.async) and warp syncs (WARPSYNC: what a shuffle whose mask
    is known only at run time costs)."""
    from pathlib import Path
    tool = str(Path(build._nvcc()).parent / "cuobjdump")
    out = subprocess.run([tool, "-sass", so_path], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    found, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            name = _instance_name(m.group(1))
            if name:
                found[name] = set()
            continue
        if name:
            for op in ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "WARPSYNC"):
                if re.search(rf"\b{op}\b", line):
                    found[name].add(op)
    return found


def _build_report(build):
    """Phase 1's evidence for the kernels: each instance's registers and
    spills, tensor-core instructions and asynchronous copies, and ptxas's
    notes on wgmma; fails unless every K-fused instance copies its weight
    tiles asynchronously and every bfloat16 one runs wgmma, and if an
    instance of `SMOKE_INSTANCES` spills or is missing."""
    log = build.build_info["log"]
    regs, spills = _ptxas_by_instance(log)
    sass = _sass_by_instance(build, build.build_info["path"])
    rows = []
    for name in sorted(sass):
        ops = sass[name]
        rows.append(f"{name} {regs.get(name)} regs spill {spills.get(name, 0)} B "
                    f"{'+'.join(sorted(ops)) or 'none of HGMMA/HMMA/UTMALDG/LDGSTS/WARPSYNC'}")
        if name.startswith("fused_step"):
            _check(ops & {"UTMALDG", "LDGSTS"},
                   f"{name}: no asynchronous copy in its SASS")
            if "bf16" in name:
                _check("HGMMA" in ops, f"{name}: no HGMMA in its SASS")
    for name in SMOKE_INSTANCES:
        _check(name in sass and name in regs,
               f"{name}: not found in the SASS or the ptxas log")
        _check(spills.get(name, 0) == 0,
               f"{name} spills {spills[name]} B: its phase would run it")
    spilled = sorted(n for n, b in spills.items() if b)
    serial = [ln.strip() for ln in log.splitlines() if "wgmma" in ln.lower()]
    return (f"{len(regs)} instances, {len(spilled)} spill {spilled}, ptxas "
            f"wgmma notes {serial[:2]} | " + "; ".join(rows))


def _time_ms(torch, fn, reps):
    """Mean milliseconds per call by CUDA events, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(torch, fn, reps):
    """Device milliseconds per call of `fn`, which launches one kernel and
    no other device work: CUDA events around `reps` calls queued behind
    `torch.cuda._sleep`, so that the host has queued them all before the
    first runs and no host time falls inside the window.  The sleep is sized from the host's queueing time, and the
    window counts only if the sleep was still running when the last call was
    queued (otherwise it is taken again with a longer sleep)."""
    fn()
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    for _ in range(reps):
        fn()
    queue_ms = (time.perf_counter() - w0) * 1e3
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    torch.cuda._sleep(1_000_000)
    end.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e6 / start.elapsed_time(end)
    sleep_ms = 4 * queue_ms + 1.0
    for _ in range(4):
        torch.cuda._sleep(int(cycles_per_ms * sleep_ms))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        in_time = not start.query()
        torch.cuda.synchronize()
        if in_time:
            return start.elapsed_time(end) / reps
        sleep_ms *= 4
    raise AssertionError("the launches were not all queued within the sleep")


def _three_times(torch, wrapped, bare, plain, group):
    """A per-trajectory kernel's times at one batch: through its wrapper,
    as a bare launch, on the device alone (`_device_ms`), and its plain
    version's; with the group width the launch runs."""
    return dict(group_width=group, ms=_time_ms(torch, wrapped, 20),
                bare_ms=_time_ms(torch, bare, 20),
                device_ms=_device_ms(torch, bare, 20),
                plain_ms=_time_ms(torch, plain, 1))


def _times_row(b, t):
    return (f"B={b}: group width L={t['group_width']}, kernel through the "
            f"wrapper {t['ms']:.4f} ms, bare launch {t['bare_ms']:.4f} ms, "
            f"device {t['device_ms']:.4f} ms, plain {t['plain_ms']:.3f} ms")


def _times_entry(times):
    """The JSON entry's times: B=1024's under their names, B=65536's with
    the suffix _65536."""
    entry = dict(times[B])
    entry.update({f"{k}_65536": v for k, v in times[BIG_B].items()})
    return entry


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def _dopri8_vs_plain(name, values, want_values, counts, want_counts):
    """dopri8 in a per-lane kernel against its plain version in float64:
    the share of lanes whose counts differ and the max |d| of the values,
    each within its bound (DOPRI8_FLIP_SHARE, DOPRI8_VALUES)."""
    flips = None
    for g, w in zip(counts, want_counts):
        f = g != w
        flips = f if flips is None else flips | f
    share = float(flips.float().mean())
    err = max(float((g - w).abs().max()) for g, w in zip(values, want_values))
    _check(share <= DOPRI8_FLIP_SHARE and err <= DOPRI8_VALUES,
           f"{name} dopri8 float64: lanes whose counts differ {share}, "
           f"max|d|={err}")
    return dict(dopri8_max_abs_err=err, dopri8_count_flip_share=share)


def _bound(flops, nbytes, peak):
    """(bound_ms, bound_by): the least time the card could take for
    `flops` operations at `peak` and `nbytes` of traffic; `flops` may be a
    list of (operations, peak) pairs of several types, whose times add."""
    if isinstance(flops, list):
        t_ops = sum(n / p for n, p in flops)
    else:
        t_ops = flops / peak
    t_bytes = nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def _mlp_flops(D, H, power):
    """Operations of one evaluation of tanh(y**p @ W1 + b1) @ W2 + b2 on one
    trajectory: the input power, a multiply and an add per weight (the
    biases included), tanh counted as none."""
    return D * (power - 1) + 4 * D * H


def _rk4_bound(b):
    """K-rk4's bound at a batch of b (phase 5's solve)."""
    return _bound(b * RK4_STEPS * (4 * _mlp_flops(2, H, 3) + 15 * 2),
                  2 * b * 2 * 4 + (4 * H + H + 2) * 4, PEAK_F32)


def _events_bound(n_steps, b):
    """K-events' bound over a run's per-lane step counts, plus 40 bisection
    steps of a quartic (8 operations a row) and K=2 events; y0 and sign0
    read, event_t, y_event and three counters a lane written."""
    from torchdiffeq_tpu_torch.ops.tableaus import DOPRI5
    return _bound(_lane_flops(n_steps, DOPRI5, 2, H, 3)
                  + 40 * b * (8 * 2 + 2 * (2 * 2 + 3)),
                  (2 + 2) * b * 4 + (1 + 2 + 3) * b * 4, PEAK_F32)


def _lane_flops(n_steps, tableau, D, H, power, extra_evals=2, split=False):
    """Operations of the per-lane solves over their lanes' step counts:
    each step evaluates the field once per stage after the first (FSAL),
    forms the stage, error and controller sums (a multiply and an add per
    nonzero coefficient and state row, about 12 per row for the error ratio
    and the controller); each lane also evaluates f(y0) and the initial
    step's probe.  With `split`, (the operations in the state dtype, those
    in float) for a 16-bit lane: the two products' multiply-adds but the
    H hidden bias adds, and the norm's sum (one add a row), accumulate in
    float; the rest rounds to the state dtype."""
    n = int(n_steps.sum())
    lanes = n_steps.numel()
    terms = int(np.count_nonzero(tableau.beta)) + int(
        np.count_nonzero(tableau.c_error))
    evals = (tableau.n_stages - 1) * n + extra_evals * lanes
    total = evals * _mlp_flops(D, H, power) + n * (2 * D * terms + 12 * D)
    if not split:
        return total
    wide = evals * (4 * D * H - H) + n * D
    return total - wide, wide


def _fused_flops(B, D, H, tableau):
    """Operations of one fused step: each field evaluation's two products
    and bias adds (tanh counted as none), and every stage, output, error and
    midpoint sum (a multiply and an add per nonzero coefficient)."""
    n_eval = tableau.n_stages - 1 + (0 if tableau.is_fsal else 1)
    terms = sum(int(np.count_nonzero(v)) for v in (
        tableau.beta, tableau.c_sol, tableau.c_error, tableau.c_mid))
    return n_eval * B * (4 * D * H + H + D) + 2 * B * D * terms


def _fused_vs_plain(fused_field, params, y0, f0, dt32, tableau, name):
    """One step of K-fused against its plain version on the same tensors,
    each output held to `fused_field.kernel_bounds`; returns the max |d| of
    (y1, f1, y1_err, dmid), the share of elements that differ, the worst
    share of a bound, the y1_err bound and the medians of |y1_err| and of
    |d y1_err|."""
    field = fused_field.mlp_field
    got = fused_field.fused_stage_step(field, params, y0, f0, 0.0, dt32,
                                       tableau)
    want = fused_field.fused_stage_step_ref(field, params, y0, f0, 0.0, dt32,
                                            tableau)
    bounds = fused_field.kernel_bounds(want, params[2], dt32, tableau)
    errs, differ, worst = [], [], 0.0
    for g, w, bound in zip(got, want, bounds):
        d = (g.float() - w.float()).abs()
        errs.append(float(d.max()))
        differ.append(float((d != 0).float().mean()))
        worst = max(worst, float((d / bound).max()))
    _check(worst <= 1.0 and all(g.dtype == w.dtype for g, w in zip(got, want)),
           f"K-fused {name} vs plain at dt={dt32}: max|d| (y1, f1, err, dmid) "
           f"= {errs}, worst share of the bound {worst}")
    return dict(errs=errs, differ=differ, worst=worst, err_bound=bounds[2],
                median_err=float(want[2].abs().median()),
                median_d_err=float((got[2] - want[2]).abs().median()))


def _phase_fused(torch, fused_field, kernels, tableau, dev):
    """Phase 9: the fused-step chain of bench_fused_field.py on the card;
    returns the kernel's summary entry."""
    from torchdiffeq_tpu_torch.ops.rk_step import runge_kutta_step
    rng = np.random.RandomState(1)
    w1 = (rng.randn(FD, FH) * 0.05).astype(np.float32)
    w2 = (rng.randn(FH, FD) * 0.05).astype(np.float32)
    y0_np = rng.randn(FB, FD).astype(np.float32)
    step = fused_field.fused_stage_step
    step_ref = fused_field.fused_stage_step_ref
    field = fused_field.mlp_field
    dt32 = np.float32(FUSED_DT)
    inputs = {}
    for dtype in (torch.float32, torch.bfloat16):
        params = tuple(torch.from_numpy(a).to(dev).to(dtype) for a in
                       (w1, np.zeros(FH, np.float32), w2,
                        np.zeros(FD, np.float32)))
        y0 = torch.from_numpy(y0_np).to(dev).to(dtype)
        inputs[dtype] = (params, y0, field(0.0, y0, *params))

    def stock_step(params, y, f, t0):
        func = lambda t, yy, perturb=None: field(t, yy, *params)
        return runge_kutta_step(func, y, f, t0, dt32, t0 + dt32, tableau,
                                error_dtype=torch.float32)

    def chain(one_step, params, y, f):
        for i in range(FUSED_STEPS):
            y, f = one_step(params, y, f, np.float32(i) * dt32)[:2]
        return y

    # the path: the two chains of fused steps, counted
    with torch.no_grad():
        kernels.reset_launch_counts()
        ends = {dt_: chain(lambda p, y, f, t0: step(field, p, y, f, t0, dt32,
                                                     tableau), *inputs[dt_])
                for dt_ in inputs}
        torch.cuda.synchronize()
        launches = kernels.launch_counts["fused_stage_step"]
        _check(launches == 2 * FUSED_STEPS,
               f"fused_stage_step launched {launches} times on the chains, "
               f"not {2 * FUSED_STEPS}")
        stock_ends = {dt_: chain(stock_step, *inputs[dt_]) for dt_ in inputs}

        rows, entry = [], None
        for dtype, params_y0_f0 in inputs.items():
            params, y0, f0 = params_y0_f0
            name = "float32" if dtype == torch.float32 else "bfloat16"
            ye, ys = ends[dtype], stock_ends[dtype]
            _check(ye.shape == (FB, FD) and ye.dtype == dtype
                   and bool(torch.isfinite(ye).all())
                   and bool(torch.isfinite(ys).all()),
                   f"fused chain {name}: not finite or of the wrong shape")
            s_fused = float(ye.float().abs().sum())
            s_stock = float(ys.float().abs().sum())
            rel = abs(s_fused - s_stock) / s_stock
            if dtype == torch.float32:
                _check(rel <= CHAIN_F32_REL, f"fused vs stock chain {name}: "
                       f"sum|y| {s_fused} vs {s_stock}")
            chain_row = (f"sum|y| fused {s_fused:.7g} vs stock {s_stock:.7g} "
                         f"(rel {rel:.2e}"
                         + (f" <= {CHAIN_F32_REL})" if dtype == torch.float32
                            else f", end states equal in "
                            f"{float((ye == ys).float().mean()):.3%})"))

            # one step at the bench's dt, kernel against plain version
            one = _fused_vs_plain(fused_field, params, y0, f0, dt32, tableau,
                                  name)
            errs, differ = one["errs"], one["differ"]
            if dtype == torch.float32:
                # and one at a dt where y1_err is truncation
                trunc = _fused_vs_plain(fused_field, params, y0, f0,
                                        np.float32(FUSED_TRUNC_DT), tableau,
                                        name)
                _check(trunc["err_bound"]
                       <= ERR_MEDIAN_SHARE * trunc["median_err"],
                       f"K-fused {name} at dt={FUSED_TRUNC_DT}: y1_err bound "
                       f"{trunc['err_bound']} is over {ERR_MEDIAN_SHARE} of "
                       f"the median |y1_err| {trunc['median_err']}")
                err_row = (
                    f"at dt={FUSED_TRUNC_DT}: median|y1_err| "
                    f"{trunc['median_err']:.2e}, its bound "
                    f"{trunc['err_bound']:.2e} (<= {ERR_MEDIAN_SHARE} of it), "
                    f"max|d| y1 {trunc['errs'][0]:.2e} f1 "
                    f"{trunc['errs'][1]:.2e} err {trunc['errs'][2]:.2e} dmid "
                    f"{trunc['errs'][3]:.2e} (worst {trunc['worst']:.2f} of "
                    "the bound)")
            else:
                _check(one["median_d_err"]
                       <= ERR_MEDIAN_SHARE * one["median_err"],
                       f"K-fused {name}: median |d y1_err| "
                       f"{one['median_d_err']} is over {ERR_MEDIAN_SHARE} of "
                       f"the median |y1_err| {one['median_err']}")
                err_row = (f"median|d y1_err| {one['median_d_err']:.2e} vs "
                           f"median|y1_err| {one['median_err']:.2e} (<= "
                           f"{ERR_MEDIAN_SHARE} of it)")

            ms = _time_ms(torch, lambda: step(field, params, y0, f0, 0.0,
                                              dt32, tableau), 20)
            plain_ms = _time_ms(torch, lambda: step_ref(
                field, params, y0, f0, 0.0, dt32, tableau), 10)
            stock_ms = _time_ms(torch, lambda: stock_step(params, y0, f0,
                                                          0.0), 20)
            # the kernel alone: its launch, without the wrapper's checks,
            # coefficient packing and allocations
            bare, _ = fused_field._kernel_launch(field, params, y0, f0, dt32,
                                                 tableau)
            bare_ms = _time_ms(torch, bare, 50)
            plan = fused_field.fused_plan(dtype, FD, FH, FB)
            flops = _fused_flops(FB, FD, FH, tableau)
            n_eval = tableau.n_stages - 1 + (0 if tableau.is_fsal else 1)
            nbytes = ((2 * FB * FD + 2 * FD * FH + FH + FD) * y0.element_size()
                      + 2 * FB * FD * y0.element_size() + 2 * FB * FD * 4)
            bound_ms, bound_by = _bound(
                flops, nbytes,
                PEAK_F32 if dtype == torch.float32 else PEAK_BF16)
            rows.append(
                f"{name}: {chain_row}; one step max|d| y1 "
                f"{errs[0]:.2e} f1 {errs[1]:.2e} err {errs[2]:.2e} dmid "
                f"{errs[3]:.2e} (worst {one['worst']:.2f} of the bound), "
                f"elements that differ y1 {differ[0]:.3%} f1 {differ[1]:.3%} "
                f"err {differ[2]:.3%}; {err_row}; per step: "
                f"kernel {ms:.3f} ms ({flops / ms / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / ms:.1%} of the bound), kernel alone "
                f"{bare_ms:.3f} ms ({flops / bare_ms / 1e9:.1f} TFLOP/s, "
                f"{bound_ms / bare_ms:.1%} of the bound), plain "
                f"{plain_ms:.3f} ms, stock step {stock_ms:.3f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}); {plan['instance']} "
                f"{plan['blocks']} blocks x {plan['threads']}, "
                f"{plan['shared_bytes']} B shared, ring of {plan['ring']} "
                f"tiles, cluster {plan['cluster']}, weights streamed "
                f"{n_eval * plan['weight_bytes_per_eval'] / 2 ** 20:.0f} MiB "
                f"a step ({n_eval * plan['weight_bytes_per_eval'] / bare_ms / 1e9:.2f}"
                f" TB/s in the kernel alone)")
            numbers = dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                           bound_ms=bound_ms, bound_by=bound_by,
                           stock_ms=stock_ms, kernel_alone_ms=bare_ms)
            if entry is None:
                entry = dict(
                    name="fused_stage_step", route="cuda",
                    source="torchdiffeq_tpu_torch/csrc/fused_step.cu",
                    replaces="benchmarks/fused_field.py:69",
                    launches=launches, dtype=name, **numbers,
                    library_ms=None)
            else:
                entry[name] = numbers
    torch.cuda.synchronize()
    print(f"[9 K-fused] bench chain B={FB} D={FD} H={FH} dopri5 dt="
          f"{FUSED_DT}, {FUSED_STEPS} steps; launches {launches} | "
          + " | ".join(rows))
    return entry


def _bench_init(npd):
    """bench.py's `make_shared_init` (the JAX bench's weights, y0 and
    target from RandomState(0), drawn in float32), in the dtype `npd`."""
    rng = np.random.RandomState(0)
    w1 = (rng.randn(2, H) * 0.1).astype(np.float32)
    w2 = (rng.randn(H, 2) * 0.1).astype(np.float32)
    y0 = rng.randn(B, 2).astype(np.float32)
    target = rng.randn(B, 2).astype(np.float32)
    params = [dict(w=w1, b=np.zeros(H, np.float32)),
              dict(w=w2, b=np.zeros(2, np.float32))]
    params = [{k: v.astype(npd) for k, v in layer.items()} for layer in params]
    return params, y0.astype(npd), target.astype(npd)


def _train_setup(torch, npd, device):
    """The training step's model (parameters requiring grad), y0, target
    and output times on `device`."""
    from torchdiffeq_tpu_torch.models import mlp_params_from_jax
    params, y0, target = _bench_init(npd)
    model = mlp_params_from_jax(params, power=3, device=device)
    t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    return (model, torch.from_numpy(y0).to(device),
            torch.from_numpy(target).to(device), t)


def _train_step(torch, model, y0, target, t, marks=None):
    """One step of bench.py's training loop: the adjoint solve, the loss
    mean((ys - target)**2), its backward and p -= 1e-3 * grad.  `marks`,
    four CUDA events, are recorded before the solve, after the loss, after
    the backward and after the update.  Returns (loss, the gradients)."""
    from torchdiffeq_tpu_torch import odeint_adjoint
    if marks:
        marks[0].record()
    ys = odeint_adjoint(model, y0, t, rtol=RTOL, atol=ATOL, method="dopri5")
    loss = ((ys - target[None]) ** 2).mean()
    if marks:
        marks[1].record()
    loss.backward()
    if marks:
        marks[2].record()
    grads = []
    with torch.no_grad():
        for p in model.parameters():
            grads.append(p.grad)
            p -= 1e-3 * p.grad
            p.grad = None
    if marks:
        marks[3].record()
    return loss.detach(), grads


class _BackwardStats:
    """While active, records the `Stats` of the backward pass's solves
    (each call of the adjoint's `_raw_odeint`)."""

    def __init__(self):
        from torchdiffeq_tpu_torch import adjoint
        self.module = adjoint
        self.stats = []

    def __enter__(self):
        self.raw = raw = self.module._raw_odeint

        def recorded(*a, **k):
            ys, st = raw(*a, **k)
            self.stats.append(st)
            return ys, st
        self.module._raw_odeint = recorded
        return self

    def __exit__(self, *exc):
        self.module._raw_odeint = self.raw

    def counters(self):
        return [[int(x) for x in st[:5]] for st in self.stats]


def _max_rel(got, want):
    """max over tensors of max|got - want| / max|want|, on the CPU in
    float64."""
    return max(float((g.double().cpu() - w.double().cpu()).abs().max()
                     / w.double().cpu().abs().max()) for g, w in zip(got, want))


def _profiled_step(torch, step, by_name=None, host=True):
    """One call of `step` under torch.profiler: (device time of its CUDA
    kernels in ms, their count, the step's wall ms), or None for the first
    two when the trace holds no device time.  With `by_name` (a dict), it
    also gets each kernel name's device ms.  ``host=False`` traces the
    device alone (a trace of the host's ~10^5 small operations of phase
    18's adjoint step took longer than 40 s on the H100's host, run BB)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host else [])
    with profile(activities=acts) as prof:
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - w0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    kernels_ = [e for e in prof.events() if e.device_type == cuda]
    if not kernels_:
        return None, None, wall_ms
    if by_name is not None:
        for e in kernels_:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels_) / 1e3
    return busy_ms, len(kernels_), wall_ms


def _event_grads(torch, device, **solve):
    """`odeint_event` on the training step's model and batch in float64: a
    threshold on the batch mean of y[:, 0] halfway between its values at
    t=0 and t=4/9, and a cut-off at EVENT_CUT; the gradients of event_t +
    mean(y(event_t)**2) in the parameters.  `solve` replaces the dopri5
    settings of the event solve (phase 11's fixed grid).  Returns
    (event_t, gradients)."""
    from torchdiffeq_tpu_torch import odeint, odeint_event
    model, y0, _, t = _train_setup(torch, np.float64, device)
    with torch.no_grad():
        means = odeint(model, y0, t, rtol=RTOL, atol=ATOL)[:, :, 0].mean(1)
    thr = float((means[0] + means[4]) / 2)

    def event_fn(tt, yy):
        return torch.stack([yy[:, 0].mean() - thr,
                            (tt - EVENT_CUT).to(yy.dtype)])

    et, sol = odeint_event(model, y0, 0.0, event_fn=event_fn,
                           **(solve or dict(rtol=RTOL, atol=ATOL)))
    (et + (sol[-1] ** 2).mean()).backward()
    return float(et.detach()), [p.grad for p in model.parameters()]


def _phase_train(torch, kernels, dev):
    """Phase 10: the training step of bench.py on the card."""
    from torchdiffeq_tpu_torch import odeint_with_stats

    # the path: LOSS_STEPS steps in float32 on the card, counted
    model, y0, target, t = _train_setup(torch, np.float32, dev)
    kernels.reset_launch_counts()
    losses, first_grads = [], None
    for i in range(LOSS_STEPS):
        loss, grads = _train_step(torch, model, y0, target, t)
        first_grads = first_grads or [g.clone() for g in grads]
        losses.append(float(loss))
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0]
           and all(bool(torch.isfinite(g).all()) for g in first_grads),
           f"training step: losses {losses}")

    # the first step's gradients against the same step on the CPU in
    # float64, and the float64 step on the card against the CPU: forward and
    # backward counters equal, gradients within GRAD_F64_REL
    runs = {}
    for device in ("cpu", dev):
        m64, y64, tg64, _ = _train_setup(torch, np.float64, device)
        with torch.no_grad():
            _, st_f = odeint_with_stats(m64, y64, t, rtol=RTOL, atol=ATOL)
        with _BackwardStats() as bwd:
            _, g64 = _train_step(torch, m64, y64, tg64, t)
        runs[str(device)] = ([int(x) for x in st_f[:5]], bwd.counters(), g64)
    (f_cpu, b_cpu, g_cpu), (f_gpu, b_gpu, g_gpu) = runs["cpu"], runs[str(dev)]
    rel32 = _max_rel(first_grads, g_cpu)
    rel64 = _max_rel(g_gpu, g_cpu)
    _check(rel32 <= GRAD_F32_REL, f"training step float32 gradients vs CPU "
           f"float64: {rel32} of max|g|")
    _check(f_gpu == f_cpu and b_gpu == b_cpu and rel64 <= GRAD_F64_REL,
           f"training step float64 card vs CPU: forward {f_gpu} vs {f_cpu}, "
           f"backward {b_gpu} vs {b_cpu}, gradients {rel64} of max|g|")

    # one odeint_event gradient, float64, card against CPU
    et_gpu, ge_gpu = _event_grads(torch, dev)
    et_cpu, ge_cpu = _event_grads(torch, "cpu")
    rel_ev = _max_rel(ge_gpu, ge_cpu)
    _check(abs(et_gpu - et_cpu) <= F64_VALUES and rel_ev <= GRAD_F64_REL
           and 0.0 < et_gpu < EVENT_CUT,
           f"odeint_event gradient card vs CPU: event_t {et_gpu} vs "
           f"{et_cpu}, gradients {rel_ev} of max|g|")

    # the warm step's time, forward and backward, float32
    with torch.no_grad():
        _, st32 = odeint_with_stats(model, y0, t, rtol=RTOL, atol=ATOL)
    times = []
    with _BackwardStats() as bwd32:
        for _ in range(TRAIN_STEPS):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            _train_step(torch, model, y0, target, t, marks)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
            times.append((marks[0].elapsed_time(marks[3]),
                          marks[0].elapsed_time(marks[1]),
                          marks[1].elapsed_time(marks[2]), wall))
    bwd_st = bwd32.stats[-1]
    step_ms, fwd_ms, bwd_ms, wall_ms = (np.array(c) for c in zip(*times))
    busy_ms, n_launch, prof_wall = _profiled_step(
        torch, lambda: _train_step(torch, model, y0, target, t))
    nfe = int(st32.nfe) + int(bwd_st.nfe)
    med = float(np.median(step_ms))
    busy = ("not measured (no device time in the trace)" if busy_ms is None
            else f"{busy_ms:.3f} ms of device time in {n_launch} kernels, "
            f"{busy_ms / med:.1%} of the median step ({busy_ms / prof_wall:.1%}"
            f" of the traced step's {prof_wall:.1f} ms)")
    print(f"[10 training step] bench.py's step B={B} H={H} T={T} dopri5 "
          f"rtol={RTOL} atol={ATOL} float32, odeint_adjoint + SGD lr 1e-3; "
          f"kernel launches {launches} (the step runs none) | loss over "
          f"{LOSS_STEPS} steps {losses[0]:.7f} -> {losses[-1]:.7f} | "
          f"gradients vs CPU float64: float32 {rel32:.2e} of max|g| (<= "
          f"{GRAD_F32_REL}), float64 {rel64:.2e} (<= {GRAD_F64_REL}); float64 "
          f"counters forward {f_gpu}, backward {b_gpu} == CPU | odeint_event "
          f"gradient float64 vs CPU {rel_ev:.2e} of max|g| (event_t "
          f"{et_gpu:.9f}) | warm step over {TRAIN_STEPS}: median "
          f"{med:.2f} ms (min {step_ms.min():.2f}, max {step_ms.max():.2f}); "
          f"forward {np.median(fwd_ms):.2f} ms ({fwd_ms.min():.2f}.."
          f"{fwd_ms.max():.2f}), backward {np.median(bwd_ms):.2f} ms "
          f"({bwd_ms.min():.2f}..{bwd_ms.max():.2f}), host wall median "
          f"{np.median(wall_ms):.2f} ms | forward steps {st32.n_steps} nfe "
          f"{st32.nfe}, backward steps {bwd_st.n_steps} nfe {bwd_st.nfe} | "
          f"{nfe * B / (med / 1e3):.4g} VF evals/s | device busy: {busy}")
    return med


FIXED = ("euler", "midpoint", "heun2", "heun3", "rk4")


def _fixed_step(torch, model, y0, target, t, options, marks=None,
                solve=None):
    """One step of bench.py's training loop on the fixed grid: `odeint`
    (or `solve`, an odeint-like) with rk4 and `options`, backpropagated
    through the loop, loss and SGD as `_train_step`.  Returns (loss, the
    gradients)."""
    from torchdiffeq_tpu_torch import odeint
    if marks:
        marks[0].record()
    ys = (solve or odeint)(model, y0, t, method="rk4", options=options)
    loss = ((ys - target[None]) ** 2).mean()
    if marks:
        marks[1].record()
    loss.backward()
    if marks:
        marks[2].record()
    grads = []
    with torch.no_grad():
        for p in model.parameters():
            grads.append(p.grad)
            p -= 1e-3 * p.grad
            p.grad = None
    if marks:
        marks[3].record()
    return loss.detach(), grads


def _fixed_grads(torch, device, npd, options):
    """The fixed-grid step's gradients from a fresh model, and on the card
    the step's own peak of allocated memory: the peak during the step less
    what was allocated before it (the model, the batch and what earlier
    phases hold)."""
    model, y0, target, t = _train_setup(torch, npd, device)
    if device != "cpu":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
    _, grads = _fixed_step(torch, model, y0, target, t, options)
    peak = None
    if device != "cpu":
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - base
    return [g.clone() for g in grads], peak


def _fixed_adjoint_grads(torch, device):
    """`odeint_adjoint` with rk4 forward (num_steps) and backward
    (step_size), float64: the gradients of the training loss."""
    from torchdiffeq_tpu_torch import odeint_adjoint
    model, y0, target, t = _train_setup(torch, np.float64, device)
    ys = odeint_adjoint(model, y0, t, method="rk4",
                        options=dict(num_steps=FIXED_STEPS),
                        adjoint_options=dict(step_size=1.0 / FIXED_STEPS))
    ((ys - target[None]) ** 2).mean().backward()
    return [p.grad for p in model.parameters()]


def _phase_fixed(torch, kernels, dev):
    """Phase 11: the fixed-grid tier, the controllers, a bfloat16 state and
    the callbacks on the training step's model and batch (bench.py's
    `make_shared_init`)."""
    from torchdiffeq_tpu_torch import odeint, odeint_with_stats
    opts = dict(num_steps=FIXED_STEPS)

    # 1. every fixed method (and rk4 cubic, rk4 perturbed), float64, card
    # against the CPU: values within F64_VALUES, Stats equal
    calls = [(m, {}) for m in FIXED] + [("rk4", dict(interp="cubic")),
                                         ("rk4", dict(perturb=True))]
    worst = 0.0
    for method, extra in calls:
        out = {}
        for device in ("cpu", dev):
            model, y0, _, t = _train_setup(torch, np.float64, device)
            with torch.no_grad():
                ys, st = odeint_with_stats(model, y0, t, method=method,
                                           options=dict(opts, **extra))
            out[str(device)] = ys.cpu(), list(st[:5])
        (ys_c, st_c), (ys_g, st_g) = out["cpu"], out[str(dev)]
        err = float((ys_g - ys_c).abs().max())
        worst = max(worst, err)
        _check(st_g == st_c and err <= F64_VALUES
               and bool(torch.isfinite(ys_g).all()),
               f"fixed grid {method} {extra} float64 card vs CPU: max|dy|="
               f"{err}, stats {st_g} vs {st_c}")

    # 2. the rk4 kernel route beside its loop: launches counted, float32
    model, y0, target, t = _train_setup(torch, np.float32, dev)
    with torch.no_grad():
        kernels.reset_launch_counts()
        ys_route = odeint(model, y0, t, method="rk4",
                          options=dict(opts, pallas=True))
        torch.cuda.synchronize()
        route_launches = kernels.launch_counts["rk4_integrate"]
        ys_loop = odeint(model, y0, t, method="rk4", options=opts)
        t_odd = torch.tensor([0.0, 0.3, 1.0], dtype=torch.float64)
        kernels.reset_launch_counts()
        ys_odd = odeint(model, y0, t_odd, method="rk4",
                        options=dict(opts, pallas=True))
        torch.cuda.synchronize()
        odd_launches = kernels.launch_counts["rk4_integrate"]
    err_route = float((ys_route - ys_loop).abs().max())
    _check(route_launches == 1 and odd_launches == 0
           and err_route <= F32_RK4_LOOP
           and bool(torch.isfinite(ys_odd).all()),
           f"rk4 route: launches {route_launches} (qualifying), "
           f"{odd_launches} (non-uniform t), max|route - loop|={err_route}")

    # 3. the fixed-grid training step: gradients against the CPU, remat
    g32, _ = _fixed_grads(torch, dev, np.float32, opts)
    g64, peak = _fixed_grads(torch, dev, np.float64, opts)
    g64_cpu, _ = _fixed_grads(torch, "cpu", np.float64, opts)
    g32_remat, peak_remat32 = _fixed_grads(torch, dev, np.float32,
                                           dict(opts, remat=True))
    _, peak32 = _fixed_grads(torch, dev, np.float32, opts)
    rel32, rel64 = _max_rel(g32, g64_cpu), _max_rel(g64, g64_cpu)
    remat_same = all(torch.equal(a, b) for a, b in zip(g32_remat, g32))
    _check(rel32 <= GRAD_F32_REL and rel64 <= GRAD_F64_REL and remat_same,
           f"fixed-grid step gradients vs CPU float64: float32 {rel32}, "
           f"float64 {rel64} of max|g|; remat bit for bit {remat_same}")
    kernels.reset_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        loss, _ = _fixed_step(torch, model, y0, target, t, opts, marks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
        losses.append(float(loss))
        times.append((marks[0].elapsed_time(marks[3]),
                      marks[0].elapsed_time(marks[1]),
                      marks[1].elapsed_time(marks[2]), wall))
    step_launches = dict(kernels.launch_counts)
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"fixed-grid training step: losses {losses}")
    step_ms, fwd_ms, bwd_ms, wall_ms = (np.array(c) for c in zip(*times))
    busy_ms, n_launch, prof_wall = _profiled_step(
        torch, lambda: _fixed_step(torch, model, y0, target, t, opts))
    med = float(np.median(step_ms))
    busy = ("not measured (no device time in the trace)" if busy_ms is None
            else f"{busy_ms:.3f} ms of device time in {n_launch} kernels, "
            f"{busy_ms / med:.1%} of the median step ({busy_ms / prof_wall:.1%}"
            f" of the traced step's {prof_wall:.1f} ms)")

    # 4. odeint_adjoint with rk4 forward and backward, float64
    ga, ga_cpu = (_fixed_adjoint_grads(torch, d) for d in (dev, "cpu"))
    rel_adj = _max_rel(ga, ga_cpu)
    _check(rel_adj <= GRAD_F64_REL,
           f"fixed-grid odeint_adjoint float64 card vs CPU: {rel_adj}")

    # 5. a fixed-grid event (phase 7's event function), float64
    ev = dict(method="rk4", options=dict(step_size=FIXED_EVENT_STEP))
    et_gpu, ge_gpu = _event_grads(torch, dev, **ev)
    et_cpu, ge_cpu = _event_grads(torch, "cpu", **ev)
    rel_ev = _max_rel(ge_gpu, ge_cpu)
    _check(abs(et_gpu - et_cpu) <= F64_VALUES and rel_ev <= GRAD_F64_REL
           and 0.0 < et_gpu < EVENT_CUT,
           f"fixed-grid odeint_event card vs CPU: event_t {et_gpu} vs "
           f"{et_cpu}, gradients {rel_ev} of max|g|")

    # 6. the PI and PID controllers on the main path, float64
    ctl = {}
    for name, copts in (("pi", dict(controller="pi")),
                        ("pid", dict(controller="pid", dcoeff=0.2))):
        sts = []
        for device in ("cpu", dev):
            m, yb, _, _ = _train_setup(torch, np.float64, device)
            with torch.no_grad():
                _, st = odeint_with_stats(m, yb, t, rtol=RTOL, atol=ATOL,
                                          options=copts)
            sts.append(list(st[:5]))
        _check(sts[0] == sts[1] and sts[1][4] == 0,
               f"controller {name} float64 card vs CPU: {sts[1]} vs {sts[0]}")
        ctl[name] = sts[1]

    # 7. a bfloat16 state (and field) with float32 error control against
    # float32
    mf, yf, _, _ = _train_setup(torch, np.float32, dev)
    mb = _train_setup(torch, np.float32, dev)[0].to(torch.bfloat16)
    with torch.no_grad():
        ys_f, st_f = odeint_with_stats(mf, yf, t, rtol=BF16_RTOL,
                                       atol=BF16_ATOL)
        ys_b, st_b = odeint_with_stats(
            mb, yf.bfloat16(), t, rtol=BF16_RTOL, atol=BF16_ATOL,
            options=dict(error_dtype=torch.float32))
    err_b = float((ys_b.float() - ys_f).abs().max() / ys_f.abs().max())
    _check(ys_b.dtype == torch.bfloat16 and st_b.error_code == 0
           and err_b <= BF16_VALUES
           and st_b.n_steps <= BF16_STEPS * st_f.n_steps,
           f"bfloat16 + error_dtype: {err_b} of max|y|, steps {st_b.n_steps} "
           f"vs float32 {st_f.n_steps}")

    # 8. the callbacks on the main path, float32
    class Counting(torch.nn.Module):
        def __init__(self, field):
            super().__init__()
            self.field, self.n = field, dict(step=0, accept=0, reject=0)

        def forward(self, tt, yy):
            return self.field(tt, yy)

        def callback_step(self, t0, y, dt):
            self.n["step"] += 1

        def callback_accept_step(self, t0, y, dt):
            self.n["accept"] += 1

        def callback_reject_step(self, t0, y, dt):
            self.n["reject"] += 1

    counting = Counting(model).requires_grad_(False)
    with torch.no_grad():
        _, st_c = odeint_with_stats(counting, y0, t, rtol=RTOL, atol=ATOL)
    n = counting.n
    _check(n["step"] == st_c.n_steps
           and n["accept"] + n["reject"] == n["step"]
           and n["accept"] == st_c.n_accepted,
           f"callbacks {n} against {st_c}")

    print(f"[11 fixed grid] B={B} H={H} T={T} num_steps={FIXED_STEPS} | "
          f"euler, midpoint, heun2, heun3, rk4 (+ cubic, + perturb) float64 "
          f"card vs CPU max|dy|={worst:.3e} (<= {F64_VALUES}), Stats equal | "
          f"rk4 route launches {route_launches}, non-uniform t "
          f"{odd_launches}; route vs float32 loop {err_route:.3e} (<= "
          f"{F32_RK4_LOOP}) | training step odeint(rk4) + SGD: gradients vs "
          f"CPU float64: float32 {rel32:.2e} (<= {GRAD_F32_REL}), float64 "
          f"{rel64:.2e} (<= {GRAD_F64_REL}); remat bit for bit; the step's "
          f"peak allocation float32 {peak32 / 2**20:.1f} MiB, remat "
          f"{peak_remat32 / 2**20:.1f} MiB (float64 {peak / 2**20:.1f}) | "
          f"kernel launches {step_launches} (the step runs none) | loss "
          f"{losses[0]:.7f} -> {losses[-1]:.7f} | warm step over "
          f"{TRAIN_STEPS}: median {med:.2f} ms (min {step_ms.min():.2f}, max "
          f"{step_ms.max():.2f}); forward {np.median(fwd_ms):.2f} ms "
          f"({fwd_ms.min():.2f}..{fwd_ms.max():.2f}), backward "
          f"{np.median(bwd_ms):.2f} ms ({bwd_ms.min():.2f}..{bwd_ms.max():.2f}"
          f"), host wall median {np.median(wall_ms):.2f} ms | device busy: "
          f"{busy} | odeint_adjoint(rk4, step_size 1/{FIXED_STEPS}) float64 "
          f"vs CPU {rel_adj:.2e} | odeint_event(rk4, step_size "
          f"{FIXED_EVENT_STEP}) event_t {et_gpu:.9f}, gradient vs CPU "
          f"{rel_ev:.2e} | controllers float64 == CPU: pi {ctl['pi']}, pid "
          f"{ctl['pid']} | bfloat16 + error_dtype float32 at rtol "
          f"{BF16_RTOL}: {err_b:.2e} of max|y| (<= {BF16_VALUES}), steps "
          f"{st_b.n_steps} vs float32 {st_f.n_steps} | callbacks {n} == "
          f"steps {st_c.n_steps}")
    return med


IMPLICIT_FIXED = ("explicit_adams", "implicit_adams", "fixed_adams",
                  "implicit_euler", "implicit_midpoint", "trapezoid",
                  "radauIIA3", "gl4", "radauIIA5", "gl6", "sdirk2", "trbdf2")
STIFF = ("kvaerno5", "radau5a", "kvaerno3")


def _implicit_setup(torch, device, b=IMPLICIT_B):
    """Phase 12's spiral problem at batch `b`, float64: bench.py's model,
    its first `b` states and targets, on `device`."""
    model, y0, target, t = _train_setup(torch, np.float64, device)
    return model, y0[:b].contiguous(), target[:b].contiguous(), t


def _implicit_solve(torch, device, method, grads):
    """One solve of phase 12's parity problem: (ys, Stats counters, and
    with `grads` the gradients of mean((ys - target)**2) to y0 and the
    parameters: through the loop on the fixed grid, by odeint_adjoint on
    the adaptive one)."""
    from torchdiffeq_tpu_torch import odeint, odeint_adjoint, odeint_with_stats
    model, y0, target, t = _implicit_setup(torch, device)
    opts = None if method in STIFF else dict(num_steps=FIXED_STEPS)
    kw = dict(rtol=RTOL, atol=ATOL, method=method, options=opts)
    with torch.no_grad():
        ys, st = odeint_with_stats(model, y0, t, **kw)
    if not grads:
        return ys.cpu(), list(st[:5]), None
    model.requires_grad_(True)
    y0.requires_grad_(True)
    solve = odeint_adjoint if method in STIFF else odeint
    ((solve(model, y0, t, **kw) - target[None]) ** 2).mean().backward()
    return ys.cpu(), list(st[:5]), [g.detach().cpu() for g in
                                    [y0.grad] + [p.grad
                                                 for p in model.parameters()]]


def _stiff_problem(torch, device, b):
    """The batched linear relaxation of benchmarks/perf_sections/stiff.md:
    y_i' = -lam_i (y_i - t) + 1, lam = logspace(2, 4, b), y0 = 1 + 0.5 u
    with u from RandomState(0), float64; and its exact solution."""
    lam = torch.from_numpy(np.logspace(2.0, 4.0, b)).to(device)
    u = np.random.RandomState(0).rand(b)
    y0 = torch.from_numpy(1.0 + 0.5 * u).to(device)
    t = torch.linspace(0.0, 5.0, 5, dtype=torch.float64)

    def field(s, y):
        return -lam * (y - s.to(y.device)) + 1.0

    tt_ = t.to(device)[:, None]
    exact = tt_ + y0[None] * torch.exp(-lam[None] * tt_)
    return field, y0, t, exact


class _Annotated:
    """While active, the stage solves' linear solves and Jacobians run
    inside `torch.profiler.record_function` ranges named 'linsolve' and
    'jacobian', so that a trace attributes their kernels."""

    def __enter__(self):
        import torch
        from torchdiffeq_tpu_torch.ops import linsolve
        from torchdiffeq_tpu_torch.solvers import fixed_grid_implicit as fgi
        self.saved = (linsolve, linsolve.solve, fgi, fgi.lane_jacobian)

        def wrap(name, fn):
            def inner(*a, **k):
                with torch.profiler.record_function(name):
                    return fn(*a, **k)
            return inner
        linsolve.solve = wrap("linsolve", linsolve.solve)
        fgi.lane_jacobian = wrap("jacobian", fgi.lane_jacobian)
        return self

    def __exit__(self, *exc):
        linsolve, solve, fgi, jac = self.saved
        linsolve.solve, fgi.lane_jacobian = solve, jac


def _profiled_shares(torch, fn):
    """One call of `fn` under torch.profiler with `_Annotated`: (device ms
    of all kernels, of the kernels inside 'linsolve' ranges, inside
    'jacobian' ranges), or None when the trace holds no device time.  The
    trace marks each range on the device too, as a span from its first
    kernel's start to its last one's end; on one stream the kernels that
    start inside a span are the range's, and the span's own length would
    count the device's idle gaps in it."""
    import bisect
    from torch.profiler import ProfilerActivity, profile
    names = ("linsolve", "jacobian")
    with _Annotated(), profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    kernels_ = [e for e in events if e.name not in names]
    total = sum(e.time_range.elapsed_us() for e in kernels_) / 1e3
    if total == 0:
        return None
    under = {}
    for name in names:
        spans = sorted((e.time_range.start, e.time_range.end)
                       for e in events if e.name == name)
        starts = [a for a, _ in spans]

        def inside(t):
            i = bisect.bisect_right(starts, t) - 1
            return i >= 0 and t <= spans[i][1]
        under[name] = sum(e.time_range.elapsed_us() for e in kernels_
                          if inside(e.time_range.start)) / 1e3
    return total, under["linsolve"], under["jacobian"]


def _implicit_train_step(torch, model, y0, target, t, marks=None):
    """Phase 10's step with implicit_adams (num_steps=FIXED_STEPS) through
    the loop instead of the adjoint."""
    from torchdiffeq_tpu_torch import odeint
    if marks:
        marks[0].record()
    ys = odeint(model, y0, t, method="implicit_adams",
                options=dict(num_steps=FIXED_STEPS))
    loss = ((ys - target[None]) ** 2).mean()
    if marks:
        marks[1].record()
    loss.backward()
    if marks:
        marks[2].record()
    grads = []
    with torch.no_grad():
        for p in model.parameters():
            grads.append(p.grad)
            p -= 1e-3 * p.grad
            p.grad = None
    if marks:
        marks[3].record()
    return loss.detach(), grads


def _trbdf2_grads(torch, device, b):
    """One forward and backward of the trbdf2 (Newton) training loss on
    `device` at batch `b`, float64: (wall ms, Stats, the stage-solve
    counts, gradients to y0 and the parameters)."""
    from torchdiffeq_tpu_torch import odeint_with_stats
    from torchdiffeq_tpu_torch.solvers.solution import (IMPLICIT_COUNTS,
                                                        reset_implicit_counts)
    model, y0, target, t = _implicit_setup(torch, device, b)
    model.requires_grad_(True)
    y0.requires_grad_(True)
    reset_implicit_counts()
    if device != "cpu":
        torch.cuda.synchronize()
    w0 = time.perf_counter()
    ys, st = odeint_with_stats(model, y0, t, method="trbdf2",
                               options=dict(num_steps=FIXED_STEPS,
                                            root_solver="newton"))
    ((ys - target[None]) ** 2).mean().backward()
    if device != "cpu":
        torch.cuda.synchronize()
    wall = (time.perf_counter() - w0) * 1e3
    grads = [g.detach().cpu()
             for g in [y0.grad] + [p.grad for p in model.parameters()]]
    return wall, st, dict(IMPLICIT_COUNTS), grads


def _phase_implicit(torch, kernels, dev):
    """Phase 12: the Adams and implicit tiers on the card."""
    from torchdiffeq_tpu_torch import odeint, odeint_dense, odeint_with_stats
    from torchdiffeq_tpu_torch.solvers.solution import (IMPLICIT_COUNTS,
                                                        reset_implicit_counts)

    # 1. every new method, float64, B=IMPLICIT_B: card against CPU
    clock = time.perf_counter()
    worst_v = worst_g = 0.0
    for method in IMPLICIT_FIXED + STIFF:
        grads = method != "kvaerno3"
        ys_c, st_c, g_c = _implicit_solve(torch, "cpu", method, grads)
        ys_g, st_g, g_g = _implicit_solve(torch, dev, method, grads)
        err = float((ys_g - ys_c).abs().max() / ys_c.abs().max())
        rel = _max_rel(g_g, g_c) if grads else 0.0
        worst_v, worst_g = max(worst_v, err), max(worst_g, rel)
        _check(st_g == st_c and st_g[4] == 0 and err <= F64_VALUES
               and rel <= GRAD_F64_REL,
               f"{method} float64 card vs CPU: {err} of max|y|, Stats "
               f"{st_g} vs {st_c}, gradients {rel} of max|g|")
    print(f"[12a implicit parity] the 15 Adams and implicit methods, spiral "
          f"B={IMPLICIT_B} H={H} T={T} float64 (fixed grid num_steps="
          f"{FIXED_STEPS}; kvaerno3/5, radau5a rtol={RTOL} atol={ATOL}) card "
          f"vs CPU: values {worst_v:.2e} of max|y| (<= {F64_VALUES}), Stats "
          f"equal, error code 0; gradients of the mean-square loss to y0 and "
          f"the parameters (through the loop and the IFT on the fixed grid, "
          f"odeint_adjoint for kvaerno5 and radau5a; kvaerno3's adjoint is in "
          f"the GPU tests) {worst_g:.2e} of max|g| (<= {GRAD_F64_REL}) | "
          f"{time.perf_counter() - clock:.1f} s", flush=True)
    clock = time.perf_counter()

    # one odeint_event (phase 10's event function: a threshold on the batch
    # mean of y[:, 0] and a cut-off) and one odeint_dense, kvaerno5, against
    # the CPU
    ev, dense = {}, {}
    for device in ("cpu", dev):
        model, y0, _, t = _implicit_setup(torch, device)
        with torch.no_grad():
            means = odeint(model, y0, t, rtol=RTOL, atol=ATOL,
                           method="kvaerno5")[:, :, 0].mean(1)
            thr = float((means[0] + means[4]) / 2)
            (et, ys2), st = odeint_with_stats(
                model, y0, torch.tensor([0.0, 1.0], dtype=torch.float64),
                event_fn=lambda tt, yy: torch.stack(
                    [yy[:, 0].mean() - thr, (tt - EVENT_CUT).to(yy.dtype)]),
                method="kvaerno5", rtol=RTOL, atol=ATOL)
            sol, st_d = odeint_dense(model, y0, 0.0, 1.0, method="kvaerno5",
                                     rtol=RTOL, atol=ATOL,
                                     _return_stats=True)
            tq = torch.linspace(0.0, 1.0, 7, dtype=torch.float64)
            ev[device] = float(et), ys2.cpu(), list(st[:5])
            dense[device] = sol(tq).cpu(), list(st_d[:5])
    (et_c, ye_c, se_c), (et_g, ye_g, se_g) = ev["cpu"], ev[dev]
    (yd_c, sd_c), (yd_g, sd_g) = dense["cpu"], dense[dev]
    err_e = max(abs(et_g - et_c), float((ye_g - ye_c).abs().max()))
    err_d = float((yd_g - yd_c).abs().max())
    _check(se_g == se_c and sd_g == sd_c and err_e <= F64_VALUES
           and err_d <= F64_VALUES and 0.0 < et_g < EVENT_CUT,
           f"kvaerno5 event/dense card vs CPU: {err_e}, {err_d}, Stats "
           f"{se_g} vs {se_c}, {sd_g} vs {sd_c}")
    print(f"[12b implicit event, dense] kvaerno5 float64 B={IMPLICIT_B}: "
          f"odeint_event (phase 10's event function) event_t "
          f"{et_g:.12f}, card vs CPU {err_e:.2e}, Stats {se_g} equal | "
          f"odeint_dense on [0, 1] at 7 times card vs CPU {err_d:.2e}, Stats "
          f"{sd_g} equal | {time.perf_counter() - clock:.1f} s", flush=True)

    # 2. the batched stiff problem
    rows = []
    walls = {}
    for method in STIFF:
        clock = time.perf_counter()
        b = KVAERNO3_B if method == "kvaerno3" else STIFF_B
        field, y0s, ts, exact = _stiff_problem(torch, dev, b)
        kw = dict(method=method, rtol=STIFF_RTOL, atol=STIFF_ATOL)
        with torch.no_grad():
            # the trace covers the solve's first TRACE_STEPS steps (every
            # step runs the same work a Newton iteration; the trace's
            # processing costs ~50 ms an iteration), and warms the path
            shares = _profiled_shares(torch, lambda: odeint_with_stats(
                field, y0s, ts, options=dict(max_num_steps=TRACE_STEPS),
                **kw))
            reset_implicit_counts()
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            ys, st = odeint_with_stats(field, y0s, ts, **kw)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
            counts = dict(IMPLICIT_COUNTS)
        walls[method] = (b, wall)
        err = float((ys - exact).abs().max())
        _check(st.error_code == 0 and bool(torch.isfinite(ys).all())
               and err <= STIFF_EXACT,
               f"batched stiff {method}: error code {st.error_code}, max "
               f"error vs exact {err}")
        share = ("linear-solve and Jacobian shares not measured (no device "
                 "time in the trace)" if shares is None else
                 f"traced first {TRACE_STEPS} steps: device {shares[0]:.1f} "
                 f"ms, linear solves {shares[1] / shares[0]:.1%}, Jacobians "
                 f"{shares[2] / shares[0]:.1%}")
        cut = (f" (B cut to {b}: at B={STIFF_B} kvaerno3's solves would "
               f"hold the phase past {STIFF_BUDGET_S} s)" if b != STIFF_B
               else "")
        rows.append(
            f"{method} B={b}{cut}: steps {st.n_steps} (rejected "
            f"{st.n_rejected}), nfe {st.nfe}, max|y - exact| {err:.2e}, warm "
            f"wall {wall:.1f} ms, Newton iterations {counts['iterations']}, "
            f"linear solves {counts['linear_solves']}, Jacobians "
            f"{counts['jacobians']}, host reads {counts['host_reads']} in "
            f"stage solves + {st.n_steps + 1} in the step loop; {share}; "
            f"{time.perf_counter() - clock:.1f} s")
    print(f"[12c batched stiff] y' = -lam (y - t) + 1, lam = logspace(2, 4, "
          f"B), one flat state and controller, t = linspace(0, 5, 5), rtol="
          f"{STIFF_RTOL} atol={STIFF_ATOL} float64 on the card (max error "
          f"<= {STIFF_EXACT}) | " + " | ".join(rows), flush=True)

    # 3a. the implicit_adams training step at full width, float32
    clock = time.perf_counter()
    model, y0, target, t = _train_setup(torch, np.float32, dev)
    m64, y64, tg64, _ = _train_setup(torch, np.float64, dev)
    _, g32 = _implicit_train_step(torch, model, y0, target, t)
    g32 = [g.clone() for g in g32]
    _, g64 = _implicit_train_step(torch, m64, y64, tg64, t)
    rel32 = _max_rel(g32, g64)
    _check(rel32 <= GRAD_F32_REL, f"implicit_adams step float32 gradients "
           f"vs float64: {rel32} of max|g|")
    with torch.no_grad():
        reset_implicit_counts()
        _, st_a = odeint_with_stats(model, y0, t, method="implicit_adams",
                                    options=dict(num_steps=FIXED_STEPS))
        conv = (IMPLICIT_COUNTS["corrector_converged"],
                IMPLICIT_COUNTS["corrector_steps"])
    kernels.reset_launch_counts()
    times, losses = [], []
    for _ in range(TRAIN_STEPS):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        loss, _ = _implicit_train_step(torch, model, y0, target, t, marks)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - w0) * 1e3
        losses.append(float(loss))
        times.append((marks[0].elapsed_time(marks[3]),
                      marks[0].elapsed_time(marks[1]),
                      marks[1].elapsed_time(marks[2]), wall))
    launches = dict(kernels.launch_counts)
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"implicit_adams training step: losses {losses}")
    step_ms, fwd_ms, bwd_ms, wall_ms = (np.array(c) for c in zip(*times))
    busy_ms, n_launch, prof_wall = _profiled_step(
        torch, lambda: _implicit_train_step(torch, model, y0, target, t))
    med = float(np.median(step_ms))
    busy = ("not measured (no device time in the trace)" if busy_ms is None
            else f"{busy_ms:.3f} ms of device time in {n_launch} kernels, "
            f"{busy_ms / med:.1%} of the median step ({busy_ms / prof_wall:.1%}"
            f" of the traced step's {prof_wall:.1f} ms)")
    print(f"[12d implicit_adams step] bench.py's step B={B} H={H} T={T} "
          f"float32, odeint(implicit_adams, num_steps={FIXED_STEPS}) through "
          f"the loop + SGD lr 1e-3 | gradients vs the card's float64 step "
          f"{rel32:.2e} of max|g| (<= {GRAD_F32_REL}) | nfe {st_a.nfe} "
          f"(reference convention) over {st_a.n_steps} steps, correctors "
          f"converged {conv[0]} of {conv[1]} | kernel launches {launches} "
          f"(the step runs none) | loss {losses[0]:.7f} -> {losses[-1]:.7f} "
          f"| warm step over {TRAIN_STEPS}: median {med:.2f} ms (min "
          f"{step_ms.min():.2f}, max {step_ms.max():.2f}); forward "
          f"{np.median(fwd_ms):.2f} ms ({fwd_ms.min():.2f}..{fwd_ms.max():.2f}"
          f"), backward {np.median(bwd_ms):.2f} ms ({bwd_ms.min():.2f}.."
          f"{bwd_ms.max():.2f}), host wall median {np.median(wall_ms):.2f} ms "
          f"| device busy: {busy} | {time.perf_counter() - clock:.1f} s",
          flush=True)

    # 3b. trbdf2 with Newton at full width, float64 (n = 2048 a stage)
    clock = time.perf_counter()
    _trbdf2_grads(torch, dev, IMPLICIT_B)                  # warm the path
    wall, st_t, counts, _ = _trbdf2_grads(torch, dev, B)
    _, st_c, _, g_c = _trbdf2_grads(torch, "cpu", IMPLICIT_B)
    _, st_s, _, g_s = _trbdf2_grads(torch, dev, IMPLICIT_B)
    rel_t = _max_rel(g_s, g_c)
    _check(st_t.error_code == 0 and list(st_s[:5]) == list(st_c[:5])
           and rel_t <= GRAD_F64_REL,
           f"trbdf2 Newton: error code {st_t.error_code}, B={IMPLICIT_B} "
           f"card vs CPU gradients {rel_t} of max|g|")
    print(f"[12e trbdf2 Newton step] B={B} H={H} float64, odeint(trbdf2, "
          f"root_solver='newton', num_steps={FIXED_STEPS}) forward and "
          f"backward (IFT) of the mean-square loss: {wall:.1f} ms, Newton "
          f"iterations {counts['iterations']}, linear solves "
          f"{counts['linear_solves']} (backward included), Jacobians "
          f"{counts['jacobians']}, host reads {counts['host_reads']}, error "
          f"code {st_t.error_code} | B={IMPLICIT_B} gradients card vs CPU "
          f"{rel_t:.2e} of max|g| (<= {GRAD_F64_REL}), Stats equal | "
          f"{time.perf_counter() - clock:.1f} s", flush=True)
    return walls


def _shared_conv(npd):
    """bench.py's `make_shared_conv` (RandomState(3), drawn in float32):
    the two 3x3 time-concat convolutions' HWIO weights (time channel last)
    and zero biases, y0 (CONV_B, 6, 6, CONV_DIM) and the target (6, 6,
    CONV_DIM), in the dtype `npd`."""
    rng = np.random.RandomState(3)
    d = CONV_DIM

    def he(c_in):
        return (rng.randn(3, 3, c_in, d) *
                np.sqrt(2.0 / (9 * c_in))).astype(np.float32)

    w1, w2 = he(d + 1), he(d + 1)
    y0 = (0.3 * rng.randn(CONV_B, CONV_HW, CONV_HW, d)).astype(np.float32)
    target = rng.randn(CONV_HW, CONV_HW, d).astype(np.float32)
    params = dict(conv1=dict(w=w1, b=np.zeros(d, np.float32)),
                  conv2=dict(w=w2, b=np.zeros(d, np.float32)))
    params = {k: {n: a.astype(npd) for n, a in v.items()}
              for k, v in params.items()}
    return params, y0.astype(npd), target.astype(npd)


def _conv_setup(torch, npd, device, b=CONV_B):
    """The conv step's counted field (parameters requiring grad), y0[:b]
    and target on `device`."""
    from torchdiffeq_tpu_torch.models import conv_params_from_jax

    class Counted(torch.nn.Module):
        """The field, counting its evaluations."""

        def __init__(self, field):
            super().__init__()
            self.field, self.n = field, 0

        def forward(self, tt, yy):
            self.n += 1
            return self.field(tt, yy)

    params, y0, target = _shared_conv(npd)
    model = Counted(conv_params_from_jax(params, device=device))
    return (model, torch.from_numpy(y0[:b]).to(device),
            torch.from_numpy(target).to(device))


def _conv_loss(torch, model, y0, target, mode):
    """bench.py's conv loss, mean((y(1) - target)**2), through one gradient
    mode: the continuous adjoint ('adjoint', bench.py's), the interpolated
    one, or the replay of `odeint`."""
    from torchdiffeq_tpu_torch import odeint, odeint_adjoint
    t = torch.tensor([0.0, 1.0], dtype=torch.float64)
    kw = dict(rtol=CONV_TOL, atol=CONV_TOL, method="dopri5")
    if mode == "replay":
        ys = odeint(model, y0, t, options=dict(replay_grad=True), **kw)
    else:
        ys = odeint_adjoint(model, y0, t, adjoint_options=dict(
            interpolated=True) if mode == "interpolated" else None, **kw)
    return ((ys[-1] - target[None]) ** 2).mean()


def _conv_step(torch, model, y0, target, mode, marks=None):
    """One training step (the loss, its backward, p -= 1e-3 * grad); the
    four CUDA events `marks` as in `_train_step`.  Returns (loss, the
    gradients, the field's evaluations in the forward and the backward)."""
    if marks:
        marks[0].record()
    n0 = model.n
    loss = _conv_loss(torch, model, y0, target, mode)
    n1 = model.n
    if marks:
        marks[1].record()
    loss.backward()
    if marks:
        marks[2].record()
    grads = []
    with torch.no_grad():
        for p in model.parameters():
            grads.append(p.grad)
            p -= 1e-3 * p.grad
            p.grad = None
    if marks:
        marks[3].record()
    return loss.detach(), grads, (n1 - n0, model.n - n1)


def _conv_grads(torch, device, mode):
    """The float64 gradients (y0 and the four weights) of the conv loss at
    CONV_CHECK_B on `device` through `mode`, and the forward solve's Stats
    and values."""
    from torchdiffeq_tpu_torch import odeint_with_stats
    model, y0, target = _conv_setup(torch, np.float64, device, CONV_CHECK_B)
    t = torch.tensor([0.0, 1.0], dtype=torch.float64)
    with torch.no_grad():
        ys, st = odeint_with_stats(model, y0, t, rtol=CONV_TOL,
                                   atol=CONV_TOL)
    y0.requires_grad_(True)
    _conv_loss(torch, model, y0, target, mode).backward()
    return ([g.detach().cpu() for g in [y0.grad] +
             [p.grad for p in model.parameters()]], list(st[:5]), ys.cpu())


def _phase_conv(torch, kernels, dev):
    """Phase 13: the conv ODE-Net's training step (bench.py:215-345) on the
    card, through the three gradient modes, and the card against the CPU
    in float64."""
    from torchdiffeq_tpu_torch import odeint, odeint_with_stats
    from torchdiffeq_tpu_torch.models import conv_field_flops
    tf32 = lambda: (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
    _check(tf32() == (False, False), f"phase 13 needs TF32 off: {tf32()}")
    p0 = time.perf_counter()

    # (a) bench.py's conv step at full width, float32, counted
    model, y0, target = _conv_setup(torch, np.float32, dev)
    t = torch.tensor([0.0, 1.0], dtype=torch.float64)
    kernels.reset_launch_counts()
    losses, evals = [], None
    with _BackwardStats() as bwd:
        loss, grads, evals = _conv_step(torch, model, y0, target, "adjoint")
        losses.append(float(loss))
    torch.cuda.synchronize()
    launches = dict(kernels.launch_counts)
    bwd_st = bwd.stats[-1]
    with torch.no_grad():
        ys, st_f = odeint_with_stats(model, y0, t, rtol=CONV_TOL,
                                     atol=CONV_TOL)
    _check(tuple(ys.shape) == (2, CONV_B, CONV_HW, CONV_HW, CONV_DIM)
           and ys.device.type == torch.device(dev).type
           and bool(torch.isfinite(ys).all())
           and st_f.error_code == 0 and bwd_st.error_code == 0
           and all(bool(torch.isfinite(g).all()) for g in grads),
           f"conv step: forward {st_f}, backward {bwd_st}")

    timed = {}
    for mode in ("adjoint", "interpolated", "replay"):
        _conv_step(torch, model, y0, target, mode)          # warm
        times = []
        for _ in range(CONV_STEPS):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            loss, _, ev = _conv_step(torch, model, y0, target, mode, marks)
            torch.cuda.synchronize()
            losses.append(float(loss))
            times.append((marks[0].elapsed_time(marks[3]),
                          marks[0].elapsed_time(marks[1]),
                          marks[1].elapsed_time(marks[2])))
        timed[mode] = ([np.array(c) for c in zip(*times)], ev)
    _check(all(np.isfinite(losses)) and losses[-1] < losses[0],
           f"conv step: losses {losses[0]} -> {losses[-1]}")
    _check(tf32() == (False, False), f"TF32 turned on in phase 13: {tf32()}")
    by_name = {}
    busy_ms, n_launch, prof_wall = _profiled_step(
        torch, lambda: _conv_step(torch, model, y0, target, "adjoint"),
        by_name)
    # the convolutions' kernels (cuDNN's and their GEMMs) against the rest
    conv_ms = sum(v for k, v in by_name.items()
                  if re.search("conv|cudnn|gemm|xmma|wgrad|dgrad", k, re.I))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]

    # (c) the card against the CPU, float64, B=CONV_CHECK_B
    cpu, card = {}, {}
    for mode in ("adjoint", "interpolated", "replay"):
        cpu[mode] = _conv_grads(torch, "cpu", mode)
        card[mode] = _conv_grads(torch, dev, mode)
    _, st_c, ys_c = cpu["adjoint"]
    _, st_g, ys_g = card["adjoint"]
    err_solve = float((ys_g - ys_c).abs().max())
    _check(st_g == st_c and err_solve <= F64_VALUES,
           f"conv solve float64 card vs CPU: {err_solve}, {st_g} vs {st_c}")
    rel = {m: _max_rel(card[m][0], cpu[m][0]) for m in cpu}
    _check(all(r <= GRAD_F64_REL for r in rel.values()),
           f"conv gradients float64 card vs CPU: {rel}")
    fields = []
    for device in ("cpu", dev):
        m64, y64, _ = _conv_setup(torch, np.float64, device, CONV_CHECK_B)
        with torch.no_grad():
            fields.append(m64(torch.tensor(0.37, dtype=torch.float64),
                              y64).cpu())
    err_field = float((fields[1] - fields[0]).abs().max()
                      / fields[0].abs().max())
    _check(err_field <= CONV_F64_FIELD,
           f"conv field float64 card vs CPU: {err_field} of max|f|")

    # forward_grad's jvp on the spiral field, and the SciPy bridge from a
    # CUDA state, card against CPU in float64
    jvps, sci = [], []
    for device in ("cpu", dev):
        m, ys0, _, ts = _train_setup(torch, np.float64, device)
        ys0 = ys0[:64]
        v = torch.from_numpy(np.random.RandomState(5).randn(64, 2)).to(device)
        _, tan = torch.func.jvp(lambda y: (odeint(
            m, y, ts, rtol=RTOL, atol=ATOL,
            options=dict(forward_grad=True)) ** 2).mean(), (ys0,), (v,))
        jvps.append(tan.cpu())
        with torch.no_grad():
            ys_s, st_s = odeint_with_stats(m, ys0, ts, method="scipy_solver",
                                           rtol=RTOL, atol=ATOL)
        _check(ys_s.device == ys0.device and ys_s.dtype == torch.float64,
               f"scipy_solver result on {ys_s.device}, {ys_s.dtype}")
        sci.append((ys_s.cpu(), int(st_s.nfe)))
    rel_jvp = abs(float(jvps[1] - jvps[0])) / abs(float(jvps[0]))
    err_sci = float((sci[1][0] - sci[0][0]).abs().max()
                    / sci[0][0].abs().max())
    _check(rel_jvp <= GRAD_F64_REL and sci[1][1] == sci[0][1]
           and err_sci <= CONV_F64_FIELD,
           f"forward_grad jvp {rel_jvp}, scipy {err_sci} nfe {sci[1][1]} "
           f"vs {sci[0][1]}")
    phase_s = time.perf_counter() - p0

    def row(mode):
        (step, fwd, bwd_ms), ev = timed[mode]
        return (f"{mode}: median {np.median(step):.2f} ms (min "
                f"{step.min():.2f}, max {step.max():.2f}), forward "
                f"{np.median(fwd):.2f}, backward {np.median(bwd_ms):.2f}; "
                f"field evaluations forward {ev[0]}, backward {ev[1]}")

    med = float(np.median(timed["adjoint"][0][0]))
    nfe = st_f.nfe + bwd_st.nfe
    flops = (evals[0] + evals[1]) * conv_field_flops(CONV_B, CONV_HW,
                                                    CONV_HW, CONV_DIM) * 2
    busy = ("not measured (no device time in the trace)" if busy_ms is None
            else f"{busy_ms:.3f} ms of device time in {n_launch} kernels, "
            f"{busy_ms / med:.1%} of the median step ({busy_ms / prof_wall:.1%}"
            f" of the traced step's {prof_wall:.1f} ms), of which the "
            f"convolutions' kernels {conv_ms:.3f} ms; longest "
            + ", ".join(f"{k[:60]} {v:.3f} ms" for k, v in top))
    print(f"[13 conv ODE-Net] bench.py's conv step state ({CONV_B}, "
          f"{CONV_HW}, {CONV_HW}, {CONV_DIM}) float32, dopri5 rtol=atol="
          f"{CONV_TOL}, odeint_adjoint + SGD lr 1e-3, TF32 off; kernel "
          f"launches {launches} (the step runs none) | loss {losses[0]:.7f} "
          f"-> {losses[-1]:.7f} over {len(losses)} steps | forward steps "
          f"{st_f.n_steps} nfe {st_f.nfe}, backward steps {bwd_st.n_steps} "
          f"nfe {bwd_st.nfe} (solver counts, {nfe} in all); field "
          f"evaluations forward {evals[0]}, backward {evals[1]} (JAX's count "
          f"on the host CPU, bench.py:300-330: {JAX_CONV_NFE[0]} and "
          f"{JAX_CONV_NFE[1]}) | warm steps over {CONV_STEPS}, "
          + " | ".join(row(m) for m in ("adjoint", "interpolated", "replay"))
          + f" | {flops / (med / 1e3) / 1e12:.3f} TFLOP/s of convolution "
          f"(the adjoint step's evaluations x 2 for the backward's products) "
          f"| device busy: {busy} | float64 B={CONV_CHECK_B} card vs CPU: "
          f"field {err_field:.2e} of max|f| (<= {CONV_F64_FIELD}), solve "
          f"{err_solve:.2e} (<= {F64_VALUES}), Stats {st_g} equal, gradients "
          + ", ".join(f"{m} {r:.2e}" for m, r in rel.items())
          + f" of max|g| (<= {GRAD_F64_REL}) | forward_grad jvp (spiral, "
          f"B=64) {rel_jvp:.2e} | scipy_solver from CUDA: back on the card, "
          f"{err_sci:.2e} of max|y|, nfe {sci[1][1]} == CPU | {phase_s:.1f} s")


def _wall_stats(torch, fn, reps):
    """Median, min and max milliseconds of `reps` calls of `fn` (CUDA
    events around each; `fn` ends in host reads, so each call is whole),
    called when the same call has just run once: warm."""
    ms = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end))
    return float(np.median(ms)), float(min(ms)), float(max(ms))


def _spread(steps):
    s = steps.cpu().numpy()
    return f"{s.min()}/{int(np.median(s))}/{s.max()}"


def _lane_spiral(torch, mlp):
    """The spiral MLP field with a per-sample decay, for phase 14's
    gradient: f(t, y, lam_i) = mlp(y**3) - lam_i * y, an ``nn.Module``
    holding the MLP, so that its parameters get gradients."""
    class LaneSpiral(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.mlp = mlp

        def forward(self, t, y, lam):
            return self.mlp(t, y) - lam * y

    return LaneSpiral()


def _ps_grads(torch, device, npd, b):
    """The per-sample spiral's gradients of mean(ys**2) in y0, the MLP's
    parameters and the per-sample decay, B=`b`, on `device`."""
    from torchdiffeq_tpu_torch import odeint_per_sample
    model, y_big = _spiral(torch, torch.float64 if npd == np.float64
                           else torch.float32, device)
    model.requires_grad_(True)
    field = _lane_spiral(torch, model)
    y0 = y_big[:b].clone().requires_grad_(True)
    lam = torch.linspace(0.1, 0.5, b, dtype=y0.dtype,
                         device=device).requires_grad_(True)
    t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    ys = odeint_per_sample(field, y0, t, args=(lam,), args_axes=(0,),
                           rtol=RTOL, atol=ATOL)
    (ys ** 2).mean().backward()
    return [y0.grad, lam.grad] + [p.grad for p in model.parameters()]


def _ps_event_grads(torch, device, b):
    """Gradients through the first zeros of phase 14's oscillators (B=`b`,
    float64): of sum(x(event)**2 + v(event)**2) in y0 and in each sample's
    frequency."""
    from torchdiffeq_tpu_torch import odeint_per_sample_with_stats
    rng = np.random.RandomState(0)
    om = torch.from_numpy(np.exp(rng.uniform(0.0, np.log(ENS_OMEGA_MAX), b))
                          ).to(device).requires_grad_(True)
    y0 = torch.stack([torch.ones(b, dtype=torch.float64),
                      torch.zeros(b, dtype=torch.float64)], 1).to(
        device).requires_grad_(True)
    (_, ys2), _ = odeint_per_sample_with_stats(
        lambda t, y, w: torch.stack([y[1], -w ** 2 * y[0] - 0.1 * y[1]]),
        y0, torch.tensor([0.0, 2.0], dtype=torch.float64), args=(om,),
        args_axes=(0,), event_fn=lambda t, y: y[0], rtol=RTOL, atol=ATOL)
    (ys2[:, 1] ** 2).sum().backward()
    return [y0.grad, om.grad]


def _phase_per_sample(torch, kernels, dev):
    """Phase 14: the batched per-sample driver on the card -- the ensemble
    of examples/ensemble.py and its events, the driver against K-dopri5
    and K-events on the spiral, the per-sample gradient, and
    benchmarks/bench_ensemble.py's scalar field at B=65536."""
    from torchdiffeq_tpu_torch import odeint_with_stats, \
        odeint_per_sample_with_stats
    from torchdiffeq_tpu_torch.models import LinearEvent
    from torchdiffeq_tpu_torch.solvers import batched_rk
    card = _card()
    p0 = time.perf_counter()

    # (a) examples/ensemble.py at its defaults: damped oscillators with a
    # frequency per sample, args_axes=(-1,), dopri5, float32
    def osc(t, y, om):
        return torch.stack([y[1], -om ** 2 * y[0] - 0.1 * y[1]])

    rng = np.random.RandomState(0)
    omega = np.exp(rng.uniform(0.0, np.log(ENS_OMEGA_MAX), ENS_B)).astype(
        np.float32)
    om = torch.from_numpy(omega).to(dev)
    y0 = torch.stack([torch.ones(ENS_B), torch.zeros(ENS_B)], 1).to(dev)
    t = torch.linspace(0.0, 2.0, 5, dtype=torch.float64)
    kw = dict(args=(om,), args_axes=(-1,), rtol=ENS_RTOL,
              atol=ENS_RTOL * 1e-2, method="dopri5")
    with torch.no_grad():
        kernels.reset_launch_counts()
        batched_rk.reset_lane_counts()
        ys, st = odeint_per_sample_with_stats(osc, y0, t, **kw)
        torch.cuda.synchronize()
        counts = dict(batched_rk.LANE_COUNTS)
        launched = dict(kernels.launch_counts)
        om64 = omega.astype(np.float64)
        wd = np.sqrt(om64 ** 2 - 0.0025)[:, None]
        tn = t.numpy()[None, :]
        exact = np.exp(-0.05 * tn) * (np.cos(wd * tn)
                                      + 0.05 / wd * np.sin(wd * tn))
        err_ens = float(np.abs(ys[:, :, 0].double().cpu().numpy()
                               - exact).max())
        _check(tuple(ys.shape) == (ENS_B, 5, 2) and ys.device == y0.device
               and int(st.error_code.max()) == 0 and err_ens <= ENS_EXACT
               and sum(launched.values()) == 0,
               f"ensemble: error {err_ens}, codes {st.error_code.max()}, "
               f"kernel launches {launched}")
        ens_ms = _wall_stats(torch, lambda: odeint_per_sample_with_stats(
            osc, y0, t, **kw)[1].n_steps.max().item(), ENS_REPS)
        # the profiled solve spans a tenth of [0, 2]: gathering a trace of
        # the whole solve's ~200k launches took longer than the phase has
        # (about 20 s for a quarter of it on the H100)
        t_prof = torch.tensor([0.0, 0.2], dtype=torch.float64)
        batched_rk.reset_lane_counts()
        busy_ms, n_kern, prof_wall = _profiled_step(
            torch, lambda: odeint_per_sample_with_stats(osc, y0, t_prof,
                                                        **kw))
        prof_iters = batched_rk.LANE_COUNTS["iterations"]
        # one controller for the batch, as the reference runs it
        _, st_sh = odeint_with_stats(
            lambda tt_, yy: torch.stack(
                [yy[:, 1], -om ** 2 * yy[:, 0] - 0.1 * yy[:, 1]], 1),
            y0, t, rtol=ENS_RTOL, atol=ENS_RTOL * 1e-2)
        # the first zero of x, each sample its own event
        t_ev = torch.tensor([0.0, 2.0], dtype=torch.float64)
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        (ev_t, y_ev), st_e = odeint_per_sample_with_stats(
            osc, y0, t_ev, event_fn=lambda tt_, yy: yy[0], **kw)
        torch.cuda.synchronize()
        ev_ms = (time.perf_counter() - w0) * 1e3
        approx = np.pi / 2 / om64
        ev = ev_t.cpu().numpy()
        ev_rel = float(np.max(np.abs(ev - approx) / approx))
        _check(np.isfinite(ev).all() and (ev > 0).all()
               and ev_rel < ENS_EVENT_REL
               and int(st_e.error_code.max()) == 0,
               f"ensemble events: max rel dev {ev_rel}")
    iters = counts["iterations"]
    busy = ("not measured (no device time in the trace)" if busy_ms is None
            else f"{busy_ms:.2f} ms of device time in {n_kern} kernels over "
            f"{prof_iters} iterations ({n_kern / prof_iters:.0f} launches an "
            f"iteration), busy {busy_ms / prof_wall:.1%} of the traced "
            f"{prof_wall:.1f} ms")
    print(f"[14a ensemble] {card} | examples/ensemble.py B={ENS_B} damped "
          f"oscillators, omega in [1, {ENS_OMEGA_MAX:.0f}] per sample "
          f"(args_axes=(-1,)), dopri5 rtol={ENS_RTOL} atol={ENS_RTOL * 1e-2}, "
          f"t=linspace(0, 2, 5), float32, the batched driver (no kernel "
          f"launched) | warm solve median {ens_ms[0]:.1f} ms (min "
          f"{ens_ms[1]:.1f}, max {ens_ms[2]:.1f}; {ENS_REPS} solves, CUDA "
          f"events) | driver iterations {iters}, host reads {counts['host_reads']}"
          f" ({counts['host_reads'] / iters:.3f} an iteration) | per-sample "
          f"steps min/median/max {_spread(st.n_steps)}; one controller for "
          f"the batch (odeint_with_stats): {st_sh.n_steps} steps | max|x - "
          f"exact| {err_ens:.2e} (<= {ENS_EXACT}) | profiled solve on "
          f"[0, 0.2]: {busy} | event (first zero of x): times in "
          f"[{ev.min():.4f}, {ev.max():.4f}], max rel dev from pi/(2 omega) "
          f"{ev_rel:.2%} (< {ENS_EVENT_REL:.0%}), steps {_spread(st_e.n_steps)},"
          f" wall {ev_ms:.1f} ms | {time.perf_counter() - p0:.1f} s")

    # (b) the spiral at the main path's width: the driver against K-dopri5
    # and K-events
    p1 = time.perf_counter()
    rows = []
    tb = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    t_evb = torch.tensor([0.0, 1.0], dtype=torch.float64)
    for dtype in (torch.float32, torch.float64):
        model, y_big = _spiral(torch, dtype, dev)
        yb = y_big[:B].contiguous()
        # phase 8's threshold and cut-off, the threshold halfway between
        # the two middle lanes: on the median lane itself the event is zero
        # at t0, where JAX's vmap route (and the driver) stops with no step
        # and the kernel, whose sign there is 0, never fires
        mid = yb[:, 0].double().sort().values[B // 2 - 1:B // 2 + 1]
        thr = float(mid.mean())
        event = LinearEvent([[1.0, 0.0], [0.0, 0.0]], time_coef=[0.0, 1.0],
                            bias=[-thr, -1.0], dtype=dtype,
                            device=dev).requires_grad_(False)
        ekw = dict(event_fn=event, rtol=RTOL, atol=ATOL)
        with torch.no_grad():
            kernels.reset_launch_counts()
            kern = odeint_per_sample_with_stats(
                model, yb, tb, rtol=RTOL, atol=ATOL,
                options=dict(pallas=True))
            kern_ev = odeint_per_sample_with_stats(
                model, yb, t_evb, options=dict(
                    pallas=True, max_num_steps=EVENT_MAX_STEPS), **ekw)
            torch.cuda.synchronize()
            kl = dict(kernels.launch_counts)
            _check(kl["dopri5_integrate_batched"] == 1
                   and kl["dopri5_events_batched"] == 1,
                   f"the kernel routes' launches {kl}")
            kernels.reset_launch_counts()
            drv = odeint_per_sample_with_stats(model, yb, tb, rtol=RTOL,
                                               atol=ATOL)
            drv_ev = odeint_per_sample_with_stats(
                model, yb, t_evb, options=dict(
                    max_num_steps=EVENT_MAX_STEPS), **ekw)
            torch.cuda.synchronize()
            _check(sum(kernels.launch_counts.values()) == 0,
                   f"the driver launched {kernels.launch_counts}")
            res = {}
            for name, (k_out, k_st), (d_out, d_st) in (
                    ("solve", kern, drv), ("events", kern_ev, drv_ev)):
                if name == "events":
                    k_out, d_out = k_out[0][:, None], d_out[0][:, None]
                    same = (k_st.n_steps == d_st.n_steps) & (
                        k_st.error_code == d_st.error_code)
                else:
                    same = ((k_st.n_steps == d_st.n_steps)
                            & (k_st.n_accepted == d_st.n_accepted))
                diff = (k_out - d_out).abs().reshape(B, -1).amax(1)
                dsteps = int((k_st.n_steps - d_st.n_steps).abs().max())
                flip = float((~same).float().mean())
                err_all = float(diff.max())
                err_same = float(diff[same].max()) if bool(same.any()) \
                    else 0.0
                _check(int(d_st.error_code.max()) == 0
                       and bool(torch.isfinite(d_out).all()),
                       f"driver {name}: not finite or an error code")
                if dtype == torch.float32:
                    bound = (F32_EVENT_T if name == "events"
                             else F32_ADAPTIVE_VALUES)
                    _check(err_all <= bound and dsteps <= F32_ADAPTIVE_STEPS,
                           f"driver vs kernel {name} float32: max|d|="
                           f"{err_all}, max step diff {dsteps}")
                else:
                    bound = ATOL if name == "events" else F64_VALUES
                    _check(flip <= DRIVER_FLIP_SHARE and err_same <= bound,
                           f"driver vs kernel {name} float64: lanes whose "
                           f"counts differ {flip}, max|d| where equal "
                           f"{err_same}")
                res[name] = (err_all, err_same, dsteps, flip)
            if dtype == torch.float32:
                k_ms = _time_ms(torch, lambda: odeint_per_sample_with_stats(
                    model, yb, tb, rtol=RTOL, atol=ATOL,
                    options=dict(pallas=True)), 5)
                ke_ms = _time_ms(torch, lambda: odeint_per_sample_with_stats(
                    model, yb, t_evb, options=dict(
                        pallas=True, max_num_steps=EVENT_MAX_STEPS), **ekw),
                    5)
                d_ms = _wall_stats(torch, lambda: odeint_per_sample_with_stats(
                    model, yb, tb, rtol=RTOL, atol=ATOL)[1].n_steps.max(
                    ).item(), ENS_REPS)
                de_ms = _wall_stats(torch, lambda: odeint_per_sample_with_stats(
                    model, yb, t_evb, options=dict(
                        max_num_steps=EVENT_MAX_STEPS),
                    **ekw)[1].n_steps.max().item(), ENS_REPS)
                times = (k_ms, d_ms, ke_ms, de_ms)
                steps = (_spread(drv[1].n_steps), _spread(drv_ev[1].n_steps))
        rows.append((dtype, res))

    def brow(dtype, res):
        name = str(dtype).replace("torch.", "")
        return name + ": " + ", ".join(
            f"{k} max|d| {v[0]:.2e} (where counts agree {v[1]:.2e}), max "
            f"step diff {v[2]}, lanes whose counts differ {v[3]:.4f}"
            for k, v in res.items())

    print(f"[14b driver vs kernels] {card} | spiral B={B} H={H} T={T} rtol="
          f"{RTOL} atol={ATOL}: the driver (no pallas) against K-dopri5 and "
          f"K-events (pallas=True, one launch each; phase 8's LinearEvent, "
          f"max_num_steps={EVENT_MAX_STEPS}) | "
          + " | ".join(brow(*r) for r in rows)
          + f" (bounds: float32 {F32_ADAPTIVE_VALUES}/{F32_EVENT_T} and "
          f"{F32_ADAPTIVE_STEPS} steps; float64 {F64_VALUES}/{ATOL} where "
          f"counts agree, share <= {DRIVER_FLIP_SHARE}) | float32 times: "
          f"K-dopri5 "
          f"route {times[0]:.3f} ms, driver median {times[1][0]:.1f} ms (min "
          f"{times[1][1]:.1f}, max {times[1][2]:.1f}), steps {steps[0]}; "
          f"K-events route {times[2]:.3f} ms, driver median {times[3][0]:.1f}"
          f" ms (min {times[3][1]:.1f}, max {times[3][2]:.1f}), steps "
          f"{steps[1]} | {time.perf_counter() - p1:.1f} s")

    # (c) the per-sample gradient: float64 card against CPU, then a timed
    # float32 step at full width
    p1 = time.perf_counter()
    g_cpu = _ps_grads(torch, torch.device("cpu"), np.float64, PS_GRAD_B)
    g_dev = _ps_grads(torch, dev, np.float64, PS_GRAD_B)
    rel_g = _max_rel(g_dev, g_cpu)
    _check(rel_g <= GRAD_F64_REL, f"per-sample gradient card vs CPU {rel_g}")
    rel_ge = _max_rel(_ps_event_grads(torch, dev, PS_GRAD_B),
                      _ps_event_grads(torch, torch.device("cpu"), PS_GRAD_B))
    _check(rel_ge <= GRAD_F64_REL,
           f"per-sample event gradient card vs CPU {rel_ge}")
    model, y_big = _spiral(torch, torch.float32, dev)
    model.requires_grad_(True)
    field = _lane_spiral(torch, model)
    lam = torch.linspace(0.1, 0.5, B, device=dev).requires_grad_(True)
    y0g = y_big[:B].clone().requires_grad_(True)
    fwd, bwd = [], []
    for i in range(ENS_REPS + 1):
        marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        marks[0].record()
        ys, stg = odeint_per_sample_with_stats(
            field, y0g, tb, args=(lam,), args_axes=(0,), rtol=RTOL,
            atol=ATOL)
        loss = (ys ** 2).mean()
        marks[1].record()
        loss.backward()
        marks[2].record()
        torch.cuda.synchronize()
        if i:
            fwd.append(marks[0].elapsed_time(marks[1]))
            bwd.append(marks[1].elapsed_time(marks[2]))
        for p in (y0g, lam, *model.parameters()):
            p.grad = None
    _check(bool(torch.isfinite(loss)), "per-sample float32 loss")
    print(f"[14c per-sample gradient] {card} | the spiral with a per-sample "
          f"decay (args_axes=(0,)), loss mean(ys**2), .backward() to y0, the "
          f"MLPField's parameters and the decay: float64 B={PS_GRAD_B} card "
          f"vs CPU {rel_g:.2e} of max|g| (<= {GRAD_F64_REL}); through the "
          f"oscillators' per-sample first zeros (to y0 and omega) "
          f"{rel_ge:.2e} | float32 B={B}:"
          f" forward median {np.median(fwd):.1f} ms (min {min(fwd):.1f}, max "
          f"{max(fwd):.1f}), backward median {np.median(bwd):.1f} ms (min "
          f"{min(bwd):.1f}, max {max(bwd):.1f}) over {ENS_REPS} warm steps; "
          f"forward steps {_spread(stg.n_steps)}")

    # (d) benchmarks/bench_ensemble.py's scalar field at B=65536
    p1 = time.perf_counter()
    lam_np = np.logspace(0, np.log10(SCALAR_LAM_MAX), SCALAR_B).astype(
        np.float32)
    lam_d = torch.from_numpy(lam_np).to(dev)
    ys0 = torch.ones(SCALAR_B, 1, device=dev)
    t2 = torch.tensor([0.0, 2.0], dtype=torch.float64)
    skw = dict(args=(lam_d,), args_axes=(-1,), rtol=SCALAR_RTOL,
               atol=SCALAR_ATOL)

    def scalar(tt_, yy, l_):
        return -l_ * yy + torch.sin(tt_)

    with torch.no_grad():
        batched_rk.reset_lane_counts()
        ysc, stc = odeint_per_sample_with_stats(scalar, ys0, t2, **skw)
        torch.cuda.synchronize()
        sc_counts = dict(batched_rk.LANE_COUNTS)
        sc_ms = _wall_stats(torch, lambda: odeint_per_sample_with_stats(
            scalar, ys0, t2, **skw)[1].n_steps.max().item(), ENS_REPS)
    l64 = lam_np.astype(np.float64)
    exact = ((1 + 1 / (l64 ** 2 + 1)) * np.exp(-2 * l64)
             + (l64 * np.sin(2.0) - np.cos(2.0)) / (l64 ** 2 + 1))
    err_sc = float(np.abs(ysc[:, -1, 0].double().cpu().numpy()
                          - exact).max())
    _check(err_sc <= SCALAR_EXACT and int(stc.error_code.max()) == 0,
           f"scalar ensemble error {err_sc}")
    print(f"[14d scalar ensemble] {card} | benchmarks/bench_ensemble.py "
          f"'scalar' y' = -lam y + sin t, lam log-spaced over [1, "
          f"{SCALAR_LAM_MAX:.0f}] per sample, B={SCALAR_B}, dopri5 rtol="
          f"{SCALAR_RTOL} atol={SCALAR_ATOL}, t=(0, 2), float32 | warm solve "
          f"median {sc_ms[0]:.1f} ms (min {sc_ms[1]:.1f}, max {sc_ms[2]:.1f})"
          f" | steps min/median/max {_spread(stc.n_steps)}, driver iterations"
          f" {sc_counts['iterations']}, host reads {sc_counts['host_reads']} "
          f"| max|y(2) - exact| {err_sc:.2e} (<= {SCALAR_EXACT}) | "
          f"{time.perf_counter() - p1:.1f} s; phase 14 "
          f"{time.perf_counter() - p0:.1f} s")
    return ens_ms[0]


def _relax_i(t, y, lam):
    """Phase 12c's linear relaxation for one sample: y' = -lam (y - t) + 1,
    y of shape (1,)."""
    return -lam * (y - t) + 1.0


def _vdp_i(t, y, mu):
    """tests/test_stiff.py:68-85's van der Pol field, mu per sample."""
    import torch
    return torch.stack([y[1], mu * ((1 - y[0] ** 2) * y[1]) - y[0]])


def _ps_relax(torch, device, b, lam_range=(2.0, 4.0), dtype=None):
    """(a)'s problem per sample: lam = logspace(*lam_range, b) (phase 12c's
    logspace(2, 4, b) by default) and y0 = 1 + 0.5 u, y0 of shape (b, 1),
    t = linspace(0, 5, 5); and the exact solution (b, 5, 1)."""
    lam = torch.from_numpy(np.logspace(*lam_range, b)).to(device)
    u = np.random.RandomState(0).rand(b)
    y0 = torch.from_numpy(1.0 + 0.5 * u).to(device)[:, None]
    t = torch.linspace(0.0, 5.0, 5, dtype=torch.float64)
    tt_ = t.to(device)[None, :]
    exact = (tt_ + y0 * torch.exp(-lam[:, None] * tt_))[:, :, None]
    return lam, y0, t, exact


def _stats_list(st):
    import torch
    return [torch.as_tensor(x).cpu() for x in st[:5]]


def _card_vs_cpu(torch, dev, run, what, tol=None):
    """`run(device)` -> (values, Stats) on the card and on the CPU, float64:
    Stats equal and values within `tol` (F64_VALUES) of max|y|.  Returns
    the relative error."""
    vg, sg = run(dev)
    vc, sc = run("cpu")
    vg, vc = vg.detach().cpu(), vc.detach()
    fin = bool(torch.isfinite(vg).all()) and bool(torch.isfinite(vc).all())
    err = float((vg - vc).abs().max() / vc.abs().max())
    same = all(torch.equal(a, b) for a, b in zip(_stats_list(sg),
                                                 _stats_list(sc)))
    _check(same and fin and err <= (F64_VALUES if tol is None else tol),
           f"{what} card vs CPU: Stats equal {same}, all finite {fin}, "
           f"{err} of max|y|")
    return err


def _lane16_vs_plain(torch, kernels, dtype, model_g, model_c, y_g, b,
                     events):
    """One 16-bit K-dopri5 or K-events launch at a batch of b against its
    plain version on the same inputs on the CPU: (launch outputs, the
    share of lanes whose counts differ from the plain version's, the
    largest distance of the other lanes' values in units in the last place
    of max|y|, and the per-lane steps)."""
    yb = y_g[:b].T.contiguous()
    yc = yb.cpu()
    if events:
        ev_g, s0_g, ev_c = _ev16(torch, dtype, yb)
        kw = dict(rtol=LANE16_RTOL, atol=LANE16_ATOL,
                  max_steps=EVENT_MAX_STEPS)
        out = kernels.dopri5_events_batched(model_g, yb, 0.0, ev_g,
                                            ev_params=(s0_g,), **kw)
        ref = kernels.dopri5_events_batched_ref(
            model_c, yc, 0.0, ev_c, ev_params=(s0_g.cpu(),), **kw)
        vals, rvals = (out[0], out[1]), (ref[0], ref[1])
        counts, rcounts = out[2:], ref[2:]
    else:
        kw = dict(ts=LANE16_TS, rtol=LANE16_RTOL, atol=LANE16_ATOL)
        t1 = float(LANE16_TS[-1])
        out = kernels.dopri5_integrate_batched(model_g, yb, 0.0, t1, **kw)
        ref = kernels.dopri5_integrate_batched_ref(model_c, yc, 0.0, t1,
                                                   **kw)
        vals, rvals = (out[0],), (ref[0],)
        counts, rcounts = out[1:], ref[1:]
    return (out, *lane16_flips_and_ulps(torch, dtype, vals, rvals, counts,
                                        rcounts), counts[-1])


def lane16_flips_and_ulps(torch, dtype, vals, rvals, counts, rcounts):
    """(the share of lanes whose counts differ from the plain version's,
    the largest distance over every other lane in units in the last place
    of max|y|)."""
    same = None
    for g, w in zip(counts, rcounts):
        e = (g.cpu() == w).reshape(-1)
        same = e if same is None else same & e
    dist = torch.zeros(same.shape[0], dtype=torch.float64)
    for g, w in zip(vals, rvals):
        g, w = g.cpu().double(), w.double()
        ok = torch.isfinite(w)
        _check(torch.equal(torch.isfinite(g)[..., same], ok[..., same]),
               f"{dtype}: NaN rows differ from the plain version's")
        if not bool(ok.any()):
            continue
        # units in the last place of max|y| (a value near 0 has tiny ones,
        # while the step's rounding is relative to the state's size)
        unit = 2.0 ** (np.floor(np.log2(float(w[ok].abs().max())))
                       - (7 if dtype == torch.bfloat16 else 10))
        d = torch.where(ok, (g - w).abs(), torch.zeros_like(w)) / unit
        dist = torch.maximum(dist, d.reshape(-1, same.shape[0]).amax(0))
    kept = dist[same]
    return (1.0 - float(same.float().mean()),
            float(kept.max()) if kept.numel() else 0.0)


def traced16_flips_and_ulps(torch, dtype, vals, rvals, counts, rcounts):
    """(the number of lanes whose counts differ from the plain version's,
    the largest distance over every other lane in units in the last place
    of each component's own magnitude in that lane: an (S, D, B) output
    takes a component's largest |y| over the output times, a (K, B) one
    each value's own; the unit is never below the dtype's subnormal
    spacing, so a value of 0 must be 0)."""
    same = None
    for g, w in zip(counts, rcounts):
        e = (g.cpu() == w).reshape(-1)
        same = e if same is None else same & e
    mant = 7 if dtype == torch.bfloat16 else 10
    least = torch.finfo(dtype).tiny * 2.0 ** -mant
    dist = torch.zeros(same.shape[0], dtype=torch.float64)
    for g, w in zip(vals, rvals):
        g, w = g.cpu().double(), w.double()
        ok = torch.isfinite(w)
        _check(torch.equal(torch.isfinite(g)[..., same], ok[..., same]),
               f"{dtype}: NaN rows differ from the plain version's")
        mag = torch.where(ok, w.abs(), torch.zeros_like(w))
        if mag.dim() == 3:
            mag = mag.amax(0, keepdim=True)
        unit = torch.exp2(torch.floor(torch.log2(mag.clamp_min(least)))
                          - mant).clamp_min(least)
        d = torch.where(ok, (g - w).abs(), torch.zeros_like(w)) / unit
        dist = torch.maximum(dist, d.reshape(-1, same.shape[0]).amax(0))
    kept = dist[same]
    return (int((~same).sum()), float(kept.max()) if kept.numel() else 0.0)


def _ev16(torch, dtype, yb):
    """Phase 8's event family in a 16-bit dtype: a threshold on y[0] halfway
    through the batch's range, and a cut-off at t = 1."""
    from torchdiffeq_tpu_torch.models import LinearEvent
    dev = yb.device
    w = [[1.0, 0.0], [0.0, 0.0]]
    mk = lambda d: LinearEvent(w, time_coef=[0.0, 1.0], bias=[-0.5, -1.0],
                               dtype=dtype, device=d).requires_grad_(False)
    ev_g = mk(dev)
    s0 = torch.sign(ev_g.lanes(torch.zeros(1, yb.shape[1], dtype=dtype,
                                           device=dev), yb))
    return ev_g, s0, mk("cpu")


def _phase_per_sample_stiff(torch, kernels, dev, walls_12c):
    """Phase 15: the per-sample stiff, implicit and Adams tiers on batched
    Newton solves, the per-sample gradient modes and options, and the
    16-bit instances of K-dopri5 and K-events.  Returns their JSON
    entries."""
    from torchdiffeq_tpu_torch import (odeint_per_sample,
                                       odeint_per_sample_with_stats)
    from torchdiffeq_tpu_torch.solvers import batched_rk
    from torchdiffeq_tpu_torch.solvers.solution import (IMPLICIT_COUNTS,
                                                        reset_implicit_counts)
    card = _card()
    p0 = time.perf_counter()

    def med(x):
        x = x.cpu()
        return f"{int(x.min())}/{int(x.median())}/{int(x.max())}"

    # (a) phase 12c's relaxation, every sample its own controller and 1x1
    # Newton solves
    rows = []
    lam, y0, t, exact = _ps_relax(torch, dev, PS_STIFF_B)
    for method in ("kvaerno5", "radau5a"):
        clock = time.perf_counter()
        kw = dict(args=(lam,), args_axes=(0,), method=method,
                  rtol=STIFF_RTOL, atol=STIFF_ATOL)
        with torch.no_grad():
            # warms torch.func's transforms and the batched solves
            odeint_per_sample_with_stats(_relax_i, y0, t, options=dict(
                max_num_steps=2), **kw)
            reset_implicit_counts()
            batched_rk.reset_lane_counts()
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            ys, st = odeint_per_sample_with_stats(_relax_i, y0, t, **kw)
            torch.cuda.synchronize()
            wall = time.perf_counter() - w0
        counts, lanes = dict(IMPLICIT_COUNTS), dict(batched_rk.LANE_COUNTS)
        err = float((ys - exact).abs().max())
        _check(int(st.error_code.max()) == 0 and err <= STIFF_EXACT,
               f"per-sample {method}: codes {st.error_code.max()}, max "
               f"error vs exact {err}")
        b12, w12 = walls_12c.get(method, (None, float("nan")))
        rows.append(
            f"{method}: per-sample steps min/median/max {med(st.n_steps)}, "
            f"max|y - exact| {err:.2e}, warm wall {wall:.2f} s (phase 12c's "
            f"one controller and dense LU at B={b12}: {w12 / 1e3:.2f} s), "
            f"{lanes['iterations']} step iterations, Newton iterations "
            f"{counts['iterations']} (each one batched LU of B 1x1 systems), "
            f"host reads {counts['host_reads']} in stage solves + "
            f"{lanes['host_reads']} in the step loop; "
            f"{time.perf_counter() - clock:.1f} s")
    print(f"[15a per-sample stiff] {card} | y' = -lam (y - t) + 1 per sample, "
          f"lam = logspace(2, 4, {PS_STIFF_B}), t = linspace(0, 5, 5), rtol="
          f"{STIFF_RTOL} atol={STIFF_ATOL} float64, max error <= "
          f"{STIFF_EXACT} | " + " | ".join(rows), flush=True)

    # (b) a stiff van der Pol ensemble, mu per sample
    clock = time.perf_counter()
    mu_all = torch.from_numpy(np.logspace(0.0, 2.0, VDP_B))

    def vdp(device, mu, **opts):
        y = torch.tensor([2.0, 0.0], dtype=torch.float64).repeat(
            mu.shape[0], 1).to(device)
        tv = torch.linspace(0.0, VDP_T, 5, dtype=torch.float64)
        with torch.no_grad():
            return odeint_per_sample_with_stats(
                _vdp_i, y, tv, args=(mu.to(device),), args_axes=(0,),
                method="kvaerno5", rtol=1e-6, atol=1e-8, options=opts)

    vdp(dev, mu_all, max_num_steps=2)      # warms the timed path
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    ys_v, st_v = vdp(dev, mu_all)
    torch.cuda.synchronize()
    wall_v = time.perf_counter() - w0
    _check(int(st_v.error_code.max()) == 0
           and bool(torch.isfinite(ys_v).all())
           and float(ys_v[:, :, 0].abs().max()) < 2.5,
           f"van der Pol B={VDP_B}: codes {st_v.error_code.max()}, "
           f"max|y0| {float(ys_v[:, :, 0].abs().max())}")
    # VDP_CHECK_B of the timed run's own samples, mu from 1 to 100, against
    # the same samples solved on the CPU (each sample's solve is its own)
    pick = torch.from_numpy(np.linspace(0, VDP_B - 1, VDP_CHECK_B).round()
                            .astype(np.int64))
    err_v = _card_vs_cpu(
        torch, dev, lambda d: (ys_v[pick.to(dev)], [x[pick.to(dev)] for x in
                                                    st_v[:5]])
        if d == dev else vdp(d, mu_all[pick]),
        f"van der Pol, {VDP_CHECK_B} of B={VDP_B}")
    print(f"[15b van der Pol] {card} | mu = logspace(0, 2, B) per sample, "
          f"y0 = (2, 0), t = linspace(0, {VDP_T}, 5), kvaerno5 rtol 1e-6 "
          f"atol 1e-8 float64 | B={VDP_B}: steps min/median/max "
          f"{med(st_v.n_steps)}, warm wall {wall_v:.2f} s, |y0| <= 2.5 on "
          f"the limit cycle | {VDP_CHECK_B} of its samples (mu 1 to 100) "
          f"card vs CPU {err_v:.2e} of max|y|, Stats equal | "
          f"{time.perf_counter() - clock:.1f} s", flush=True)

    # (c) Adams and FIRK/DIRK per sample on (a)'s field, B=32: lam =
    # logspace(2, 4) for the stiff FIRK/DIRK, logspace(0, 1) for
    # implicit_adams, whose corrector is a fixed-point iteration that
    # converges where lam h is small (h = 0.05 here)
    clock = time.perf_counter()
    rows = []
    for method, opts, lams in (
            ("implicit_adams", dict(num_steps=PS_FIXED_STEPS), (0.0, 1.0)),
            ("gl4", dict(num_steps=PS_FIXED_STEPS), (2.0, 4.0)),
            ("trbdf2", dict(num_steps=PS_FIXED_STEPS, root_solver="newton"),
             (2.0, 4.0))):
        def run(device, method=method, opts=opts, lams=lams):
            lam_, y0_, t_, _ = _ps_relax(torch, device, PS_IMPLICIT_B, lams)
            with torch.no_grad():
                return odeint_per_sample_with_stats(
                    _relax_i, y0_, t_, args=(lam_,), args_axes=(0,),
                    method=method, options=opts)
        err_c = _card_vs_cpu(torch, dev, run, f"per-sample {method}")
        ys_c, st_c = run(dev)
        _check(int(st_c.error_code.max()) == 0,
               f"per-sample {method}: codes {st_c.error_code.max()}")
        rows.append(f"{method} lam = logspace({lams[0]:g}, {lams[1]:g}) "
                    f"{err_c:.2e} (nfe {med(st_c.nfe)}, all "
                    f"{PS_IMPLICIT_B} samples finite, codes 0)")
    print(f"[15c Adams, FIRK/DIRK per sample] {card} | (a)'s field B="
          f"{PS_IMPLICIT_B} num_steps={PS_FIXED_STEPS} float64 card vs CPU "
          f"(of max|y|, Stats equal): " + ", ".join(rows)
          + f" | {time.perf_counter() - clock:.1f} s", flush=True)

    # (d) per-sample gradients on (a)'s problem, B=8, cut to t <= PS_GRAD_T
    clock = time.perf_counter()
    rows = []

    def grads(device, mode):
        lam_, y0_, _, _ = _ps_relax(torch, device, PS_OPT_B)
        t_ = torch.linspace(0.0, PS_GRAD_T, 3, dtype=torch.float64)
        opts = dict(replay_grad=dict(replay_grad=True),
                    forward_grad=dict(forward_grad=True)).get(mode)
        kw = dict(args_axes=(0,), method="kvaerno5", rtol=1e-6, atol=1e-8,
                  options=opts)
        if mode == "forward_grad":
            dy = torch.ones_like(y0_)
            _, tan = torch.func.jvp(
                lambda y: odeint_per_sample(_relax_i, y, t_, args=(lam_,),
                                            **kw), (y0_,), (dy,))
            return [tan]
        y0_ = y0_.clone().requires_grad_(True)
        lam_ = lam_.clone().requires_grad_(True)
        ys = odeint_per_sample(_relax_i, y0_, t_, args=(lam_,), **kw)
        (ys ** 2).sum().backward()
        return [y0_.grad, lam_.grad]

    for mode in ("adjoint", "replay_grad", "forward_grad"):
        w = time.perf_counter()
        g_g = [g.cpu() for g in grads(dev, mode)]
        wall = time.perf_counter() - w
        g_c = grads("cpu", mode)
        rel = _max_rel(g_g, g_c)
        _check(rel <= GRAD_F64_REL, f"per-sample kvaerno5 {mode}: card vs "
               f"CPU {rel} of max|g|")
        rows.append(f"{mode} {rel:.2e} ({wall:.2f} s on the card)")
    print(f"[15d per-sample gradients] {card} | (a)'s problem B={PS_OPT_B} "
          f"on t in [0, {PS_GRAD_T}], kvaerno5 rtol 1e-6 atol 1e-8 float64, "
          f"card vs CPU of max|g| (<= {GRAD_F64_REL}): " + ", ".join(rows)
          + f" | {time.perf_counter() - clock:.1f} s", flush=True)

    # (e) a callback, a grid_constructor and the fixed-grid event gradient
    clock = time.perf_counter()

    class Counted:
        def __init__(self):
            self.seen = []

        def __call__(self, t_, y, lam_):
            return _relax_i(t_, y, lam_)

        def callback_step(self, t0, y, dt):
            self.seen.append(float(y[0]))

    def with_cb(device):
        lam_, y0_, t_, _ = _ps_relax(torch, device, PS_OPT_B)
        f = Counted()
        with torch.no_grad():
            ys, st = odeint_per_sample_with_stats(
                f, y0_, t_, args=(lam_,), args_axes=(0,), method="kvaerno5",
                rtol=1e-6, atol=1e-8)
        _check(len(f.seen) == int(st.n_steps.sum()),
               f"callbacks fired {len(f.seen)} times for "
               f"{int(st.n_steps.sum())} steps")
        return ys, st

    err_cb = _card_vs_cpu(torch, dev, with_cb, "per-sample callbacks")

    def with_grid(device):
        lam_, y0_, t_, _ = _ps_relax(torch, device, PS_OPT_B)

        def grid(f, y, tt_):
            frac = torch.linspace(0.0, 1.0, 41, dtype=torch.float64)
            return tt_[0] + (tt_[-1] - tt_[0]) * frac ** (1.5 + 0.1 * float(
                y[0]))
        with torch.no_grad():
            return odeint_per_sample_with_stats(
                _relax_i, y0_, t_, args=(lam_,), args_axes=(0,),
                method="implicit_euler", options=dict(grid_constructor=grid))

    err_grid = _card_vs_cpu(torch, dev, with_grid,
                            "per-sample grid_constructor")
    # grids that differ by sample take one solve a sample (a host loop):
    # its cost grows with B
    torch.cuda.synchronize()
    w0 = time.perf_counter()
    with_grid(dev)
    torch.cuda.synchronize()
    wall_grid = time.perf_counter() - w0

    def fixed_event_grads(device):
        mu = torch.linspace(1.0, 3.0, PS_OPT_B,
                            dtype=torch.float64).to(device).requires_grad_()
        y = torch.tensor([1.0, 0.0], dtype=torch.float64).repeat(
            PS_OPT_B, 1).to(device).requires_grad_()
        (_, ys2), _ = odeint_per_sample_with_stats(
            lambda t_, y_, m: torch.stack([y_[1], -m * y_[0]]), y,
            torch.tensor([0.0, 5.0], dtype=torch.float64), args=(mu,),
            args_axes=(0,), method="rk4", options=dict(step_size=0.01),
            event_fn=lambda t_, y_: y_[0] - 0.5)
        (ys2[:, 1] ** 2).sum().backward()
        return [y.grad.cpu(), mu.grad.cpu()]

    rel_ev = _max_rel(fixed_event_grads(dev), fixed_event_grads("cpu"))
    _check(rel_ev <= GRAD_F64_REL, f"fixed-grid event gradient card vs CPU "
           f"{rel_ev} of max|g|")
    print(f"[15e per-sample options] {card} | (a)'s problem B={PS_OPT_B} "
          f"float64 card vs CPU: a callback_step (fired once a sample a "
          f"step) {err_cb:.2e}, a grid_constructor per sample "
          f"(implicit_euler, 40 steps) {err_grid:.2e} of max|y|, Stats "
          f"equal, {wall_grid:.2f} s warm on the card ({PS_OPT_B} solves, "
          f"one a sample) | rk4 "
          f"event gradient (step_size 0.01) {rel_ev:.2e} of max|g| | "
          f"{time.perf_counter() - clock:.1f} s", flush=True)

    entries = _phase_lanes16(torch, kernels, dev, card)
    total = time.perf_counter() - p0
    print(f"[15g budget] phase 15 took {total:.1f} s (aim: about "
          f"{PS_BUDGET_S} s)", flush=True)
    return entries


def _phase_lanes16(torch, kernels, dev, card):
    """Phase 15 (f): K-dopri5 and K-events in bfloat16 and float16, through
    the per-sample route and against their plain versions, timed three
    ways at B and BIG_B.  Returns their JSON entries."""
    from torchdiffeq_tpu_torch import odeint_per_sample_with_stats
    from torchdiffeq_tpu_torch.ops.tableaus import DOPRI5 as DOPRI5_TAB
    clock = time.perf_counter()
    entries, rows = [], []
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        model_g, y_g = _spiral(torch, torch.float32, dev)
        model_g, y_g = model_g.to(dtype), y_g.to(dtype)
        model_c = _spiral(torch, torch.float32, "cpu")[0].to(dtype)
        # launched through the entry point a user calls
        kernels.reset_launch_counts()
        with torch.no_grad():
            ys_r, st_r = odeint_per_sample_with_stats(
                model_g, y_g[:B], torch.from_numpy(LANE16_TS),
                rtol=LANE16_RTOL, atol=LANE16_ATOL, options=dict(pallas=True))
            (et_r, _), st_e = odeint_per_sample_with_stats(
                model_g, y_g[:B], torch.tensor([0.0, 20.0]),
                rtol=LANE16_RTOL, atol=LANE16_ATOL, options=dict(
                    pallas=True, max_num_steps=EVENT_MAX_STEPS),
                event_fn=_ev16(torch, dtype, y_g[:B].T)[0])
        torch.cuda.synchronize()
        launches = dict(kernels.launch_counts)
        _check(launches["dopri5_integrate_batched"] == 1
               and launches["dopri5_events_batched"] == 1
               and ys_r.dtype == dtype
               and bool(torch.isfinite(ys_r).all())
               and int(st_r.error_code.max()) == 0,
               f"{tag} per-sample kernel route: launches {launches}, codes "
               f"{st_r.error_code.max()}")
        for events in (False, True):
            name = ("dopri5_events_batched" if events
                    else "dopri5_integrate_batched")
            times, flips, errs, stp = {}, {}, {}, {}
            with torch.no_grad():
                for b in (B, BIG_B):
                    out, flips[b], errs[b], stp[b] = _lane16_vs_plain(
                        torch, kernels, dtype, model_g, model_c, y_g, b,
                        events)
                    print(f"[15f reading] {tag} {name} B={b}: lanes with "
                          f"other counts {flips[b]}, the others within "
                          f"{errs[b]} ULPs of max|y|", flush=True)
                    _check(flips[b] <= LANE16_FLIP_SHARE
                           and errs[b] <= LANE16_ULPS[tag],
                           f"{tag} {name} B={b}: lanes with other counts "
                           f"{flips[b]}, the others within {errs[b]} ULPs")
                    yb = y_g[:b].T.contiguous()
                    if events:
                        ev_g, s0, _ = _ev16(torch, dtype, yb)
                        kw = dict(rtol=LANE16_RTOL, atol=LANE16_ATOL,
                                  max_steps=EVENT_MAX_STEPS,
                                  ev_params=(s0,))
                        times[b] = _three_times(
                            torch, lambda: kernels.dopri5_events_batched(
                                model_g, yb, 0.0, ev_g, **kw),
                            kernels._events_launch(model_g, yb, 0.0, ev_g,
                                                   **kw)[0],
                            lambda: kernels.dopri5_events_batched_ref(
                                model_g, yb, 0.0, ev_g, **kw),
                            kernels._lane_group_width(b, H))
                    else:
                        kw = dict(ts=LANE16_TS, rtol=LANE16_RTOL,
                                  atol=LANE16_ATOL)
                        t1 = float(LANE16_TS[-1])
                        times[b] = _three_times(
                            torch, lambda: kernels.dopri5_integrate_batched(
                                model_g, yb, 0.0, t1, **kw),
                            kernels._lanes_launch(model_g, yb, 0.0, t1,
                                                  **kw)[0],
                            lambda: kernels.dopri5_integrate_batched_ref(
                                model_g, yb, 0.0, t1, **kw),
                            kernels._lane_group_width(b, H))
            S = len(LANE16_TS)

            def bound(n_steps, b):
                # 16-bit operations at PEAK_F16, float sums at PEAK_F32;
                # events: 40 bisection steps of a quartic (8 operations a
                # row) and K=2 events, whose dot products sum in float
                n16, n32 = _lane_flops(n_steps, DOPRI5_TAB, 2, H, 3,
                                       split=True)
                if events:
                    return _bound(
                        [(n16 + 40 * b * (8 * 2 + 2 * 3), PEAK_F16),
                         (n32 + 40 * b * 2 * 2 * 2, PEAK_F32)],
                        (2 + 2) * b * 2 + (1 + 2) * b * 2 + 3 * b * 4, None)
                return _bound([(n16, PEAK_F16), (n32, PEAK_F32)],
                              (1 + S) * b * 2 * 2 + 2 * b * 4, None)
            entry = dict(
                name=f"{name}[{tag}]", route="cuda",
                source=("torchdiffeq_tpu_torch/csrc/dopri5_events_16bit.cu"
                        if events else
                        "torchdiffeq_tpu_torch/csrc/dopri5_lanes_16bit.cu"),
                replaces=("torchdiffeq_tpu/ops/pallas_kernels.py:580" if events
                          else "torchdiffeq_tpu/ops/pallas_kernels.py:336"),
                launches=launches[name], max_abs_err=errs[B],
                max_err_unit="16-bit ULPs of max|y|, over every lane whose "
                "counts equal the plain version's",
                count_flip_share=flips[B],
                count_flip_share_65536=flips[BIG_B],
                max_abs_err_65536=errs[BIG_B], **_times_entry(times),
                **dict(zip(("bound_ms", "bound_by"), bound(stp[B], B))),
                bound_ms_65536=bound(stp[BIG_B], BIG_B)[0], library_ms=None)
            entries.append(entry)
            rows.append(
                f"{name}[{tag}]: launches {launches[name]}, lanes with other "
                f"counts than the plain version's {flips[B]:.4f} (B={B}) / "
                f"{flips[BIG_B]:.4f} (B={BIG_B}) (<= {LANE16_FLIP_SHARE}), "
                f"the others within {errs[B]:.2f} / {errs[BIG_B]:.2f} ULPs "
                f"of max|y| (<= {LANE16_ULPS[tag]}), "
                f"steps {int(stp[B].min())}.."
                f"{int(stp[B].max())}, bound {entry['bound_ms']:.4f} ms | "
                + " | ".join(_times_row(b, t) for b, t in times.items()))
    print(f"[15f 16-bit lanes] {card} | spiral rtol={LANE16_RTOL} atol="
          f"{LANE16_ATOL}, odeint_per_sample(pallas=True) and the kernels "
          f"against their plain versions on the CPU | " + " | ".join(rows)
          + f" | {time.perf_counter() - clock:.1f} s", flush=True)
    return entries


# ---- phase 17: the examples ---------------------------------------------------

# - phase 17, the examples (torchdiffeq_tpu_torch/examples/).  (a) The
#   traced K-dopri5 and K-events instances of examples/ensemble.py's field
#   and event against their plain versions on the same CUDA tensors:
#   float32 values (event times) within F32_ADAPTIVE_VALUES (F32_EVENT_T)
#   and steps within F32_ADAPTIVE_STEPS, as the hand-written instances;
#   float64 the share of lanes whose counts differ within C7's
#   DRIVER_FLIP_SHARE, values within F64_VALUES on the others.  (b)-(d)
#   one float64 training step on the card against the same step on the
#   CPU: the same solves but for the products' summation order and libm's
#   last bit, so the loss within EX_LOSS_F64 and the gradients within
#   EX_GRAD_F64 of max|g| (latent_ode: every trajectory's solve, cnf: a
#   hypernetwork's jvp probes inside the field, all through the adjoint's
#   backward).  (f) bouncing_ball's five gradients card against CPU within
#   EX_GRAD_F64; against finite differences within the example's own 1e-3.
#   Each traced entry of (a) and of phase 18 (b) gives its slowest lane's
#   steps and the device ns a step of that lane (`_slowest_lane`): an
#   instance runs one lane a trajectory and lasts as long as that lane's
#   chain of steps, which the redesigned instances shorten (the tableau
#   compiled into the instance; `redesigned` names the change).
EX_LOSS_F64 = 1e-10
EX_GRAD_F64 = 1e-8
PEAK_F64 = 34e12   # float64 FLOP/s outside the tensor cores (data sheet, SXM)
EX_ITERS = 20      # ode_demo's timed iterations (of 2000)
EX_STEPS = 3       # latent_ode, cnf and odenet_mnist's timed steps (few
#                    to keep the script in its time limit)
LATENT_CPU_B = 8   # latent_ode's card-vs-CPU batch (the CPU side's cost)
CNF_CPU_B = 64     # cnf's card-vs-CPU batch


def _traced_bound(n_steps, tableau, D, field_ops, peak, esize, S=0,
                  event_ops=None, K=0):
    """A traced instance's bound over this run's per-lane step counts: the
    field's traced operations at each evaluation (FSAL), the stage, error
    and controller sums (as `_lane_flops`), and for K-events the event at
    each step and 40 bisection steps (a quartic row, 8 operations, and the
    event); y0 and the per-lane arg read, the rows and counters written."""
    n, b = int(n_steps.sum()), n_steps.numel()
    terms = int(np.count_nonzero(tableau.beta)) + int(
        np.count_nonzero(tableau.c_error))
    ops = (((tableau.n_stages - 1) * n + 2 * b) * field_ops
           + n * (2 * D * terms + 12 * D))
    nbytes = (D + 1) * b * esize + S * D * b * esize + 2 * b * 4
    if event_ops is not None:
        ops += n * event_ops + 40 * b * (8 * D + event_ops)
        nbytes += K * b * esize + (1 + D) * b * esize + b * 4
    return _bound(ops, nbytes, peak)


def _slowest_lane(n_steps, device_ms):
    """(the slowest lane's steps, the device ns a step of that lane): a
    traced instance runs one lane a trajectory, so it lasts as long as its
    slowest lane's chain of steps."""
    worst = int(n_steps.max())
    return worst, device_ms * 1e6 / max(worst, 1)


def _flips(got, want):
    """The share of lanes whose counts (the trailing (1, B) outputs)
    differ, and the mask of the others."""
    same = None
    for g, w in zip(got, want):
        eq = (g[0] == w[0])
        same = eq if same is None else same & eq
    return 1.0 - float(same.float().mean()), same


def _bwd_nfe(bwd):
    """The last backward solve's NFE that `bwd` recorded."""
    return int(bwd.stats[-1].nfe) if bwd.stats else "not recorded"


def _event_ms(torch):
    return torch.cuda.Event(enable_timing=True)


def _timed_steps(torch, step, n):
    """`n` calls of `step(i)`, each between CUDA events: (ms per call)."""
    out = []
    for i in range(n):
        a, b = _event_ms(torch), _event_ms(torch)
        a.record()
        step(i)
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return out


def _ms_row(ms):
    return (f"median {np.median(ms):.1f} ms (min {min(ms):.1f}, max "
            f"{max(ms):.1f})")


def _ex_traced(torch, kernels, dev, driver_ms, card):
    """Phase 17 (a): examples/ensemble.py through its entry point with the
    launch counts reset before and read after, then its two traced kernel
    calls at B=1024 in float32 and float64 against their plain versions,
    timed three ways.  Returns the two JSON entries."""
    from torchdiffeq_tpu_torch.examples import ensemble
    from torchdiffeq_tpu_torch.ops import _build, traced
    from torchdiffeq_tpu_torch.ops.tableaus import DOPRI5 as DOPRI5_TAB
    p0 = time.perf_counter()
    kernels.reset_launch_counts()
    w0 = time.perf_counter()
    out = ensemble.main(["--batch", str(ENS_B)])
    torch.cuda.synchronize()
    main_s = time.perf_counter() - w0
    launched = dict(kernels.traced_launch_counts)
    _check(all(n > 0 for n in launched.values()),
           f"a traced instance was not launched by the ensemble: {launched}")
    first_builds = dict(_build.traced_builds)
    res = {}
    for dtype, tag, peak in ((torch.float32, "f32", PEAK_F32),
                             (torch.float64, "f64", PEAK_F64)):
        omega, y0, t = ensemble.make_problem(ENS_B, dev, dtype)
        y0T = y0.T.contiguous()
        field = traced.PerSampleField(ensemble.field, (omega,), (-1,))
        event = traced.PerSampleEvent(ensemble.event_fn)
        kw = dict(ts=t.numpy(), rtol=ENS_RTOL, atol=ENS_RTOL * 1e-2)
        sign0 = torch.sign(y0T[:1]).contiguous()
        ekw = dict(rtol=ENS_RTOL, atol=ENS_RTOL * 1e-2, ev_params=(sign0,))
        with torch.no_grad():
            got = kernels.dopri5_integrate_batched(field, y0T, 0.0, 2.0, **kw)
            want = kernels.dopri5_integrate_batched_ref(field, y0T, 0.0, 2.0,
                                                        **kw)
            got_e = kernels.dopri5_events_batched(field, y0T, 0.0, event,
                                                  **ekw)
            want_e = kernels.dopri5_events_batched_ref(field, y0T, 0.0, event,
                                                       **ekw)
            lanes_launch = kernels._lanes_launch(field, y0T, 0.0, 2.0, **kw)[0]
            events_launch = kernels._events_launch(field, y0T, 0.0, event,
                                                   **ekw)[0]
            t_l = _three_times(
                torch, lambda: kernels.dopri5_integrate_batched(
                    field, y0T, 0.0, 2.0, **kw), lanes_launch,
                lambda: kernels.dopri5_integrate_batched_ref(
                    field, y0T, 0.0, 2.0, **kw), 1)
            t_e = _three_times(
                torch, lambda: kernels.dopri5_events_batched(
                    field, y0T, 0.0, event, **ekw), events_launch,
                lambda: kernels.dopri5_events_batched_ref(
                    field, y0T, 0.0, event, **ekw), 1)
        flip_l, same_l = _flips(got[1:], want[1:])
        flip_e, same_e = _flips(got_e[2:], want_e[2:])
        err_l = float((got[0] - want[0])[..., same_l].abs().max())
        err_e = float((got_e[0] - want_e[0])[..., same_e].abs().max())
        dstp = int((got[2] - want[2]).abs().max())
        dstp_e = int((got_e[4] - want_e[4]).abs().max())
        if dtype == torch.float32:
            err_l = float((got[0] - want[0]).abs().max())
            err_e = float((got_e[0] - want_e[0]).abs().max())
            _check(err_l <= F32_ADAPTIVE_VALUES and err_e <= F32_EVENT_T
                   and max(dstp, dstp_e) <= F32_ADAPTIVE_STEPS,
                   f"traced float32 vs plain: {err_l}, {err_e}, steps "
                   f"{dstp}, {dstp_e}")
        else:
            _check(max(flip_l, flip_e) <= DRIVER_FLIP_SHARE
                   and max(err_l, err_e) <= F64_VALUES,
                   f"traced float64 vs plain: flips {flip_l}, {flip_e}, "
                   f"values {err_l}, {err_e}")
        src_l, src_e = lanes_launch.source, events_launch.source
        esize = y0.element_size()
        res[tag] = dict(
            err_l=err_l, err_e=err_e, flip_l=flip_l, flip_e=flip_e,
            t_l=t_l, t_e=t_e, steps=got[2], steps_e=got_e[4],
            bound_l=_traced_bound(got[2], DOPRI5_TAB, 2, src_l.field_ops,
                                  peak, esize, S=len(kw["ts"])),
            bound_e=_traced_bound(got_e[4], DOPRI5_TAB, 2, src_e.field_ops,
                                  peak, esize, event_ops=src_e.event_ops,
                                  K=src_e.K),
            ops=(src_l.field_ops, src_e.event_ops))
    builds = ", ".join(f"{s:.1f} s" for s in _build.traced_builds.values())
    first = ", ".join(f"{s:.1f} s" for s in first_builds.values())
    rows = []
    for tag, r in res.items():
        r["slow_l"] = _slowest_lane(r["steps"], r["t_l"]["device_ms"])
        r["slow_e"] = _slowest_lane(r["steps_e"], r["t_e"]["device_ms"])
        rows.append(
            f"{tag}: K-dopri5 traced max|d| {r['err_l']:.3e}, lanes whose "
            f"counts differ {r['flip_l']:.4f}, steps {_spread(r['steps'])}, "
            f"wrapper {r['t_l']['ms']:.4f} ms, bare {r['t_l']['bare_ms']:.4f}"
            f" ms, device {r['t_l']['device_ms']:.4f} ms ({r['slow_l'][1]:.1f}"
            f" ns a step of the slowest lane's {r['slow_l'][0]}), plain "
            f"{r['t_l']['plain_ms']:.1f} ms, bound {r['bound_l'][0]:.4f} ms "
            f"({r['bound_l'][1]}); K-events traced max|d event_t| "
            f"{r['err_e']:.3e}, lanes whose counts differ {r['flip_e']:.4f}, "
            f"steps {_spread(r['steps_e'])}, wrapper {r['t_e']['ms']:.4f} ms,"
            f" bare {r['t_e']['bare_ms']:.4f} ms, device "
            f"{r['t_e']['device_ms']:.4f} ms ({r['slow_e'][1]:.1f} ns a step "
            f"of the slowest lane's {r['slow_e'][0]}), plain "
            f"{r['t_e']['plain_ms']:.1f} ms, bound {r['bound_e'][0]:.4f} ms "
            f"({r['bound_e'][1]})")
    print(f"[17a traced kernels] {card} | examples/ensemble.py main B={ENS_B}"
          f" float32 on the card {main_s:.1f} s (kernel vs driver max diff "
          f"{out['err']:.2e} < 1e-2, events max rel dev {out['rel']:.2%} < "
          f"5%), traced launches {launched} | field ops an evaluation "
          f"{res['f32']['ops'][0]}, event ops {res['f32']['ops'][1]} | "
          f"first-use builds {first} (all traced builds this process: "
          f"{builds}) | "
          + " | ".join(rows)
          + f" | the batched driver on the same ensemble (phase 14a): "
          f"median {driver_ms:.1f} ms a solve | {time.perf_counter() - p0:.1f} s")
    entries = []
    for name, src_file, replaces, key, err, times, bound, n in (
            ("dopri5_integrate_batched_traced",
             "torchdiffeq_tpu_torch/csrc/dopri5_lanes.cuh",
             "torchdiffeq_tpu/ops/pallas_kernels.py:336", "l", "err_l", "t_l",
             "bound_l", launched["dopri5_integrate_batched"]),
            ("dopri5_events_batched_traced",
             "torchdiffeq_tpu_torch/csrc/dopri5_events.cuh",
             "torchdiffeq_tpu/ops/pallas_kernels.py:580", "e", "err_e", "t_e",
             "bound_e", launched["dopri5_events_batched"])):
        f32, f64 = res["f32"], res["f64"]
        entries.append(dict(
            name=name, route="cuda", source=src_file, replaces=replaces,
            emitted_by="torchdiffeq_tpu_torch/ops/traced.py",
            field="examples/ensemble.py's oscillators, B=1024",
            launches=n, max_abs_err=f32[err], **f32[times],
            bound_ms=f32[bound][0], bound_by=f32[bound][1],
            max_abs_err_f64=f64[err], count_flip_share_f64=f64["flip_" + key],
            ms_f64=f64[times]["ms"], bare_ms_f64=f64[times]["bare_ms"],
            device_ms_f64=f64[times]["device_ms"],
            plain_ms_f64=f64[times]["plain_ms"], bound_ms_f64=f64[bound][0],
            max_lane_steps=f32["slow_" + key][0],
            ns_per_step=f32["slow_" + key][1],
            max_lane_steps_f64=f64["slow_" + key][0],
            ns_per_step_f64=f64["slow_" + key][1], redesigned="PR 19",
            first_build_s=list(first_builds.values()),
            driver_ms=driver_ms, library_ms=None))
    return entries


def _ex_ode_demo(torch, card):
    """Phase 17 (b): ode_demo at its defaults with `odeint` and with
    ``--adjoint``: EX_ITERS training iterations and one test solve over the
    1000 points, timed; forward and backward NFE; one float64 step on the
    card against the CPU."""
    from torchdiffeq_tpu_torch import odeint, odeint_with_stats
    from torchdiffeq_tpu_torch.examples import ode_demo
    from torchdiffeq_tpu_torch.examples._optim import RMSprop
    p0 = time.perf_counter()
    rows = []
    for flag in ([], ["--adjoint"]):
        args = ode_demo.parser.parse_args(flag)
        gen = torch.Generator().manual_seed(args.seed)
        true_y0, t, true_y = ode_demo.make_data(args, "cuda", torch.float32)
        model = ode_demo.init_model(args, gen, "cuda", torch.float32)
        opt = RMSprop(model.parameters(), 1e-3)
        batches = [ode_demo.get_batch(ode_demo.draw_batch(gen, args), args, t,
                                      true_y) for _ in range(EX_ITERS + 1)]
        ode_demo.train_step(model, opt, batches[-1], args)   # warm
        with _BackwardStats() as bwd:
            ms = _timed_steps(torch, lambda i: ode_demo.train_step(
                model, opt, batches[i], args), EX_ITERS)
        with torch.no_grad():
            _, st_f = odeint_with_stats(model, batches[0][0], batches[0][1],
                                        rtol=1e-7, atol=1e-9)
            a, b = _event_ms(torch), _event_ms(torch)
            a.record()
            pred = odeint(model, true_y0, t, method=args.method)
            b.record()
            torch.cuda.synchronize()
            test_loss = float(torch.mean(torch.abs(pred - true_y)))
        _check(np.isfinite(test_loss), "ode_demo test loss")
        rows.append(
            f"{'odeint_adjoint' if flag else 'odeint'}: {EX_ITERS} iterations"
            f" {_ms_row(ms)}, forward nfe {int(st_f.nfe)}, backward nfe "
            f"{_bwd_nfe(bwd)}; test solve over {args.data_size} "
            f"points {a.elapsed_time(b):.1f} ms, loss {test_loss:.4f}")
    # one float64 step, card against CPU
    out = {}
    for dev in ("cuda", "cpu"):
        args = ode_demo.parser.parse_args(["--device", dev])
        gen = torch.Generator().manual_seed(args.seed)
        _, t, true_y = ode_demo.make_data(args, dev, torch.float64)
        model = ode_demo.init_model(args, gen, dev, torch.float64)
        batch = ode_demo.get_batch(ode_demo.draw_batch(gen, args), args, t,
                                   true_y)
        loss = ode_demo.train_step(model, RMSprop(model.parameters(), 1e-3),
                                   batch, args)
        out[dev] = float(loss), [p.grad for p in model.parameters()]
    d_loss = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    rel = _max_rel(out["cuda"][1], out["cpu"][1])
    _check(d_loss <= EX_LOSS_F64 and rel <= EX_GRAD_F64,
           f"ode_demo float64 card vs CPU: loss {d_loss}, gradients {rel}")
    print(f"[17b ode_demo] {card} | batch 20 x 10 points, MLP 2-50-2 of y**3,"
          f" dopri5 rtol 1e-7 atol 1e-9, float32 | " + " | ".join(rows)
          + f" | float64 step card vs CPU: loss {d_loss:.2e} (<= "
          f"{EX_LOSS_F64}), gradients {rel:.2e} of max|g| (<= {EX_GRAD_F64})"
          f" | cut: {EX_ITERS} of 2000 iterations | "
          f"{time.perf_counter() - p0:.1f} s")


def _ex_latent(torch, card):
    """Phase 17 (c): latent_ode at its defaults (100 spirals), EX_STEPS
    training steps timed, the driver's iterations and each trajectory's
    steps; a float64 step card against CPU at LATENT_CPU_B spirals."""
    from torchdiffeq_tpu_torch.examples import latent_ode
    from torchdiffeq_tpu_torch.examples._optim import Adam
    from torchdiffeq_tpu_torch.solvers import batched_rk
    p0 = time.perf_counter()
    args = latent_ode.parser.parse_args([])
    gen = torch.Generator().manual_seed(args.seed)
    trajs, ts = latent_ode.generate_spirals(args, "cuda")
    ts = ts.double().cpu()
    params = latent_ode.init_params(args, gen, "cuda")
    opt = Adam(params.parameters(), args.lr)
    eps = [torch.randn((args.nspiral, args.latent_dim), generator=gen).cuda()
           for _ in range(EX_STEPS + 1)]
    latent_ode.train_step(params, opt, trajs, ts, eps[-1], args.noise_std)
    batched_rk.reset_lane_counts()
    losses = []
    ms = _timed_steps(torch, lambda i: losses.append(latent_ode.train_step(
        params, opt, trajs, ts, eps[i], args.noise_std)), EX_STEPS)
    iters = batched_rk.LANE_COUNTS["iterations"] / EX_STEPS
    with torch.no_grad():
        mean, logvar = latent_ode.encode(params, trajs)
        _, st = latent_ode.latent_solve(
            params, mean + eps[0] * torch.exp(0.5 * logvar), ts,
            with_stats=True)
    _check(all(np.isfinite(float(x)) for x in losses), "latent_ode loss")
    out = {}
    cargs = latent_ode.parser.parse_args(["--nspiral", str(LATENT_CPU_B)])
    for dev in ("cuda", "cpu"):
        g = torch.Generator().manual_seed(1)
        tr, tt_ = latent_ode.generate_spirals(cargs, dev)
        p = latent_ode.init_params(cargs, g, dev, torch.float64)
        e = torch.randn((LATENT_CPU_B, cargs.latent_dim), generator=g,
                        dtype=torch.float64).to(dev)
        loss = latent_ode.elbo_loss(p, tr.double(), tt_.double().cpu(), e,
                                    cargs.noise_std)
        loss.backward()
        out[dev] = float(loss.detach()), [q.grad for q in p.parameters()]
    d_loss = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    rel = _max_rel(out["cuda"][1], out["cpu"][1])
    _check(d_loss <= EX_LOSS_F64 and rel <= EX_GRAD_F64,
           f"latent_ode float64 card vs CPU: loss {d_loss}, gradients {rel}")
    print(f"[17c latent_ode] {card} | {args.nspiral} spirals x "
          f"{args.nsample} points, each its own solve (odeint_per_sample, "
          f"rtol 1e-4 atol 1e-5, its own backward), float32 | {EX_STEPS} "
          f"steps {_ms_row(ms)}, neg elbo {float(losses[-1]):.2f} | forward "
          f"driver iterations a step {iters:.0f} (forward and backward "
          f"drivers), each trajectory's forward steps min/median/max "
          f"{_spread(st.n_steps)} | float64 step at {LATENT_CPU_B} spirals "
          f"card vs CPU: loss {d_loss:.2e}, gradients {rel:.2e} of max|g| | "
          f"cut: {EX_STEPS} of 500 steps | {time.perf_counter() - p0:.1f} s")


def _ex_cnf(torch, card):
    """Phase 17 (d): cnf at its defaults (512 samples, width 32) with
    `odeint` and ``--adjoint``, EX_STEPS steps timed, forward and backward
    NFE; a float64 step card against CPU at CNF_CPU_B samples."""
    from torchdiffeq_tpu_torch import odeint_with_stats
    from torchdiffeq_tpu_torch.examples import cnf
    from torchdiffeq_tpu_torch.examples._optim import Adam
    p0 = time.perf_counter()
    rows = []
    for flag in ([], ["--adjoint"]):
        args = cnf.parser.parse_args(flag)
        gen = torch.Generator().manual_seed(args.seed)
        func = cnf.CNF(cnf.init_hyper_net(cnf.IN_OUT_DIM, args.hidden_dim,
                                          args.width, gen, "cuda"))
        opt = Adam(func.parameters(), args.lr)
        xs = [cnf.sample_circles(args.num_samples, gen, "cuda")
              for _ in range(EX_STEPS + 1)]
        cnf.train_step(func, opt, xs[-1], args)
        losses = []
        with _BackwardStats() as bwd:
            ms = _timed_steps(torch, lambda i: losses.append(cnf.train_step(
                func, opt, xs[i], args)), EX_STEPS)
        fwd = []

        def with_stats(*a, **k):
            ys, st = odeint_with_stats(*a, **k)
            fwd.append(st)
            return ys
        with torch.no_grad():
            cnf.loss_fn(func, xs[0], args, solve=with_stats)
        _check(all(np.isfinite(float(x)) for x in losses), "cnf loss")
        rows.append(f"{'odeint_adjoint' if flag else 'odeint'}: {EX_STEPS} "
                    f"steps {_ms_row(ms)}, NLL {float(losses[-1]):.3f}, "
                    f"forward nfe {int(fwd[0].nfe)}, backward nfe "
                    f"{_bwd_nfe(bwd)}")
    out = {}
    for dev in ("cuda", "cpu"):
        args = cnf.parser.parse_args(["--device", dev])
        gen = torch.Generator().manual_seed(1)
        func = cnf.CNF(cnf.init_hyper_net(cnf.IN_OUT_DIM, args.hidden_dim,
                                          args.width, gen, dev,
                                          torch.float64))
        x = cnf.sample_circles(CNF_CPU_B, gen, dev, torch.float64)
        loss = cnf.loss_fn(func, x, args)
        loss.backward()
        out[dev] = float(loss.detach()), [p.grad for p in func.parameters()]
    d_loss = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    rel = _max_rel(out["cuda"][1], out["cpu"][1])
    _check(d_loss <= EX_LOSS_F64 and rel <= EX_GRAD_F64,
           f"cnf float64 card vs CPU: loss {d_loss}, gradients {rel}")
    print(f"[17d cnf] {card} | 512 samples, hypernetwork 1-32-32-224, "
          f"(z, logp) from t=10 to 0 at rtol=atol=1e-5, exact trace by "
          f"torch.func.jvp, float32 | " + " | ".join(rows)
          + f" | float64 step at {CNF_CPU_B} samples card vs CPU: loss "
          f"{d_loss:.2e}, gradients {rel:.2e} of max|g| | cut: {EX_STEPS} of"
          f" 500 steps | {time.perf_counter() - p0:.1f} s")


def _ex_odenet(torch, card):
    """Phase 17 (e): odenet_mnist at its defaults (batch 128, hidden 32,
    synthetic 16x16 digits): the ODE-Net with `odeint` and ``--adjoint``
    and the residual network, EX_STEPS steps each timed, NFE; one profiled
    ODE-Net step's device busy share and launches."""
    from torchdiffeq_tpu_torch.examples import odenet_mnist
    from torchdiffeq_tpu_torch.examples._optim import SGD
    p0 = time.perf_counter()
    rows = []
    busy = "not measured"
    for flags in (["--network", "odenet"],
                  ["--network", "odenet", "--adjoint"],
                  ["--network", "resnet"]):
        args = odenet_mnist.parser.parse_args(flags)
        gen = torch.Generator().manual_seed(args.seed)
        xs, ys = odenet_mnist.synthetic_digits(
            args.batch_size * (EX_STEPS + 1), gen, device="cuda")
        model = odenet_mnist.init_model(args, gen, "cuda")
        opt = SGD(model.parameters(), args.lr, momentum=0.9)
        bs = args.batch_size

        def step(i):
            return odenet_mnist.train_step(model, opt, xs[i * bs:(i + 1) * bs],
                                           ys[i * bs:(i + 1) * bs], args)
        step(EX_STEPS)
        losses = []
        with _BackwardStats() as bwd:
            ms = _timed_steps(torch, lambda i: losses.append(step(i)),
                              EX_STEPS)
        _check(all(np.isfinite(float(x)) for x in losses), "odenet loss")
        row = f"{' '.join(flags[1:])}: {EX_STEPS} steps {_ms_row(ms)}"
        if args.network == "odenet":
            with torch.no_grad():
                _, st = odenet_mnist.forward(model, xs[:bs], args,
                                             with_stats=True)
            row += (f", forward nfe {int(st.nfe)}, backward nfe "
                    f"{_bwd_nfe(bwd)}")
            if not args.adjoint:
                busy_ms, n_k, wall = _profiled_step(torch, lambda: step(0))
                busy = ("not measured (no device time in the trace)"
                        if busy_ms is None else
                        f"{busy_ms:.2f} ms of device time in {n_k} kernels, "
                        f"busy {busy_ms / wall:.1%} of the traced "
                        f"{wall:.1f} ms")
        rows.append(row)
    print(f"[17e odenet_mnist] {card} | batch 128, hidden 32, the conv "
          f"field (cuDNN, channels-last) over [0, 1] at tol 1e-3, SGD "
          f"momentum 0.9, float32 | " + " | ".join(rows)
          + f" | profiled odenet step: {busy} | cut: {EX_STEPS} of 300 "
          f"steps | {time.perf_counter() - p0:.1f} s")


def _ex_physics(torch, card):
    """Phase 17 (f) bouncing_ball whole on the card (float64), against the
    closed form and finite differences (its own checks) and the CPU; (g)
    learn_physics cut to EX_STEPS of its 300 iterations (finite loss)."""
    from torchdiffeq_tpu_torch.examples import bouncing_ball, learn_physics
    from torchdiffeq_tpu_torch.examples._common import default_dtype
    from torchdiffeq_tpu_torch.examples._optim import Adam
    p0 = time.perf_counter()
    gpu = bouncing_ball.main(["--device", "cuda"])
    cpu = bouncing_ball.main(["--device", "cpu"])
    rel = max(abs(g - c) for g, c in zip(gpu["grads"], cpu["grads"])) / max(
        abs(c) for c in cpu["grads"])
    fd = max(abs(g - f) for g, f in zip(gpu["grads"], gpu["fds"]))
    _check(rel <= EX_GRAD_F64, f"bouncing_ball card vs CPU gradients {rel}")
    ball_s = time.perf_counter() - p0
    p1 = time.perf_counter()
    with default_dtype(torch.float64):
        t_np = np.linspace(0.0, 3.0, 100)
        t_obs = torch.from_numpy(t_np).cuda()
        y_obs = torch.from_numpy(learn_physics.simulate_true(t_np)).cuda()
        params = learn_physics.init_params("cuda")
        opt = Adam(list(params.values()), 0.05)
        iter_ms = []
        for _ in range(EX_STEPS):
            w0 = time.perf_counter()
            opt.zero_grad()
            loss = learn_physics.trajectory_loss(params, t_obs, y_obs, 3.0, 3)
            loss.backward()
            opt.step()
            torch.cuda.synchronize()
            iter_ms.append((time.perf_counter() - w0) * 1e3)
        gravity = float(torch.exp(params["log_gravity"].detach()))
    _check(bool(torch.isfinite(loss)) and np.isfinite(gravity),
           f"learn_physics: loss {float(loss)}, gravity {gravity}")
    learn_s = time.perf_counter() - p1
    print(f"[17f bouncing_ball] {card} | whole, float64 on the card: event "
          f"times {[round(t, 9) for t in gpu['times']]}, first bounce vs "
          f"closed form {abs(gpu['times'][0] - gpu['exact']):.2e} (< 1e-6), "
          f"five gradients vs finite differences max|d| {fd:.2e} (the "
          f"example's 1e-3), vs CPU {rel:.2e} of max|g| (<= {EX_GRAD_F64}) | "
          f"{ball_s:.1f} s")
    print(f"[17g learn_physics] {card} | float64, {EX_STEPS} of its 300 "
          f"iterations: {', '.join(f'{x:.0f}' for x in iter_ms)} ms, loss "
          f"{float(loss):.4f}, gravity {gravity:.3f} (true 9.8) | "
          f"{learn_s:.1f} s")


def _phase_examples(torch, kernels, dev, driver_ms):
    """Phase 17: the examples on the card (module docstring).  Returns the
    traced instances' JSON entries."""
    card = _card()
    p0 = time.perf_counter()
    entries = _ex_traced(torch, kernels, dev, driver_ms, card)
    _ex_ode_demo(torch, card)
    _ex_latent(torch, card)
    _ex_cnf(torch, card)
    _ex_odenet(torch, card)
    _ex_physics(torch, card)
    print(f"[17h examples] {card} | phase 17 {time.perf_counter() - p0:.1f} s")
    return entries


# ---- phase 18: every state dtype (complex states, 16-bit traced fields) ------

# - phase 18 (a), complex states: a discretised 1-D Schroedinger equation
#   i psi' = H psi, H = -1/2 Laplacian + V(x) (second differences on SCH_N
#   points of [-SCH_L, SCH_L], dense), V(x) = c0 + c1 x + c2 x^2 harmonic,
#   SCH_B Gaussian wavepackets.  Card against CPU in complex128: the same
#   steps (Stats equal) and values within F64_VALUES of max|psi|, gradients
#   within GRAD_F64_REL, as every float64 card-vs-CPU check (the products'
#   summation order and the last bit of complex |z| apart).  The solve
#   against unitarity: sum |psi|^2 dx stays 1 within SCH_NORM over t = 2
#   (dopri5 is not unitary; at rtol 1e-8 the drift is the error control's,
#   measured 3.6e-9 on the CPU at B=64).  complex64 at SCH_RTOL_C64 against
#   complex128 at the same tolerance: two step sequences at dopri5's
#   stability edge (557 and 457 steps on the H100, run BH), whose global
#   errors at rtol 1e-5 differ by 1.30e-3 of max|psi| there: SCH_C64.  The implicit tiers on one
#   wavepacket of SCH_IMPL_N points against a dopri5 solve at rtol 1e-10:
#   within SCH_IMPL of max|psi|, three times their rtol (the global error
#   two solves at their tolerances may carry).
SCH_N, SCH_B, SCH_L = 256, 64, 10.0
SCH_TS = np.linspace(0.0, 2.0, 11)
SCH_RTOL, SCH_ATOL = 1e-8, 1e-10
SCH_RTOL_C64, SCH_ATOL_C64 = 1e-5, 1e-7
SCH_CPU_B = 8            # the batch of the CPU's side of the checks
# the training step: the first SCH_STEP_T outputs (t <= 1) at a trainer's
# tolerances (its backward at the solve's 1e-8 took 3289 steps to the
# forward's 466 on the CPU, 20 s at B=8); its check on the CPU over the
# first SCH_CHECK_T (t <= 0.4), and its profiled run, as the solve's, over
# the first SCH_PROF_T (t <= 0.2: a trace of the step to t = 0.4 took 16 s
# on the H100's host, run BD)
SCH_STEP_T, SCH_CHECK_T, SCH_PROF_T = 6, 3, 2
SCH_STEP_RTOL, SCH_STEP_ATOL = 1e-6, 1e-8
# the step's gradients card vs CPU (every forward and backward counter
# equal): float64 rounding (zgemm's summation order, the last bit of |z|)
# carried through a forward and a backward solve near dopri5's stability
# edge (the kinetic term's top eigenvalues times the step are about 1.6):
# 1.09e-9 of max|g| measured on the H100 (run BB), over GRAD_F64_REL's
# 1e-9, so held to 1e-8
SCH_GRAD = 1e-8
# the event's state card vs CPU: the event times agree within the
# bisection's atol (2.4e-11 measured, run BC), and the state moves by
# |H psi| <= ~10 |psi| per unit time there: 10 atol of max|psi|
SCH_EVENT_STATE = 10 * SCH_ATOL
# the per-sample driver card vs CPU: each sample's own controller runs at
# dopri5's stability edge (the kinetic term's top eigenvalues times the
# step near 3.3), where it chatters between accepts and rejects (10-18
# rejected of ~480 steps a sample), so a last-place difference of its
# error ratio (complex |z| and zgemm round otherwise on the card and the
# CPU, as C16 finds for XLA) moves the chatter: on the H100 7 of the 8
# samples took other steps, up to 12 of 492 (run BG), while the batched
# solve's one norm over the batch kept every count.  Held: every sample
# within SCH_PS_FLIP_VALUES of max|psi| (the global error of two step
# sequences at rtol 1e-8; 1.2e-7 measured), its steps within
# SCH_PS_STEP_SHARE of the CPU's, those with equal counts within
# F64_VALUES
SCH_PS_STEP_SHARE, SCH_PS_FLIP_VALUES = 0.05, 1e-6
SCH_IMPL_N, SCH_IMPL_CPU_N = 512, 48
SCH_IMPL_RTOL, SCH_IMPL_ATOL = 1e-6, 1e-8
SCH_IMPL_TS = np.linspace(0.0, 1.0, 3)
SCH_NORM = 1e-6
SCH_C64 = 5e-3
SCH_IMPL = 3 * SCH_IMPL_RTOL * 10
SCH_WINDOW = (1.0, 4.0)  # the loss's window: |psi|^2 over 1 <= x <= 4
SCH_STEP_REPS = 1     # timed repetitions, few to keep the script in its limit
# - phase 18 (b), the 16-bit traced instances: examples/ensemble.py's field
#   and first-zero event at rtol = atol = LANE16_RTOL, against their plain
#   versions on the same CUDA tensors, under phase 15 (f)'s gates
#   (TR16_ULPS, TR16_FLIP_LANES).  bfloat16 takes the example's own
#   omegas (make_problem) and output times (t <= 2); float16 tops out at
#   65504, and the Hairer initial step's square of |f| / (atol + rtol |y|)
#   overflows it past omega ~ 1.5 (a lane then stalls at dt = 0, in JAX's
#   kernel as in these), so its omegas are drawn in [0.3, 1.2] instead.
#   Those slow oscillators take 3-4 steps to t = 2 at rtol 1e-2 (readings
#   BH, BJ), a launch's floor rather than the kernel's loop, so float16's
#   integrate runs to TR16_T_F16 (tens of steps a lane, the JSON entry's
#   `steps`); its event stays the example's first zero, a quarter period.
# - its gate: a traced instance and its plain version run the same
#   operations in the same order, each rounded to the state dtype
#   (ops/traced.py), and every reading on the H100 was bit for bit (AY,
#   BH, BJ: 0 lanes with other counts, 0 units).  So each lane is held to
#   TR16_ULPS units in the last place of each component's own magnitude in
#   that lane (an output's largest |y| over the output times; an event time
#   or event state its own), and at most TR16_FLIP_LANES lanes of a run may
#   take other counts.  Phase 15 (f)'s gates, whose unit is set by max|y|
#   over the whole output, would leave every x of the ensemble (|x| <= 1
#   beside |v| up to omega ~ 60) and most event times unchecked.
TR16_OMEGA_F16 = (0.3, 1.2)
TR16_T_F16 = 100.0
TR16_MAX_STEPS = 4000
TR16_ULPS, TR16_FLIP_LANES = 2, 2


def _schrodinger(torch, n, b, device, dtype=None, seed=0):
    """(field, psi0 (b, n), V's coefficients, x, dx, the kinetic matrix):
    SCH_L's grid of n points, b Gaussian wavepackets (centres in [-3, 3],
    momenta in [-2, 2], width 1, normalised), V(x) = x^2 / 2 as (c0, c1,
    c2).  The field takes the coefficients as an arg, so the adjoint
    differentiates them; the kinetic matrix and the grid are closed
    over."""
    dtype = dtype or torch.complex128
    rdt = dtype.to_real()
    x = np.linspace(-SCH_L, SCH_L, n)
    dx = float(x[1] - x[0])
    ones = np.ones(n)
    lap = (np.diag(-2.0 * ones) + np.diag(ones[:-1], 1)
           + np.diag(ones[:-1], -1)) / dx ** 2
    kin = torch.from_numpy(-0.5 * lap).to(device, dtype)
    # drawn for SCH_B packets, so that a smaller batch is their first b
    rng = np.random.RandomState(seed)
    c = rng.uniform(-3.0, 3.0, max(b, SCH_B))[:b, None]
    k = rng.uniform(-2.0, 2.0, max(b, SCH_B))[:b, None]
    psi = np.exp(-(x[None] - c) ** 2 / 2.0 + 1j * k * x[None])
    psi /= np.sqrt((np.abs(psi) ** 2).sum(1, keepdims=True) * dx)
    xt = torch.from_numpy(x).to(device, rdt)

    def field(t, p, coef):
        v = coef[0] + coef[1] * xt + coef[2] * xt * xt
        return -1j * (p @ kin + v * p)

    coef = torch.tensor([0.0, 0.0, 0.5], dtype=rdt, device=device)
    return field, torch.from_numpy(psi).to(device, dtype), coef, xt, dx, kin


def _sch_loss(torch, ys, xt, dx):
    """The probability in SCH_WINDOW at the last output time, a real loss of
    the complex solution."""
    w = ((xt >= SCH_WINDOW[0]) & (xt <= SCH_WINDOW[1])).to(xt.dtype)
    return ((ys[-1].abs() ** 2) * w).sum() * dx


def _sch_step(torch, device, b, adjoint_options=None, ts=None):
    """One training step's gradients: odeint_adjoint over `ts`, the loss
    `_sch_loss`, with respect to V's coefficients and psi0.  Returns (loss,
    d coef, d psi0, the forward Stats)."""
    from torchdiffeq_tpu_torch.adjoint import adjoint_solve
    ts = SCH_TS[:SCH_STEP_T] if ts is None else ts
    field, psi0, coef, xt, dx, _ = _schrodinger(torch, SCH_N, b, device)
    psi0.requires_grad_(True)
    coef.requires_grad_(True)
    ys, st = adjoint_solve(
        field, psi0, torch.from_numpy(ts), rtol=SCH_STEP_RTOL,
        atol=SCH_STEP_ATOL, method="dopri5", options=None, event_fn=None,
        args=(coef,), adjoint_rtol=SCH_STEP_RTOL, adjoint_atol=SCH_STEP_ATOL,
        adjoint_method="dopri5", adjoint_options=dict(adjoint_options or {}))
    loss = _sch_loss(torch, ys, xt, dx)
    loss.backward()
    return loss.detach(), coef.grad, psi0.grad, st


def _sch_event(torch, device, b):
    """`odeint_event` to the first time the mean position of wavepacket 0
    crosses 0 (Re sum x |psi_0|^2 dx: a real event of the complex state)."""
    from torchdiffeq_tpu_torch import odeint_event
    field, psi0, coef, xt, dx, _ = _schrodinger(torch, SCH_N, b, device)
    et, ys = odeint_event(
        field, psi0, 0.0, args=(coef,), rtol=SCH_RTOL, atol=SCH_ATOL,
        event_fn=lambda t, p: ((p[0].abs() ** 2) * xt).sum() * dx)
    return et, ys[-1]


def _sch_per_sample(torch, device, b):
    """`odeint_per_sample_with_stats` on the batched driver: each wavepacket
    its own controller and its own potential's curvature (c2 per sample,
    args_axes=(0,))."""
    from torchdiffeq_tpu_torch import odeint_per_sample_with_stats
    _, psi0, _, xt, _, kinm = _schrodinger(torch, SCH_N, b, device)
    c2 = torch.linspace(0.3, 0.7, SCH_B, dtype=torch.float64,
                        device=device)[:b]

    def one(t, p, c2_i):
        return -1j * (p @ kinm + (c2_i * xt * xt) * p)

    with torch.no_grad():
        return odeint_per_sample_with_stats(
            one, psi0, torch.from_numpy(SCH_TS), args=(c2,), args_axes=(0,),
            rtol=SCH_RTOL, atol=SCH_ATOL)


def _sch_implicit(torch, device, n, method, rtol=SCH_IMPL_RTOL,
                  atol=SCH_IMPL_ATOL, options=None):
    """One wavepacket of n points through `method`: (values, Stats)."""
    from torchdiffeq_tpu_torch import odeint_with_stats
    field, psi0, coef, _, _, _ = _schrodinger(torch, n, 1, device)
    with torch.no_grad():
        return odeint_with_stats(field, psi0[0], torch.from_numpy(
            SCH_IMPL_TS), args=(coef,), method=method, rtol=rtol, atol=atol,
            options=options)


def _phase_complex(torch, dev, card):
    """Phase 18 (a): complex states on the card (module docstring)."""
    from torchdiffeq_tpu_torch import odeint_with_stats
    from torchdiffeq_tpu_torch.solvers.solution import (
        IMPLICIT_COUNTS, reset_implicit_counts)
    clock = time.perf_counter()
    ts = torch.from_numpy(SCH_TS)
    rows = []

    def solve(device, b, dtype=None, rtol=SCH_RTOL, atol=SCH_ATOL, t=ts):
        field, psi0, coef, _, dx, _ = _schrodinger(torch, SCH_N, b, device,
                                                   dtype)
        with torch.no_grad():
            ys, st = odeint_with_stats(field, psi0, t, args=(coef,),
                                       rtol=rtol, atol=atol)
        return ys, st, dx

    # the main solve: B=64 complex128, card against CPU, timed
    ys_g, st_g, dx = solve(dev, SCH_B)
    err = _card_vs_cpu(torch, dev, lambda d: solve(d, SCH_B)[:2],
                       "18a complex128 Schroedinger solve")
    norm = (ys_g.abs() ** 2).sum(-1) * dx
    drift = float((norm - 1.0).abs().max())
    _check(drift <= SCH_NORM and ys_g.dtype == torch.complex128,
           f"18a: norm drift {drift} (<= {SCH_NORM}), dtype {ys_g.dtype}")
    solve_ms = _wall_stats(torch, lambda: solve(dev, SCH_B), SCH_STEP_REPS)
    busy, n_k, wall = _profiled_step(torch, lambda: solve(
        dev, SCH_B, t=ts[:SCH_PROF_T]), host=False)
    rows.append(
        f"solve complex128 B={SCH_B} N={SCH_N} dopri5 rtol={SCH_RTOL}: "
        f"steps {int(st_g.n_steps)}, nfe {int(st_g.nfe)}, card vs CPU "
        f"{err:.2e} of max|psi|, norm drift {drift:.2e}, wall median "
        f"{solve_ms[0]:.1f} ms (min {solve_ms[1]:.1f}, max {solve_ms[2]:.1f})"
        + (f", profiled to t={SCH_TS[SCH_PROF_T - 1]:.1f}: device "
           f"{busy:.1f} ms in {n_k} kernels, busy share {busy / wall:.3f}"
           if busy else ", device time not traced"))

    # complex64 against complex128 at complex64's tolerance
    y64, st64, _ = solve(dev, SCH_B, torch.complex64, SCH_RTOL_C64,
                         SCH_ATOL_C64)
    y128, st128, _ = solve(dev, SCH_B, torch.complex128, SCH_RTOL_C64,
                           SCH_ATOL_C64)
    e64 = float((y64.to(torch.complex128) - y128).abs().max()
                / y128.abs().max())
    _check(y64.dtype == torch.complex64 and e64 <= SCH_C64,
           f"18a complex64 vs complex128: {e64} (<= {SCH_C64})")
    rows.append(f"complex64 rtol={SCH_RTOL_C64}: steps {int(st64.n_steps)} "
                f"(complex128 {int(st128.n_steps)}), vs complex128 "
                f"{e64:.2e} of max|psi|")

    # the training step, default and interpolated adjoint
    for mode, opts in (("adjoint", None),
                       ("interpolated", dict(interpolated=True))):
        ts_c = SCH_TS[:SCH_CHECK_T]
        with _BackwardStats() as bg:
            lg, cg, pg, sg = _sch_step(torch, dev, SCH_CPU_B, opts, ts_c)
        with _BackwardStats() as bc:
            lc, cc, pc, sc = _sch_step(torch, "cpu", SCH_CPU_B, opts, ts_c)
        gerr = float((pg.cpu() - pc).abs().max() / pc.abs().max())
        cerr = float((cg.cpu() - cc).abs().max() / cc.abs().max())
        same = (_stats_list(sg)[:4] == _stats_list(sc)[:4]
                and bg.counters() == bc.counters())
        print(f"[18a reading] {mode} step card vs CPU: forward "
              f"{[int(x) for x in sg[:5]]} / {[int(x) for x in sc[:5]]}, "
              f"backward {bg.counters()} / {bc.counters()}, loss "
              f"{float(lg)!r} / {float(lc)!r}, d/dpsi0 {gerr}, d/dc {cerr}",
              flush=True)
        _check(same and abs(float(lg) - float(lc)) <= F64_VALUES * abs(
            float(lc)) and max(gerr, cerr) <= SCH_GRAD,
            f"18a {mode} step card vs CPU: counters equal {same}, loss "
            f"{float(lg)} vs {float(lc)}, gradients {gerr}, {cerr}")
        gerr = max(gerr, cerr)
        ms = []
        for _ in range(SCH_STEP_REPS):
            w0 = time.perf_counter()
            lb, cb, pb, stb = _sch_step(torch, dev, SCH_B, opts)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - w0) * 1e3)
        ms = (float(np.median(ms)), min(ms), max(ms))
        _check(bool(torch.isfinite(cb).all()) and bool(
            torch.isfinite(pb).all()), f"18a {mode} B={SCH_B}: not finite")
        busy, n_k, wall = _profiled_step(torch, lambda: _sch_step(
            torch, dev, SCH_B, opts, SCH_TS[:SCH_PROF_T]), host=False)
        rows.append(
            f"{mode} step B={SCH_B} to t={SCH_TS[SCH_STEP_T - 1]:.1f} rtol="
            f"{SCH_STEP_RTOL} (loss {float(lb):.6f}, d/dc "
            f"{cb.cpu().numpy()}, forward steps {int(stb.n_steps)}): card vs"
            f" CPU at B="
            f"{SCH_CPU_B} to t={SCH_TS[SCH_CHECK_T - 1]:.1f} counters "
            f"equal, gradients {gerr:.2e} (<= {SCH_GRAD}), "
            f"wall median {ms[0]:.1f} ms (min {ms[1]:.1f}, max {ms[2]:.1f})"
            + (f", profiled to t={SCH_TS[SCH_PROF_T - 1]:.1f}: device "
               f"{busy:.1f} ms in {n_k} kernels, busy share "
               f"{busy / wall:.3f}" if busy else ", device time not traced"))

    # an event solve and the per-sample driver
    eg, yeg = _sch_event(torch, dev, SCH_CPU_B)
    ec, yec = _sch_event(torch, "cpu", SCH_CPU_B)
    de = abs(float(eg) - float(ec))
    dye = float((yeg.cpu() - yec).abs().max() / yec.abs().max())
    _check(de <= SCH_ATOL and dye <= SCH_EVENT_STATE,
           f"18a event card vs CPU: time {de}, state {dye}")
    (vg, sg), (vc, sc) = (_sch_per_sample(torch, d, SCH_CPU_B)
                          for d in (dev, "cpu"))
    vg = vg.cpu()
    same = torch.ones(SCH_CPU_B, dtype=torch.bool)
    for a_, b_ in zip(_stats_list(sg), _stats_list(sc)):
        same &= a_ == b_
    d_s = ((vg - vc).abs().reshape(SCH_CPU_B, -1).amax(1)
           / vc.abs().max())
    pe = float(d_s[same].max()) if bool(same.any()) else 0.0
    pe_flip = float(d_s[~same].max()) if bool((~same).any()) else 0.0
    stp_c = torch.as_tensor(sc.n_steps).double()
    dsteps = float(((torch.as_tensor(sg.n_steps).cpu() - stp_c).abs()
                    / stp_c).max())
    print(f"[18a reading] per-sample card vs CPU: steps "
          f"{torch.as_tensor(sg.n_steps).tolist()} / "
          f"{torch.as_tensor(sc.n_steps).tolist()}, accepted "
          f"{torch.as_tensor(sg.n_accepted).tolist()} / "
          f"{torch.as_tensor(sc.n_accepted).tolist()}, each sample's max|d| "
          f"{d_s.tolist()}", flush=True)
    _check(dsteps <= SCH_PS_STEP_SHARE and pe <= F64_VALUES
           and pe_flip <= SCH_PS_FLIP_VALUES,
           f"18a per-sample card vs CPU: samples with other counts "
           f"{int((~same).sum())} (steps within {dsteps}), the others {pe}, "
           f"those {pe_flip}")
    w0 = time.perf_counter()
    ps = _sch_per_sample(torch, dev, SCH_B)
    torch.cuda.synchronize()
    ps_ms = (time.perf_counter() - w0) * 1e3
    _check(bool(torch.isfinite(ps[0]).all()),
           f"18a per-sample B={SCH_B}: not finite")
    rows.append(f"event at t={float(eg):.6f} card vs CPU {de:.1e}; "
                f"per-sample B={SCH_B} steps {_spread(ps[1].n_steps)}, "
                f"{ps_ms:.0f} ms, card vs CPU at B={SCH_CPU_B}: samples "
                f"with other counts {int((~same).sum())} (within "
                f"{pe_flip:.2e}, steps within {dsteps:.3f} of the CPU's), "
                f"the others {pe:.2e}")

    # the implicit tiers: card against CPU at a small n, then one
    # wavepacket of SCH_IMPL_N points against dopri5 at rtol 1e-10
    impl = (("kvaerno5", None), ("radau5a", None),
            ("gl4", dict(num_steps=40, root_solver="newton")))
    for method, opts in impl:
        _card_vs_cpu(torch, dev, lambda d: _sch_implicit(
            torch, d, SCH_IMPL_CPU_N, method, options=opts),
            f"18a {method} n={SCH_IMPL_CPU_N}")
    ref, _ = _sch_implicit(torch, dev, SCH_IMPL_N, "dopri5", 1e-10, 1e-12)
    for method, opts in impl:
        reset_implicit_counts()
        w0 = time.perf_counter()
        ys, st = _sch_implicit(torch, dev, SCH_IMPL_N, method, options=opts)
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - w0
        counts = dict(IMPLICIT_COUNTS)
        e = float((ys - ref).abs().max() / ref.abs().max())
        _check(e <= SCH_IMPL and int(st.error_code) == 0,
               f"18a {method} n={SCH_IMPL_N}: vs dopri5 {e} (<= {SCH_IMPL}),"
               f" code {int(st.error_code)}")
        shares = _profiled_shares(torch, lambda: _sch_implicit(
            torch, dev, SCH_IMPL_N, method, options=opts))
        share = ("not traced" if shares is None else
                 f"device {shares[0]:.1f} ms, linear solves "
                 f"{shares[1] / shares[0]:.3f}, Jacobians "
                 f"{shares[2] / shares[0]:.3f} of it")
        rows.append(
            f"{method} one wavepacket N={SCH_IMPL_N} ({2 * SCH_IMPL_N} real "
            f"unknowns a stage): steps {int(st.n_steps)}, vs dopri5 {e:.2e}, "
            f"wall {wall_s:.2f} s, iterations {counts['iterations']}, linear "
            f"solves {counts['linear_solves']}, Jacobians "
            f"{counts['jacobians']}; {share}")
    print(f"[18a complex states] {card} | " + " | ".join(rows)
          + f" | {time.perf_counter() - clock:.1f} s", flush=True)


def _phase_traced16(torch, kernels, dev, card):
    """Phase 18 (b): the bfloat16 and float16 traced instances of K-dopri5
    and K-events on examples/ensemble.py's field and event, through
    `odeint_per_sample(pallas=True)` with the traced launch counts reset
    before and read after, each against its plain version on the same CUDA
    tensors at B and BIG_B, timed three ways.  Returns four JSON entries."""
    from torchdiffeq_tpu_torch import odeint_per_sample_with_stats
    from torchdiffeq_tpu_torch.examples import ensemble
    from torchdiffeq_tpu_torch.ops import _build, traced
    from torchdiffeq_tpu_torch.ops.tableaus import DOPRI5 as DOPRI5_TAB
    clock = time.perf_counter()
    entries, rows = [], []
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float16, "f16")):
        t1 = 2.0 if dtype == torch.bfloat16 else TR16_T_F16
        ts = np.linspace(0.0, t1, 5)
        def problem(b):
            omega, y0, _ = ensemble.make_problem(b, dev, dtype)
            if dtype == torch.float16:
                rng = np.random.RandomState(0)
                omega = torch.from_numpy(np.exp(rng.uniform(
                    *np.log(TR16_OMEGA_F16), b))).to(dev, dtype)
            return omega, y0
        omega, y0 = problem(B)
        kernels.reset_launch_counts()
        builds0 = len(_build.traced_builds)
        w0 = time.perf_counter()
        with torch.no_grad():
            ys_r, st_r = odeint_per_sample_with_stats(
                ensemble.field, y0, torch.from_numpy(ts), args=(omega,),
                args_axes=(-1,), rtol=LANE16_RTOL, atol=LANE16_ATOL,
                options=dict(pallas=True))
            (et_r, _), st_e = odeint_per_sample_with_stats(
                ensemble.field, y0, torch.tensor([0.0, 2.0]), args=(omega,),
                args_axes=(-1,), rtol=LANE16_RTOL, atol=LANE16_ATOL,
                event_fn=ensemble.event_fn,
                options=dict(pallas=True, max_num_steps=TR16_MAX_STEPS))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - w0
        launched = dict(kernels.traced_launch_counts)
        builds = list(_build.traced_builds.values())[builds0:]
        _check(launched["dopri5_integrate_batched"] == 1
               and launched["dopri5_events_batched"] == 1
               and ys_r.dtype == dtype and bool(torch.isfinite(ys_r).all())
               and bool(torch.isfinite(et_r).all()),
               f"18b {tag}: traced launches {launched}, finite "
               f"{bool(torch.isfinite(ys_r).all())}, events found "
               f"{bool(torch.isfinite(et_r).all())}")
        for events in (False, True):
            name = ("dopri5_events_batched" if events
                    else "dopri5_integrate_batched")
            times, flips, errs, stp, bounds = {}, {}, {}, {}, {}
            for b in (B, BIG_B):
                om_b, y_b = problem(b)
                y0T = y_b.T.contiguous()
                field = traced.PerSampleField(ensemble.field, (om_b,), (-1,))
                if events:
                    event = traced.PerSampleEvent(ensemble.event_fn)
                    kw = dict(rtol=LANE16_RTOL, atol=LANE16_ATOL,
                              max_steps=TR16_MAX_STEPS, ev_params=(
                                  torch.sign(y0T[:1]).contiguous(),))
                    wrapped = lambda: kernels.dopri5_events_batched(
                        field, y0T, 0.0, event, **kw)
                    bare, outs = kernels._events_launch(field, y0T, 0.0,
                                                        event, **kw)
                    plain = lambda: kernels.dopri5_events_batched_ref(
                        field, y0T, 0.0, event, **kw)
                    vals, cnts = (0, 1), (2, 3, 4)
                else:
                    kw = dict(ts=ts, rtol=LANE16_RTOL, atol=LANE16_ATOL,
                              max_steps=TR16_MAX_STEPS)
                    wrapped = lambda: kernels.dopri5_integrate_batched(
                        field, y0T, 0.0, t1, **kw)
                    bare, outs = kernels._lanes_launch(field, y0T, 0.0, t1,
                                                       **kw)
                    plain = lambda: kernels.dopri5_integrate_batched_ref(
                        field, y0T, 0.0, t1, **kw)
                    vals, cnts = (0,), (1, 2)
                with torch.no_grad():
                    got = wrapped()
                    a, e_ = (torch.cuda.Event(enable_timing=True)
                             for _ in range(2))
                    a.record()
                    want = plain()
                    e_.record()
                    torch.cuda.synchronize()
                    plain_ms = a.elapsed_time(e_)
                    flips[b], errs[b] = traced16_flips_and_ulps(
                        torch, dtype, [got[i] for i in vals],
                        [want[i].cpu() for i in vals],
                        [got[i] for i in cnts],
                        [want[i].cpu() for i in cnts])
                    _check(flips[b] <= TR16_FLIP_LANES
                           and errs[b] <= TR16_ULPS,
                           f"18b {tag} {name} B={b}: lanes with other "
                           f"counts {flips[b]} (<= {TR16_FLIP_LANES}), the "
                           f"others within {errs[b]} ULPs of their own "
                           f"magnitude (<= {TR16_ULPS})")
                    times[b] = dict(group_width=1,
                                    ms=_time_ms(torch, wrapped, 10),
                                    bare_ms=_time_ms(torch, bare, 10),
                                    device_ms=_device_ms(torch, bare, 10),
                                    plain_ms=plain_ms)
                stp[b] = got[-1]
                src = bare.source
                bounds[b] = _traced_bound(
                    got[-1], DOPRI5_TAB, 2, src.field_ops, PEAK_F16, 2,
                    S=0 if events else len(ts),
                    event_ops=src.event_ops if events else None, K=src.K)
            slow = {b: _slowest_lane(stp[b], times[b]["device_ms"])
                    for b in (B, BIG_B)}
            entry = dict(
                name=f"{name}_traced[{tag}]", route="cuda",
                source=("torchdiffeq_tpu_torch/csrc/dopri5_events.cuh"
                        if events else
                        "torchdiffeq_tpu_torch/csrc/dopri5_lanes.cuh"),
                replaces=("torchdiffeq_tpu/ops/pallas_kernels.py:580"
                          if events else
                          "torchdiffeq_tpu/ops/pallas_kernels.py:336"),
                emitted_by="torchdiffeq_tpu_torch/ops/traced.py",
                field="examples/ensemble.py's oscillators"
                + (", omega in [0.3, 1.2]" if tag == "f16" else "")
                + ("" if events else f", t in [0, {t1:g}]"),
                launches=launched[name], max_abs_err=errs[B],
                max_err_unit="16-bit ULPs of each component's own magnitude "
                "in its lane, over every lane whose counts equal the plain "
                "version's",
                count_flip_lanes=flips[B], count_flip_lanes_65536=flips[BIG_B],
                max_abs_err_65536=errs[BIG_B],
                steps=_spread(stp[B]), steps_65536=_spread(stp[BIG_B]),
                **_times_entry(times),
                bound_ms=bounds[B][0], bound_by=bounds[B][1],
                bound_ms_65536=bounds[BIG_B][0],
                max_lane_steps=slow[B][0], ns_per_step=slow[B][1],
                max_lane_steps_65536=slow[BIG_B][0],
                ns_per_step_65536=slow[BIG_B][1], redesigned="PR 19",
                first_build_s=builds, library_ms=None)
            entries.append(entry)
            rows.append(
                f"{name}_traced[{tag}]: launches {launched[name]}, lanes with"
                f" other counts {flips[B]} / {flips[BIG_B]} (<= "
                f"{TR16_FLIP_LANES}), the others within {errs[B]:.2f} / "
                f"{errs[BIG_B]:.2f} ULPs of their own magnitude (<= "
                f"{TR16_ULPS}), "
                f"steps {_spread(stp[B])}, slowest lane {slow[B][0]} / "
                f"{slow[BIG_B][0]} steps at {slow[B][1]:.1f} / "
                f"{slow[BIG_B][1]:.1f} ns a step, bound {bounds[B][0]:.2e} / "
                f"{bounds[BIG_B][0]:.2e} ms ({bounds[B][1]}) | "
                + " | ".join(_times_row(b, t) for b, t in times.items()))
        rows.append(f"{tag}: first-use builds "
                    + ", ".join(f"{s:.1f} s" for s in builds)
                    + f", first calls {first_s:.1f} s")
    print(f"[18b 16-bit traced] {card} | examples/ensemble.py field and "
          f"event, rtol=atol={LANE16_RTOL}, kernels against their plain "
          f"versions on the card | " + " | ".join(rows)
          + f" | {time.perf_counter() - clock:.1f} s", flush=True)
    return entries


def _phase_dtypes(torch, kernels, dev):
    """Phase 18: complex states (a) and the 16-bit traced instances (b).
    Returns (b)'s JSON entries."""
    card = _card()
    p0 = time.perf_counter()
    _phase_complex(torch, dev, card)
    entries = _phase_traced16(torch, kernels, dev, card)
    print(f"[18c dtypes] {card} | phase 18 {time.perf_counter() - p0:.1f} s",
          flush=True)
    return entries


def _par_setup(torch, npd, device, b):
    """Phase 19's problem: phase 10's spiral field and its first `b`
    spirals as one state, and t = linspace(0, 1, PAR_T) (float64, CPU)."""
    model, y0, _, _ = _train_setup(torch, npd, device)
    t = torch.linspace(0.0, 1.0, PAR_T, dtype=torch.float64)
    return model, y0[:b].contiguous(), t


def _par_chain(torch, model, y0, t, solver):
    """The slice-restarted sequential fine chain: (T, ...) values."""
    u, out = y0, [y0]
    for s in range(t.shape[0] - 1):
        u = solver(model, u, t[s:s + 2], rtol=RTOL, atol=ATOL)[-1]
        out.append(u)
    return torch.stack(out)


def _par_finite_termination(torch, device, b):
    """float64, n_iters = S: Parareal's values and the gradients of
    sum(ys[-1]**2) in y0, the parameters and t against the chain's
    (`odeint_adjoint` slice by slice).  Returns (value error relative to
    max|y|, the largest gradient error relative to its max|g|, deltas)."""
    from torchdiffeq_tpu_torch import odeint_adjoint
    from torchdiffeq_tpu_torch.parallel import odeint_parareal_with_info
    runs = []
    for par in (True, False):
        model, y0, t = _par_setup(torch, np.float64, device, b)
        y0.requires_grad_(True)
        t.requires_grad_(True)
        if par:
            ys, deltas = odeint_parareal_with_info(
                model, y0, t, rtol=RTOL, atol=ATOL, n_iters=PAR_T - 1)
        else:
            ys = _par_chain(torch, model, y0, t, odeint_adjoint)
        (ys[-1] ** 2).sum().backward()
        runs.append((ys.detach(), [y0.grad, *(p.grad for p in
                                             model.parameters()), t.grad]))
    (ys_p, g_p), (ys_c, g_c) = runs
    err = float((ys_p - ys_c).abs().max() / ys_c.abs().max())
    return err, _max_rel(g_p, g_c), deltas.detach()


def _sgd_problem(torch, npd, device):
    """Phase 10's training step as a loss of a params tuple (w1, b1, w2,
    b2): `odeint_adjoint` of the spiral field with the params as an arg."""
    from types import SimpleNamespace
    from torchdiffeq_tpu_torch import odeint_adjoint
    from torchdiffeq_tpu_torch.models.neural_ode import mlp_apply
    model, y0, target, t = _train_setup(torch, npd, device)
    params = tuple(p.detach().clone() for p in (
        model.weights[0], model.biases[0], model.weights[1],
        model.biases[1]))

    def field(tt, yy, p):
        return mlp_apply(SimpleNamespace(weights=p[0::2], biases=p[1::2]),
                         yy ** 3)

    def loss_fn(p, _batch):
        ys = odeint_adjoint(field, y0, t, rtol=RTOL, atol=ATOL,
                            method="dopri5", args=(p,))
        return ((ys - target[None]) ** 2).mean()

    return params, loss_fn


def _by_hand(torch, loss_fn, params, n, update):
    """`n` steps of `loss_fn` by hand: backward on leaf tensors, then
    `update(leaves)` under no_grad.  Returns (leaves, losses)."""
    ps = [p.clone().requires_grad_(True) for p in params]
    losses = []
    for _ in range(n):
        loss = loss_fn(tuple(ps), None)
        loss.backward()
        with torch.no_grad():
            update(ps)
        for p in ps:
            p.grad = None
        losses.append(loss.detach())
    return [p.detach() for p in ps], torch.stack(losses)


def _training_loops(torch, device):
    """Phase 19 (c)'s equalities: (sgd scan vs hand, fit vs scan, adam vs
    hand, bfloat16 kept, seconds a step of the scan)."""
    from torchdiffeq_tpu_torch import training
    from torchdiffeq_tpu_torch.examples._optim import Adam
    params, loss_fn = _sgd_problem(torch, np.float32, device)
    step = training.make_sgd_step(loss_fn, lr=1e-3)
    _sync(torch, device)
    w0 = time.perf_counter()
    p_scan, l_scan = training.scan_steps(step, params, length=3)
    _sync(torch, device)
    step_s = (time.perf_counter() - w0) / 3

    def sgd(ps):
        for p in ps:
            p -= 1e-3 * p.grad
    p_hand, l_hand = _by_hand(torch, loss_fn, params, 3, sgd)
    sgd_equal = (all(torch.equal(a, b) for a, b in zip(p_scan, p_hand))
                 and torch.equal(l_scan, l_hand))
    p_fit, l_fit = training.fit(step, params, num_steps=5,
                                steps_per_dispatch=2)
    p_one, l_one = training.scan_steps(step, params, length=5)
    fit_equal = (all(torch.equal(a, b) for a, b in zip(p_fit, p_one))
                 and np.array_equal(l_fit, l_one.cpu().numpy()))
    # the port's Adam, float64: the functional transform against the
    # torch.optim form of the same rule
    params64, loss64 = _sgd_problem(torch, np.float64, device)
    init, astep = training.make_optax_step(loss64, training.adam(1e-3))
    (p_adam, _), l_adam = training.scan_steps(astep, init(params64),
                                              length=3)
    opt = {}

    def adam(ps):
        if not opt:
            opt['o'] = Adam(ps, lr=1e-3)
        opt['o'].step()
    p_ah, l_ah = _by_hand(torch, loss64, params64, 3, adam)
    adam_equal = (all(torch.equal(a, b) for a, b in zip(p_adam, p_ah))
                  and torch.equal(l_adam, l_ah))
    adam_rel = _max_rel(p_adam, p_ah)
    binit, bstep = training.make_optax_step(
        lambda w, _: ((w - 1.0) ** 2).sum().float(), training.adam(1e-2))
    (wb, _), _ = training.scan_steps(
        bstep, binit(torch.zeros(4, dtype=torch.bfloat16, device=device)),
        length=3)
    return dict(sgd_equal=sgd_equal, fit_equal=fit_equal,
                adam_equal=adam_equal, adam_rel=adam_rel,
                bf16=wb.dtype == torch.bfloat16, step_s=step_s,
                losses=l_scan.cpu().tolist())


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _phase_parareal(torch, kernels, dev, train_ms):
    """Phase 19: Parareal (`parallel/parareal.py`, its fine sweep the
    per-sample-span driver), the parareal_demo, and the training loops
    (`training.py`), on the card."""
    import contextlib
    import io
    from torchdiffeq_tpu_torch import odeint
    from torchdiffeq_tpu_torch.examples import parareal_demo
    from torchdiffeq_tpu_torch.parallel import odeint_parareal_with_info
    from torchdiffeq_tpu_torch.solvers import batched_rk
    p0 = time.perf_counter()
    card = _card()
    kernels.reset_launch_counts()

    # (a) float64, n_iters = S: the chain's values and gradients
    err64, grad64, d64 = _par_finite_termination(torch, dev, B)
    _check(err64 <= PAR_VALUES and grad64 <= PAR_GRAD_REL,
           f"Parareal float64 n_iters={PAR_T - 1} vs the chain: values "
           f"{err64}, gradients {grad64} of max|g|")

    # float32, n_iters = 3: its time beside the chain's
    model, y0, t = _par_setup(torch, np.float32, dev, B)
    with torch.no_grad():
        _par_chain(torch, model, y0, t, odeint)          # warm
        odeint_parareal_with_info(model, y0, t, rtol=RTOL, atol=ATOL,
                                  n_iters=PAR_FAST_ITERS)
        rows = {}
        for name, run in (
                ("parareal", lambda: odeint_parareal_with_info(
                    model, y0, t, rtol=RTOL, atol=ATOL,
                    n_iters=PAR_FAST_ITERS)),
                ("chain", lambda: (_par_chain(torch, model, y0, t, odeint),
                                   None))):
            batched_rk.reset_lane_counts()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            ev[0].record()
            ys32, d32 = run()
            ev[1].record()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - w0) * 1e3
            iters = batched_rk.LANE_COUNTS["iterations"]
            busy_ms, n_k, pwall = _profiled_step(torch, run, host=False)
            rows[name] = (ev[0].elapsed_time(ev[1]), wall, busy_ms, n_k,
                          pwall, iters, ys32, d32)
    ys_par, ys_seq = rows["parareal"][6], rows["chain"][6]
    err32 = float((ys_par - ys_seq).abs().max() / ys_seq.abs().max())
    _check(bool(torch.isfinite(ys_par).all()) and ys_par.is_cuda
           and tuple(ys_par.shape) == (PAR_T, B, 2),
           f"Parareal float32: {tuple(ys_par.shape)}")

    def row(name):
        ev_ms, wall, busy_ms, n_k, pwall, iters = rows[name][:6]
        busy = ("busy not measured (no device time in the trace)"
                if busy_ms is None else
                f"busy {busy_ms:.2f} ms in {n_k} kernels, {busy_ms / pwall:.1%}"
                f" of the traced {pwall:.1f} ms")
        return (f"{name}: device (CUDA events) {ev_ms:.1f} ms, wall "
                f"{wall:.1f} ms, {busy}, driver iterations {iters}")

    # (b) the demo, whole
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        demo = parareal_demo.main(["--device", "cuda"])
    demo_out = buf.getvalue().strip().splitlines()
    _check(demo_out[-1] == "ok", f"parareal_demo: {demo_out[-3:]}")

    # (c) the training loops
    tr = _training_loops(torch, dev)
    torch.cuda.synchronize()
    launches = {k: v for k, v in kernels.launch_counts.items() if v}
    _check(tr["sgd_equal"] and tr["fit_equal"] and tr["bf16"]
           and tr["adam_rel"] <= GRAD_F64_REL,
           f"training loops: {tr}")
    total = time.perf_counter() - p0
    print(f"[19a parareal] {card} | spiral H={H}, B={B} spirals as one state "
          f"of {2 * B}, t = linspace(0, 1, {PAR_T}) ({PAR_T - 1} slices), "
          f"dopri5 rtol={RTOL} atol={ATOL}, rk4 coarse 2 steps | float64 "
          f"n_iters={PAR_T - 1} vs the slice-restarted chain: values "
          f"{err64:.2e} of max|y| (<= {PAR_VALUES}), gradients in y0, the "
          f"MLP and t {grad64:.2e} of max|g| (<= {PAR_GRAD_REL}); deltas "
          f"{['%.2e' % d for d in d64.cpu().tolist()]} | float32 "
          f"n_iters={PAR_FAST_ITERS}: deltas "
          f"{['%.2e' % d for d in rows['parareal'][7].cpu().tolist()]}, "
          f"{err32:.2e} of max|y| from the chain | {row('parareal')} | "
          f"{row('chain')}")
    print(f"[19b parareal_demo] {card} | main() on the card, float32, 16 "
          f"slices, 5 iterations: {demo_out[-3]} | {demo_out[-2]} | "
          f"{demo_out[-1]}")
    print(f"[19c training loops] {card} | phase 10's step (odeint_adjoint, "
          f"spiral B={B}, SGD lr 1e-3) by make_sgd_step + scan_steps, 3 "
          f"steps: equal to the step by hand bit for bit {tr['sgd_equal']}, "
          f"losses {['%.7f' % x for x in tr['losses']]}; fit(5, 2 a "
          f"dispatch) == scan_steps(5) bit for bit {tr['fit_equal']}; "
          f"make_optax_step(adam) float64 3 steps vs torch.optim Adam by "
          f"hand: bit for bit {tr['adam_equal']}, {tr['adam_rel']:.2e} of "
          f"max|p| (<= {GRAD_F64_REL}); bfloat16 kept {tr['bf16']} | "
          f"{tr['step_s'] * 1e3:.2f} ms a step under scan_steps (host wall), "
          f"phase 10's median {train_ms:.2f} ms | kernel launches "
          f"{launches or 'none'} (no kernel on this path)")
    print(f"[19 budget] phase 19 took {total:.1f} s (budget {PAR_BUDGET_S} s)")
    _check(total <= PAR_BUDGET_S, f"phase 19 took {total:.1f} s")


def _order2_vs_plain(torch, kernels, dev):
    """Phase 8b (C22): the hand-written K-dopri5 and K-events in float64
    with the order-2 methods (fehlberg2, adaptive_heun), whose initial
    step and controller take x**(1/2) as the square root, as the plain
    versions' power by 0.5 does: on a field with no sum to reorder (D=1,
    H=1, power 1) every output, count and NaN equals the plain version's,
    with the default controller and with a max_steps (the plain version's
    median step count) that leaves half the lanes NaN.  Returns {kernel
    name: [methods equal bit for bit]}."""
    from torchdiffeq_tpu_torch.models import LinearEvent, mlp_params_from_jax
    rng = np.random.RandomState(0)
    model = mlp_params_from_jax(
        [dict(w=rng.randn(1, 1), b=rng.randn(1) * 0.1),
         dict(w=rng.randn(1, 1), b=rng.randn(1) * 0.1)], power=1,
        device=dev).requires_grad_(False)
    y0 = torch.from_numpy(rng.randn(1, B)).to(dev)
    thr = -float(y0[0].median())
    event = LinearEvent([[1.0], [0.0]], time_coef=[0.0, 1.0],
                        bias=[thr, -1.0], dtype=torch.float64,
                        device=dev).requires_grad_(False)
    sign0 = torch.sign(event(torch.zeros((), dtype=torch.float64,
                                         device=dev), y0.T)).T.contiguous()
    kw = dict(ts=np.linspace(0.0, 1.0, 6), rtol=1e-5, atol=1e-7)
    ekw = dict(rtol=1e-5, atol=1e-7, ev_params=(sign0,))
    out = {"dopri5_integrate_batched": [], "dopri5_events_batched": []}
    nan_rows = {}
    with torch.no_grad():
        for method in ("fehlberg2", "adaptive_heun"):
            full = kernels.dopri5_integrate_batched_ref(
                model, y0, 0.0, 1.0, method=method, **kw)
            median = int(full[2].double().median())
            same = {k: True for k in out}
            for max_steps in (10_000, median):
                for name, a, opts in (
                        ("dopri5_integrate_batched", (1.0,), kw),
                        ("dopri5_events_batched", (event,), ekw)):
                    got, want = (getattr(kernels, name + suffix)(
                        model, y0, 0.0, *a, method=method,
                        max_steps=max_steps, **opts)
                        for suffix in ("", "_ref"))
                    same[name] &= all(
                        torch.equal(torch.isnan(g), torch.isnan(w))
                        and torch.equal(torch.nan_to_num(g),
                                        torch.nan_to_num(w))
                        for g, w in zip(got, want))
                    if name == "dopri5_integrate_batched":
                        nan_rows[(method, max_steps)] = float(
                            torch.isnan(want[0][-1]).float().mean())
            for k in out:
                if same[k]:
                    out[k].append(method)
    torch.cuda.synchronize()
    ok = all(v == ["fehlberg2", "adaptive_heun"] for v in out.values())
    _check(ok, f"order-2 K-dopri5/K-events float64 vs plain, bit for bit: "
           f"{out}")
    print(f"[8b order 2 (C22)] K-dopri5 and K-events float64, fehlberg2 and "
          f"adaptive_heun, D=1 H=1 B={B}: every output, count and NaN equal "
          f"to the plain version's {out} | lanes NaN at the median max_steps "
          + ", ".join(f"{m} {v:.3f}" for (m, k), v in nan_rows.items()
                      if k != 10_000))
    return out


def _mesh_rank(rank, world, store, out):
    """One rank of phase 20 (b), run as ``chip_smoke.py --mesh-rank RANK
    WORLD STORE OUT``: gloo on the card, `data_parallel_odeint` of phase
    4's float64 spiral solve, and `_mesh_checks`; writes its values,
    counters and checks to OUT."""
    import torch
    import torch.distributed as dist
    from torchdiffeq_tpu_torch import odeint_with_stats
    from torchdiffeq_tpu_torch.parallel import data_parallel_odeint, make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh({"data": world})
        model, y_big = _spiral(torch, torch.float64, mesh.device)
        t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
        with torch.no_grad():
            ys, st = data_parallel_odeint(odeint_with_stats, mesh)(
                model, y_big[:MESH_B].contiguous(), t, rtol=RTOL, atol=ATOL)
        checks = _mesh_checks(torch, mesh, make_mesh({"time": world}))
        torch.save(dict(ys=ys.cpu(), st=list(st[:5]),
                        device=str(ys.device), checks=checks), out)
    finally:
        dist.destroy_process_group()


def _mesh_checks(torch, mesh, tmesh):
    """The decisions `data_parallel_odeint` makes global and Parareal's
    mesh gradient (phase 20 (b), `--mesh-cards`), float64 on this rank's
    card, each against the single-device solve on it: kvaerno5 (its
    Newton stage solves), implicit_adams (its corrector) and a dopri5 event
    solve (a threshold on y[0, 0] halfway to its value at t=1, bisected to
    atol 1e-12) on MESH_DEC_B spirals; the values and the gradients of
    sum(ys**2) in y0, the MLP's parameters and t through
    `odeint_parareal(mesh=tmesh)` on MESH_PAR_B spirals, 2 slices a rank,
    against mesh=None.  Returns {name: [error relative to the largest
    value, counters equal (Parareal: its values under autograd those of
    its forward without, bit for bit)]}."""
    from torchdiffeq_tpu_torch import odeint_with_stats
    from torchdiffeq_tpu_torch.parallel import (data_parallel_odeint,
                                                odeint_parareal)
    model, y_big = _spiral(torch, torch.float64, mesh.device)
    yd = y_big[:MESH_DEC_B].contiguous()
    t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    solve = data_parallel_odeint(odeint_with_stats, mesh)
    out = {}

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    with torch.no_grad():
        end = odeint_with_stats(model, yd, t, rtol=RTOL, atol=ATOL)[0][-1]
        thr = float(0.5 * (yd[0, 0] + end[0, 0]))
        cases = (("kvaerno5", t, dict(method="kvaerno5")),
                 ("implicit_adams", t, dict(method="implicit_adams",
                                            options=dict(step_size=0.025))),
                 ("event", t[[0, -1]], dict(
                     event_fn=lambda s, y: y[0, 0] - thr, atol=1e-12)))
        for name, tt, kw in cases:
            kw = dict(dict(rtol=RTOL, atol=ATOL), **kw)
            got, st = solve(model, yd, tt, **kw)
            want, st1 = odeint_with_stats(model, yd, tt, **kw)
            if name == "event":
                err = max(rel(got[0], want[0]), rel(got[1], want[1]))
            else:
                err = rel(got, want)
            out[name] = [err, list(st[:5]) == list(st1[:5])]
    tp = torch.linspace(0.0, 1.0, 2 * tmesh.shape["time"] + 1,
                        dtype=torch.float64)
    par = dict(rtol=RTOL, atol=ATOL, n_iters=2, axis="time")
    with torch.no_grad():
        ys_fwd = odeint_parareal(model, y_big[:MESH_PAR_B], tp, mesh=tmesh,
                                 **par)
    model.requires_grad_(True)
    grads = []
    for m in (tmesh, None):
        y0 = y_big[:MESH_PAR_B].clone().requires_grad_(True)
        tg = tp.clone().requires_grad_(True)
        ys = odeint_parareal(model, y0, tg, mesh=m, **par)
        grads.append([ys.detach()] + list(torch.autograd.grad(
            (ys ** 2).sum(), [y0, tg, *model.parameters()])))
    # the mesh's forward under autograd is its forward without, bit for bit
    out["parareal_grad"] = [max(rel(a, b) for a, b in zip(*grads)),
                            torch.equal(grads[0][0], ys_fwd)]
    return out


def _mesh_checks_ok(checks):
    return all(err <= MESH_F64_REL and same for err, same in checks.values())


def _parareal_step_ms(torch, mesh, dev):
    """`--mesh-cards`: Parareal's forward and gradient step (phase 19's
    float32 spiral field and B spirals as one state, 2 slices a card,
    n_iters PAR_FAST_ITERS; the gradient of sum(ys[-1]**2) in y0 and the
    parameters) on the cards' mesh and on this rank's card alone (every
    rank at once), each the median of MESH_PAR_REPS after a warm one:
    (mesh ms, one-card ms, the steps' values' relative difference)."""
    from torchdiffeq_tpu_torch.parallel import odeint_parareal
    model, y_big = _spiral(torch, torch.float32, dev)
    model.requires_grad_(True)
    y0 = y_big[:B].clone().requires_grad_(True)
    tp = torch.linspace(0.0, 1.0, 2 * mesh.shape["time"] + 1,
                        dtype=torch.float64)

    def step(m):
        ys = odeint_parareal(model, y0, tp, rtol=RTOL, atol=ATOL,
                             n_iters=PAR_FAST_ITERS, mesh=m, axis="time")
        g = torch.autograd.grad((ys[-1] ** 2).sum(),
                                [y0, *model.parameters()])
        return ys.detach(), g

    out = {}
    for name, m in (("mesh", mesh), ("one", None)):
        step(m)
        ms = []
        for _ in range(MESH_PAR_REPS):
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            res = step(m)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - w0) * 1e3)
        out[name] = (float(np.median(ms)), res[0])
    diff = float((out["mesh"][1] - out["one"][1]).abs().max()
                 / out["one"][1].abs().max())
    return out["mesh"][0], out["one"][0], diff


def _mesh_cards():
    """``torchrun --nproc_per_node=N chip_smoke.py --mesh-cards``: the
    device mesh across N cards, one rank a card, on NCCL: phase 4's
    float64 spiral through `data_parallel_odeint` against the single
    solve, `sharded_independent_odeint` against each block's own solve
    (bit for bit, counters equal), Parareal's `mesh=` on 2N slices against
    the one-device scheme (bit for bit), the gradient of sum(ys[-1]**2) in
    the MLP's parameters through the sharded gather, all-reduced, against
    the blocks' gradients summed on one rank, the decisions
    `data_parallel_odeint` makes global and Parareal's mesh gradient
    (`_mesh_checks`), Parareal's forward and gradient step on the N cards
    against one (`_parareal_step_ms`), and the JAX dry run's sharded
    training step (`_mesh_cards_step`; its ``--full-width`` step timed).
    Rank 0 prints every rank's results and a last line ``mesh-cards ok``;
    exits non-zero otherwise."""
    import torch
    import torch.distributed as dist
    from torchdiffeq_tpu_torch import odeint_adjoint, odeint_with_stats
    from torchdiffeq_tpu_torch.parallel import (
        data_parallel_odeint, make_mesh, odeint_parareal,
        sharded_independent_odeint)
    mesh = make_mesh({"data": -1})
    n, dev = mesh.shape["data"], mesh.device
    model, y_big = _spiral(torch, torch.float64, dev)
    y0 = y_big[:B].contiguous()
    t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    kw = dict(rtol=RTOL, atol=ATOL)
    b = B // n
    out = {}
    with torch.no_grad():
        ref, st = odeint_with_stats(model, y0, t, **kw)
        ys, st_dp = data_parallel_odeint(odeint_with_stats, mesh)(
            model, y0, t, **kw)
        out["data_parallel_rel"] = float((ys - ref).abs().max()
                                         / ref.abs().max())
        out["data_parallel_counters"] = list(st_dp[:5]) == list(st[:5])
        ys, sts = sharded_independent_odeint(odeint_with_stats, mesh)(
            model, y0, t, **kw)
        blocks = [odeint_with_stats(model, y0[i * b:(i + 1) * b], t, **kw)
                  for i in range(n)]
        out["sharded_bitwise"] = torch.equal(
            ys, torch.cat([x[0] for x in blocks], 1))
        out["sharded_counters"] = ([list(x[:5]) for x in sts]
                                   == [list(x[1][:5]) for x in blocks])
        tp = torch.linspace(0.0, 1.0, 2 * n + 1, dtype=torch.float64)
        par = [odeint_parareal(model, y0[:64], tp, n_iters=2, **kw, **m)
               for m in (dict(mesh=make_mesh({"time": -1}), axis="time"),
                         {})]
        out["parareal_bitwise"] = torch.equal(*par)
    model.requires_grad_(True)

    def grad_of(ys):
        (ys[-1] ** 2).sum().backward()
        g = torch.cat([p.grad.reshape(-1) for p in model.parameters()])
        model.zero_grad(set_to_none=True)
        return g

    g = grad_of(sharded_independent_odeint(
        lambda f, y, tt, **k: odeint_adjoint(f, y, tt, **k), mesh)(
            model, y0, t, **kw))
    dist.all_reduce(g, group=mesh.group("data"))
    g1 = sum(grad_of(odeint_adjoint(model, y0[i * b:(i + 1) * b], t, **kw))
             for i in range(n))
    out["sharded_grad_rel"] = float((g - g1).abs().max() / g1.abs().max())
    model.requires_grad_(False)
    tmesh = make_mesh({"time": -1})
    out["checks"] = _mesh_checks(torch, mesh, tmesh)
    (out["parareal_step_mesh_ms"], out["parareal_step_one_ms"],
     out["parareal_step_rel"]) = _parareal_step_ms(torch, tmesh, dev)
    out.update(_mesh_cards_step(torch, n))
    res = [None] * dist.get_world_size()
    dist.all_gather_object(res, out)
    ok = all(r["data_parallel_rel"] <= MESH_F64_REL
             and r["sharded_grad_rel"] <= MESH_F64_REL
             and max(r["step_f64_rel"]) <= STEP_F64_REL
             and r["step_f32_rel"][0] < r["jax_bounds"][0]
             and r["step_f32_rel"][1] < r["jax_bounds"][1]
             and r["full_width_rel"][0] < r["jax_bounds"][0]
             and r["full_width_rel"][1] < r["jax_bounds"][1]
             and _mesh_checks_ok(r["checks"])
             and all(v for k, v in r.items()
                     if not k.endswith(("_rel", "_ms", "_bounds", "mesh",
                                        "checks")))
             for r in res)
    if dist.get_rank() == 0:
        print(f"[mesh-cards] {_card()} | mesh {mesh.shape} on "
              f"{dist.get_backend()}, {torch.cuda.get_device_name(0)} x"
              f"{torch.cuda.device_count()}: {res}")
        print("mesh-cards " + ("ok" if ok else "FAILED"))
    dist.destroy_process_group()
    return 0 if ok else 1


def _mesh_cards_step(torch, n):
    """`--mesh-cards`' sharded step (examples/sharded_step.py) on the JAX
    dry run's mesh for `n` cards ({'data': 2, 'model': 2} at 4): its
    float32 step against the unsharded one within the dry run's bounds, its
    float64 step within STEP_F64_REL with equal counters, and
    ``--full-width`` (bench.py's main cell) with its ms a step."""
    from torchdiffeq_tpu_torch.examples import sharded_step
    from torchdiffeq_tpu_torch.parallel import make_mesh
    out = {}
    for full in (False, True):
        cfg = sharded_step.config(n, full)
        mesh = make_mesh(cfg["mesh"])
        out["step_mesh"] = cfg["mesh"]
        kw = {k: cfg[k] for k in ("rtol", "atol", "lr", "last_only")}
        for dtype in ((torch.float32,) if full
                      else (torch.float32, torch.float64)):
            field, y0, tgt = sharded_step.make_problem(
                cfg["hidden"], cfg["batch"], dtype, mesh.device)
            if full:
                r = sharded_step.run(mesh, field, y0, tgt, cfg)
                out["full_width_rel"] = (r["loss_rel_diff"],
                                         r["grad_rel_diff"])
                out["full_width_step_ms"] = r["step_ms"]
                continue
            r, _ = _sharded_vs_single(torch, mesh, field, y0, tgt,
                                      cfg["t"], **kw)
            if dtype == torch.float32:
                out["step_f32_rel"] = _step_rels(r)
                continue
            out["step_f64_rel"] = _step_rels(r)
            out["step_f64_counters"] = (
                r["sharded"]["fwd"] == r["single"]["fwd"]
                and r["sharded"]["bwd"] == r["single"]["bwd"])
    out["jax_bounds"] = (sharded_step.LOSS_REL, sharded_step.GRAD_REL)
    return out


def _phase_mesh(torch, kernels, dev, summary):
    """Phase 20: the device mesh (`parallel/sharding.py`) on the card."""
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    from torchdiffeq_tpu_torch import odeint_per_sample, odeint_with_stats
    from torchdiffeq_tpu_torch.parallel import (
        data_parallel_odeint, make_mesh, odeint_parareal,
        sharded_independent_odeint)
    p0 = time.perf_counter()
    card = _card()

    # (a) a world of one rank, NCCL
    mesh = make_mesh({"data": 1})
    backend = dist.get_backend()
    model64, y64 = _spiral(torch, torch.float64, dev)
    y0 = y64[:MESH_B].contiguous()
    t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
    with torch.no_grad():
        ref, st_ref = odeint_with_stats(model64, y0, t, rtol=RTOL, atol=ATOL)
        ys_dp, st_dp = data_parallel_odeint(odeint_with_stats, mesh)(
            model64, y0, t, rtol=RTOL, atol=ATOL)
        ys_sh, st_sh = sharded_independent_odeint(odeint_with_stats, mesh)(
            model64, y0, t, rtol=RTOL, atol=ATOL)
        tmesh = make_mesh({"time": 1})
        par_kw = dict(rtol=RTOL, atol=ATOL, n_iters=2)
        par_m = odeint_parareal(model64, y0[:64], t, mesh=tmesh, axis="time",
                                **par_kw)
        par_v = odeint_parareal(model64, y0[:64], t, **par_kw)
    same = dict(data_parallel=torch.equal(ys_dp, ref)
                and list(st_dp) == list(st_ref),
                sharded=torch.equal(ys_sh, ref) and st_sh == (st_ref,),
                parareal=torch.equal(par_m, par_v))
    _check(all(same.values()) and ys_dp.is_cuda,
           f"world of one ({backend}) vs unsharded, bit for bit: {same}")

    # the per-sample K-dopri5 route under the mesh, counted
    model32, y32 = _spiral(torch, torch.float32, dev)
    yk = y32[:MESH_B].contiguous()
    per_sample = sharded_independent_odeint(
        lambda f, y, tt, **kw: odeint_per_sample(f, y, tt, **kw)
        .transpose(0, 1), mesh)
    with torch.no_grad():
        kernels.reset_launch_counts()
        ys_k = per_sample(model32, yk, t, rtol=RTOL, atol=ATOL,
                          options=dict(pallas=True))
        torch.cuda.synchronize()
        k_launches = kernels.launch_counts["dopri5_integrate_batched"]
        ts = np.linspace(0.0, 1.0, T).astype(np.float32)
        ys_r, _, stp_r = kernels.dopri5_integrate_batched_ref(
            model32, yk.T.contiguous(), 0.0, 1.0, ts=ts, rtol=RTOL,
            atol=ATOL)
    _check(k_launches > 0, "kernel dopri5_integrate_batched was not launched "
           "on the sharded per-sample route")
    err_k = float((ys_k.permute(0, 2, 1) - ys_r).abs().max())
    _check(tuple(ys_k.shape) == (T, MESH_B, 2)
           and err_k <= F32_ADAPTIVE_VALUES,
           f"sharded K-dopri5 vs plain: max|dy|={err_k}")
    entry = next(e for e in summary
                 if e["name"] == "dopri5_integrate_batched")
    entry.update(launches_mesh=k_launches, max_abs_err_mesh=err_k)
    dist.destroy_process_group()
    a_s = time.perf_counter() - p0

    # (b) MESH_RANKS ranks on the card, gloo
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    procs = []
    try:
        for r in range(MESH_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--mesh-rank",
                 str(r), str(MESH_RANKS), os.path.join(tmp, "store"),
                 os.path.join(tmp, f"rank{r}.pt")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=MESH_BUDGET_S)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            _check(p.returncode == 0,
                   f"mesh rank {r} of {MESH_RANKS} (gloo on the card) "
                   f"failed:\n{log[-3000:]}")
        res = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
               for r in range(MESH_RANKS)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    scale = float(ref.abs().max())
    errs = [float((x["ys"] - ref.cpu()).abs().max()) / scale for x in res]
    _check(all(e <= MESH_F64_REL for e in errs)
           and all(x["st"] == list(st_ref[:5]) for x in res)
           and all(x["device"].startswith("cuda") for x in res),
           f"{MESH_RANKS} ranks data_parallel vs single: {errs} of max|y|, "
           f"counters {[x['st'] for x in res]} vs {list(st_ref[:5])}")
    checks = [x["checks"] for x in res]
    _check(all(_mesh_checks_ok(c) for c in checks),
           f"{MESH_RANKS} ranks, global decisions and Parareal's mesh "
           f"gradient vs single (<= {MESH_F64_REL}, counters equal): "
           f"{checks}")
    total = time.perf_counter() - p0
    print(f"[20a mesh, world of one] {card} | make_mesh on {backend}: "
          f"data_parallel_odeint, sharded_independent_odeint (spiral float64 "
          f"B={MESH_B}, dopri5) and odeint_parareal(mesh=) (64 spirals, 2 "
          f"iterations) equal their unsharded solves bit for bit {same} | "
          f"per-sample K-dopri5 under sharded_independent_odeint, float32 "
          f"B={MESH_B}: launches {k_launches}, vs plain max|dy|={err_k:.3e} "
          f"(<= {F32_ADAPTIVE_VALUES}) | {a_s:.1f} s")
    print(f"[20b mesh, {MESH_RANKS} ranks on one card] {card} | gloo, "
          f"data_parallel_odeint spiral float64 B={MESH_B} dopri5: each rank "
          f"vs the single solve {['%.2e' % e for e in errs]} of max|y| (<= "
          f"{MESH_F64_REL}), counters {res[0]['st']} equal on every rank | "
          f"global decisions on {MESH_DEC_B} spirals and Parareal's mesh "
          f"gradient, each rank vs the single solve [max error of max|y|, "
          f"counters equal]: "
          + "; ".join(f"{k} " + ", ".join(f"[{c[k][0]:.2e}, {c[k][1]}]"
                                          for c in checks)
                      for k in checks[0]))
    print(f"[20 budget] phase 20 took {total:.1f} s (budget "
          f"{MESH_BUDGET_S} s)")
    _check(total <= MESH_BUDGET_S, f"phase 20 took {total:.1f} s")


# the gradient route data_parallel_odeint refuses (phase 21 (b)), under
# autograd with a tensor_parallel_mlp field: (name, entry point, keywords)
STEP_REFUSED = (
    ("tensor_parallel_implicit_adjoint", "odeint_adjoint",
     dict(adjoint_method="kvaerno5")),)
# phase 21's deeper tensor-parallel field: three hidden layers of the
# step's width (two Megatron pairs)
STEP_DEEP = 3


def _sharded_vs_single(torch, mesh, field, y0, target, t, **kw):
    """One training step of `field` (an MLPField) split by
    `tensor_parallel_mlp` over `mesh`'s 'model' axis with the batch over
    'data' (`data_parallel_odeint` of `odeint_adjoint`), and the same step
    of an unsharded copy: {'sharded'|'single': dict(loss, grads (the
    sharded ones gathered), fwd and bwd counters)} and the sharded field.
    `kw` is `sharded_step.train_step`'s rtol, atol, lr, last_only."""
    import copy
    from torchdiffeq_tpu_torch import odeint_adjoint, odeint_with_stats
    from torchdiffeq_tpu_torch.examples.sharded_step import train_step
    from torchdiffeq_tpu_torch.parallel import (data_parallel_odeint,
                                                tensor_parallel_mlp)
    tp = tensor_parallel_mlp(field, mesh)
    out = {}
    for name, f, solve, stats in (
            ("sharded", tp, data_parallel_odeint(odeint_adjoint, mesh),
             data_parallel_odeint(odeint_with_stats, mesh)),
            ("single", copy.deepcopy(field), odeint_adjoint,
             odeint_with_stats)):
        with torch.no_grad():
            _, st = stats(f, y0, t, rtol=kw["rtol"], atol=kw["atol"])
        with _BackwardStats() as bwd:
            loss, grads = train_step(f, solve, y0, target, t, **kw)
        if name == "sharded":
            grads = tp.gather(grads)
        out[name] = dict(loss=loss, grads=grads, bwd=bwd.counters(),
                         fwd=[int(x) for x in st[:5]])
    return out, tp


def _step_rels(res):
    """(|loss - single| / |single|, max|g - single| / max|single|)."""
    from torchdiffeq_tpu_torch.examples.sharded_step import rel_diffs
    sh, one = res["sharded"], res["single"]
    return rel_diffs(sh["loss"], sh["grads"], one["loss"], one["grads"])


def _deep_field(torch, hidden, dtype, device):
    """Phase 21's deeper field: an `MLPField` of STEP_DEEP hidden layers of
    `hidden` units on y**3, weights scaled 0.1 from ``torch.Generator``
    seed 0 and biases 0.1 * randn from seed 3 (a zero bias would hide one
    added on every model rank)."""
    from torchdiffeq_tpu_torch.models import MLPField
    field = MLPField([2] + [hidden] * STEP_DEEP + [2], power=3, scale=0.1,
                     dtype=dtype, device=device,
                     generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for b in field.biases:
            b.copy_(0.1 * torch.randn(b.shape, generator=gen, dtype=dtype))
    return field


def _step_rank(rank, world, store, out):
    """One rank of phase 21 (b), run as ``chip_smoke.py --step-rank RANK
    WORLD STORE OUT``: gloo on the card, the JAX dry run's float64 step on
    {'data': 1, 'model': WORLD} and {'data': WORLD, 'model': 1}, and the
    deeper field's (`_deep_field`) on the first, each against the
    unsharded step, and each refused gradient route's message; writes them
    to OUT."""
    import torch
    import torch.distributed as dist
    import torchdiffeq_tpu_torch as tt
    from torchdiffeq_tpu_torch.examples import sharded_step
    from torchdiffeq_tpu_torch.parallel import (data_parallel_odeint,
                                                make_mesh, tensor_parallel_mlp)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        cfg = sharded_step.config(world)
        kw = {k: cfg[k] for k in ("rtol", "atol", "lr", "last_only")}
        res = {}
        for shape in ({"data": 1, "model": world},
                      {"data": world, "model": 1}):
            mesh = make_mesh(shape)
            field, y0, tgt = sharded_step.make_problem(
                cfg["hidden"], cfg["batch"], torch.float64, mesh.device)
            fields = {f"data{shape['data']}": field}
            if shape["data"] == 1:
                fields["deep"] = _deep_field(torch, cfg["hidden"],
                                             torch.float64, mesh.device)
            for key, f in fields.items():
                r, _ = _sharded_vs_single(torch, mesh, f, y0, tgt, cfg["t"],
                                          **kw)
                res[key] = dict(
                    rels=_step_rels(r), fwd=(r["sharded"]["fwd"],
                                             r["single"]["fwd"]),
                    bwd=(r["sharded"]["bwd"], r["single"]["bwd"]),
                    device=str(r["sharded"]["loss"].device))
        refused = {}
        tp = tensor_parallel_mlp(field, mesh)
        for name, entry, kwr in STEP_REFUSED:
            try:
                data_parallel_odeint(getattr(tt, entry), mesh)(
                    tp, y0.clone().requires_grad_(True), cfg["t"], **kwr)
                refused[name] = None
            except NotImplementedError as err:
                refused[name] = str(err)
        res["refused"] = refused
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _check_step_ranks(ranks, device_type):
    """Phase 21 (b)'s checks of every rank's `_step_rank` results: each
    mesh's step within STEP_F64_REL of the single step, its forward and
    backward counters equal, on a `device_type` device, and every refused
    route refused.  Returns {mesh: every rank's rel diffs}."""
    meshes = [k for k in ranks[0] if k != "refused"]
    rels = {k: [x[k]["rels"] for x in ranks] for k in meshes}
    pairs = [x[k][c] for x in ranks for k in meshes for c in ("fwd", "bwd")]
    _check(all(max(r) <= STEP_F64_REL for k in meshes for r in rels[k])
           and all(sharded == single for sharded, single in pairs)
           and all(x[k]["device"].startswith(device_type)
                   for x in ranks for k in meshes),
           f"{len(ranks)} ranks sharded step vs single: {rels}, counters "
           f"(sharded, single) {pairs}")
    unrefused = [(r, k) for r, x in enumerate(ranks)
                 for k, v in x["refused"].items() if v is None]
    _check(not unrefused, f"gradient routes not refused: {unrefused}")
    return rels


def _phase_sharded_step(torch, kernels, dev, train_ms):
    """Phase 21: the sharded training step of the JAX package's
    `__graft_entry__.dryrun_multichip` (examples/sharded_step.py) on the
    card."""
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    from torchdiffeq_tpu_torch.examples.sharded_step import train_step
    from torchdiffeq_tpu_torch import odeint_adjoint
    from torchdiffeq_tpu_torch.parallel import data_parallel_odeint, make_mesh
    p0 = time.perf_counter()
    card = _card()

    # (a) phase 10's step through the mesh's world of one rank, NCCL
    mesh = make_mesh({"data": 1, "model": 1})
    backend = dist.get_backend()
    model, y0, target, t = _train_setup(torch, np.float32, dev)
    kw = dict(rtol=RTOL, atol=ATOL, lr=1e-3, last_only=False)
    kernels.reset_launch_counts()
    res, tp = _sharded_vs_single(torch, mesh, model, y0, target, t, **kw)
    torch.cuda.synchronize()
    launches = {k: v for k, v in (*kernels.launch_counts.items(),
                                  *kernels.traced_launch_counts.items())
                if v}
    sh, one = res["sharded"], res["single"]
    same = dict(loss=torch.equal(sh["loss"], one["loss"]),
                grads=all(torch.equal(a, b)
                          for a, b in zip(sh["grads"], one["grads"])),
                fwd=sh["fwd"] == one["fwd"], bwd=sh["bwd"] == one["bwd"])
    _check(all(same.values()) and sh["loss"].is_cuda and not launches,
           f"sharded step, world of one ({backend}) vs unsharded, bit for "
           f"bit: {same}; kernel launches {launches}")
    # the deeper field (STEP_DEEP hidden layers), bit for bit too
    deep, _ = _sharded_vs_single(
        torch, mesh, _deep_field(torch, H, torch.float32, dev), y0, target,
        t, **kw)
    dsh, done = deep["sharded"], deep["single"]
    deep_same = (torch.equal(dsh["loss"], done["loss"])
                 and all(torch.equal(a, b)
                         for a, b in zip(dsh["grads"], done["grads"]))
                 and dsh["fwd"] == done["fwd"] and dsh["bwd"] == done["bwd"])
    _check(deep_same, f"sharded step of {STEP_DEEP} hidden layers, world of "
           f"one ({backend}) vs unsharded, not bit for bit: loss "
           f"{dsh['loss']} vs {done['loss']}")
    solve = data_parallel_odeint(odeint_adjoint, mesh)
    ms = []
    for _ in range(STEP_TIMED):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        torch.cuda.synchronize()
        ev[0].record()
        train_step(tp, solve, y0, target, t, **kw)
        ev[1].record()
        torch.cuda.synchronize()
        ms.append(ev[0].elapsed_time(ev[1]))
    dist.destroy_process_group()
    a_s = time.perf_counter() - p0

    # (b) STEP_RANKS ranks on the card, gloo
    tmp = tempfile.mkdtemp(prefix="chip_smoke_step_")
    procs = []
    try:
        for r in range(STEP_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--step-rank",
                 str(r), str(STEP_RANKS), os.path.join(tmp, "store"),
                 os.path.join(tmp, f"rank{r}.pt")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=STEP_BUDGET_S)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            _check(p.returncode == 0,
                   f"step rank {r} of {STEP_RANKS} (gloo on the card) "
                   f"failed:\n{log[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(STEP_RANKS)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    rels = _check_step_ranks(ranks, "cuda")
    total = time.perf_counter() - p0
    print(f"[21a sharded step, world of one] {card} | make_mesh({{'data': 1, "
          f"'model': 1}}) on {backend}: phase 10's step (B={B} H={H} T={T} "
          f"float32, odeint_adjoint rtol={RTOL} atol={ATOL}, SGD lr 1e-3) "
          f"through data_parallel_odeint and tensor_parallel_mlp equals the "
          f"unsharded step bit for bit {same} (forward {sh['fwd']}, backward "
          f"{sh['bwd']}), and so does a field of {STEP_DEEP} hidden layers "
          f"(forward {dsh['fwd']}, backward {dsh['bwd']}); kernel launches "
          f"{launches} (the steps run none) | "
          f"step over {STEP_TIMED}: median {np.median(ms):.2f} ms (min "
          f"{min(ms):.2f}, max {max(ms):.2f}) beside phase 10's "
          f"{train_ms:.2f} ms | {a_s:.1f} s")
    print(f"[21b sharded step, {STEP_RANKS} ranks on one card] {card} | "
          f"gloo, the dry run's float64 step (hidden 128, batch 32, dopri5 "
          f"rtol 1e-2 atol 1e-3): (loss, gradient) rel diffs vs the single "
          f"step per rank "
          + "; ".join(f"{k}: " + ", ".join("(%.2e, %.2e)" % r for r in v)
                      for k, v in rels.items())
          + f" (<= {STEP_F64_REL}), counters equal; refused on every rank: "
          f"{sorted(ranks[0]['refused'])}")
    print(f"[21 budget] phase 21 took {total:.1f} s (budget "
          f"{STEP_BUDGET_S} s)")
    _check(total <= STEP_BUDGET_S, f"phase 21 took {total:.1f} s")


def _max_rms(xs):
    """A callable adjoint norm: the largest RMS of its parts."""
    import torch
    return torch.stack([torch.sqrt(torch.mean(x.abs() ** 2))
                        for x in xs]).max()


# phase 21 (c) (b)'s routes, each under autograd: (name, entry point,
# keywords); "event" is odeint with an event function, its state
ROUTES = (
    ("fixed_grid", "odeint",
     dict(method="rk4", options=dict(num_steps=FIXED_STEPS))),
    ("replay_grad", "odeint", dict(options=dict(replay_grad=True))),
    ("forward_grad", "odeint", dict(options=dict(forward_grad=True))),
    ("interpolated", "odeint_adjoint",
     dict(adjoint_options=dict(interpolated=True))),
    ("callable_norm", "odeint_adjoint",
     dict(adjoint_options=dict(norm=_max_rms))),
    ("implicit_fixed_grid", "odeint",
     dict(method="implicit_euler", options=dict(num_steps=FIXED_STEPS))),
    ("event_solve", "event", dict(atol=1e-12)),
    ("scipy_adjoint", "odeint_adjoint",
     dict(adjoint_method="scipy_solver", adjoint_options=dict(solver="RK45"))),
    ("implicit_adjoint", "odeint_adjoint", dict(adjoint_method="kvaerno5")),
    # 8 steps an interval, so that the corrector runs past the RK4 bootstrap
    ("adams_adjoint", "odeint_adjoint",
     dict(adjoint_method="implicit_adams",
          adjoint_options=dict(num_steps=8, max_order=4))))


class _ForwardStats:
    """While active, records the counters of every forward solve (each
    call of odeint's `_odeint_impl` and of the adjoint's
    `adjoint_solve`)."""

    def __enter__(self):
        from torchdiffeq_tpu_torch import adjoint
        self.saved = [(adjoint, "adjoint_solve"),
                      (sys.modules["torchdiffeq_tpu_torch.odeint"],
                       "_odeint_impl")]
        self.counters = []
        for module, name in self.saved:
            fn = getattr(module, name)

            def recorded(*a, _fn=fn, **k):
                out, st = _fn(*a, **k)
                self.counters.append([int(x) for x in st[:5]])
                return out, st
            recorded.original = fn
            setattr(module, name, recorded)
        return self

    def __exit__(self, *exc):
        for module, name in self.saved:
            setattr(module, name, getattr(module, name).original)


def _route_grads(torch, run, model, y0, t, thr, entry, kw):
    """`run`'s gradients of sum(ys**2) in y0, t and the spiral's
    parameters (forward_grad: the tangent of ys along y0 and t, all ones),
    and its forward and backward counters."""
    kw = dict(dict(rtol=RTOL, atol=ATOL), **kw)
    if entry == "event":
        kw["event_fn"] = lambda s, y: y[0, 0] - thr
        t = t[[0, -1]]
    with _ForwardStats() as fwd, _BackwardStats() as bwd:
        if "forward_grad" in kw.get("options", {}):
            _, tan = torch.func.jvp(lambda y, tt: run(model, y, tt, **kw),
                                    (y0, t), (torch.ones_like(y0),
                                              torch.ones_like(t)))
            grads = [tan]
        else:
            y = y0.clone().requires_grad_(True)
            tg = t.clone().requires_grad_(True)
            ys = run(model, y, tg, **kw)
            if entry == "event":
                ys = ys[1]
            xs = [y, tg, *model.parameters()]
            grads = [torch.zeros_like(x) if g is None else g for g, x in zip(
                torch.autograd.grad((ys ** 2).sum(), xs, allow_unused=True),
                xs)]
    return [g.detach() for g in grads], fwd.counters, bwd.counters()


def _grad_rank(rank, world, store, out):
    """One rank of phase 21 (c) (b), run as ``chip_smoke.py --grad-rank
    RANK WORLD STORE OUT``: gloo on the card, each ROUTES gradient of the
    float64 spiral (ROUTE_B states) through `data_parallel_odeint` against
    the single solve on the card; writes {name: [error relative to max|g|,
    forward and backward counters equal, the device, the seconds of both
    solves]} to OUT."""
    import torch
    import torch.distributed as dist
    import torchdiffeq_tpu_torch as tt
    from torchdiffeq_tpu_torch.parallel import data_parallel_odeint, make_mesh
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        mesh = make_mesh({"data": world})
        model, y_big = _spiral(torch, torch.float64, mesh.device)
        model.requires_grad_(True)
        y0 = y_big[:ROUTE_B].contiguous()
        t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)
        with torch.no_grad():
            end = tt.odeint(model, y0, t, rtol=RTOL, atol=ATOL)[-1]
        thr = float(0.5 * (y0[0, 0] + end[0, 0]))
        res = {}
        for name, entry, kw in ROUTES:
            fn = tt.odeint if entry == "event" else getattr(tt, entry)
            w0 = time.perf_counter()
            got = [_route_grads(torch, run, model, y0, t, thr, entry, kw)
                   for run in (data_parallel_odeint(fn, mesh), fn)]
            (g, fwd, bwd), (g1, fwd1, bwd1) = got
            err = max(float((a - b).abs().max()
                            / b.abs().max().clamp(min=1e-300))
                      for a, b in zip(g, g1))
            res[name] = [err, fwd == fwd1 and bwd == bwd1,
                         str(g[0].device), time.perf_counter() - w0]
        torch.save(res, out)
    finally:
        dist.destroy_process_group()


def _phase_grad_routes(torch, kernels, dev, fixed_ms):
    """Phase 21 (c): gradients through `data_parallel_odeint`'s routes
    that run their backward over each rank's block, on the card."""
    import os
    import shutil
    import tempfile
    import torch.distributed as dist
    from torchdiffeq_tpu_torch.parallel import data_parallel_odeint, make_mesh
    from torchdiffeq_tpu_torch import odeint
    p0 = time.perf_counter()
    card = _card()

    # (a) phase 11's fixed-grid training step through the mesh's world of
    # one rank, NCCL, against the unsharded step from the same weights
    mesh = make_mesh({"data": 1})
    backend = dist.get_backend()
    solve = data_parallel_odeint(odeint, mesh)
    opts = dict(num_steps=FIXED_STEPS)
    steps = {}
    kernels.reset_launch_counts()
    for name, run in (("sharded", solve), ("single", None)):
        model, y0, target, t = _train_setup(torch, np.float32, dev)
        steps[name] = _fixed_step(torch, model, y0, target, t, opts,
                                  solve=run)
    torch.cuda.synchronize()
    launches = {k: v for k, v in (*kernels.launch_counts.items(),
                                  *kernels.traced_launch_counts.items()) if v}
    (loss, grads), (loss1, grads1) = steps["sharded"], steps["single"]
    same = dict(loss=torch.equal(loss, loss1),
                grads=all(torch.equal(a, b) for a, b in zip(grads, grads1)))
    _check(all(same.values()) and loss.is_cuda and not launches,
           f"fixed-grid step through data_parallel_odeint, world of one "
           f"({backend}) vs unsharded, bit for bit: {same}; kernel launches "
           f"{launches}")
    # the sharded and the unsharded step in pairs, alternating which runs
    # first, so that the host's drift within the phase falls on both
    ms = {"sharded": [], "single": []}
    for i in range(ROUTE_TIMED):
        order = (("sharded", solve), ("single", None))
        for name, run in order[::-1] if i % 2 else order:
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            torch.cuda.synchronize()
            _fixed_step(torch, model, y0, target, t, opts, marks, solve=run)
            torch.cuda.synchronize()
            ms[name].append(marks[0].elapsed_time(marks[3]))
    med = {k: float(np.median(v)) for k, v in ms.items()}
    dist.destroy_process_group()
    a_s = time.perf_counter() - p0

    # (b) ROUTE_RANKS ranks on the card, gloo
    tmp = tempfile.mkdtemp(prefix="chip_smoke_routes_")
    procs = []
    try:
        for r in range(ROUTE_RANKS):
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--grad-rank",
                 str(r), str(ROUTE_RANKS), os.path.join(tmp, "store"),
                 os.path.join(tmp, f"rank{r}.pt")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        logs = [p.communicate(timeout=ROUTE_BUDGET_S)[0] for p in procs]
        for r, (p, log) in enumerate(zip(procs, logs)):
            _check(p.returncode == 0,
                   f"route rank {r} of {ROUTE_RANKS} (gloo on the card) "
                   f"failed:\n{log[-3000:]}")
        ranks = [torch.load(os.path.join(tmp, f"rank{r}.pt"))
                 for r in range(ROUTE_RANKS)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    bad = [(r, k, v) for r, x in enumerate(ranks) for k, v in x.items()
           if not (v[0] <= ROUTE_F64_REL and v[1]
                   and v[2].startswith("cuda"))]
    _check(not bad and all(set(x) == {n for n, _, _ in ROUTES}
                           for x in ranks),
           f"{ROUTE_RANKS} ranks, gradient routes vs single (<= "
           f"{ROUTE_F64_REL}, counters equal, on the card): {bad}")
    total = time.perf_counter() - p0
    print(f"[21c gradient routes, world of one] {card} | make_mesh({{'data': "
          f"1}}) on {backend}: phase 11's step (B={B} H={H} T={T} float32, "
          f"odeint rk4 num_steps={FIXED_STEPS} through its loop, SGD lr "
          f"1e-3) through data_parallel_odeint equals the unsharded step bit "
          f"for bit {same}; kernel launches {launches} (the step runs none) "
          f"| {ROUTE_TIMED} steps each, in alternating pairs: median "
          f"{med['sharded']:.2f} ms (min {min(ms['sharded']):.2f}, max "
          f"{max(ms['sharded']):.2f}) against the unsharded step's "
          f"{med['single']:.2f} ms (min {min(ms['single']):.2f}, max "
          f"{max(ms['single']):.2f}), {med['sharded'] / med['single']:.3f}x; "
          f"phase 11's median {fixed_ms:.2f} ms | {a_s:.1f} s")
    print(f"[21c gradient routes, {ROUTE_RANKS} ranks on one card] {card} | "
          f"gloo, spiral float64 B={ROUTE_B}: each route's gradients in y0, "
          f"t and the MLP's parameters (forward_grad: its jvp) vs the "
          f"single solve per rank [max error of max|g|, counters equal, "
          f"seconds of both solves]: "
          + "; ".join(f"{k} " + ", ".join(
              f"[{x[k][0]:.2e}, {x[k][1]}, {x[k][3]:.1f} s]" for x in ranks)
                      for k in ranks[0])
          + f" (<= {ROUTE_F64_REL})")
    print(f"[21c budget] phase 21 (c) took {total:.1f} s (budget "
          f"{ROUTE_BUDGET_S} s)")
    _check(total <= ROUTE_BUDGET_S, f"phase 21 (c) took {total:.1f} s")


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from torchdiffeq_tpu_torch import (odeint, odeint_with_stats,
                                       odeint_per_sample_with_stats,
                                       odeint_event, odeint_dense)
    from torchdiffeq_tpu_torch.models import LinearEvent
    from torchdiffeq_tpu_torch.ops import _build, fused_field, kernels
    from torchdiffeq_tpu_torch.ops.tableaus import DOPRI5

    dev = torch.device("cuda")
    card = _card()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | kernels built and loaded in "
          f"{build_s:.1f} s | ptxas and SASS: "
          f"{_build_report(_build)}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[2 precision] matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn.allow_tf32="
          f"{torch.backends.cudnn.allow_tf32}")
    torch.cuda.synchronize()

    model, y_big = _spiral(torch, torch.float32, dev)
    y0 = y_big[:B].contiguous()
    t = torch.linspace(0.0, 1.0, T, dtype=torch.float64)

    # ---- 3: the main path and the kernel routes, counted -----------------
    kernels.reset_launch_counts()
    with torch.no_grad():
        torch.cuda.synchronize()
        w0 = time.perf_counter()
        ys, st = odeint_with_stats(model, y0, t, method="dopri5", rtol=RTOL,
                                   atol=ATOL)
        torch.cuda.synchronize()
        wall = time.perf_counter() - w0
        t_rk4 = torch.linspace(0.0, 1.0, RK4_T, dtype=torch.float64)
        ys_rk4 = odeint(model, y0, t_rk4, method="rk4",
                        options=dict(pallas=True, num_steps=RK4_STEPS))
        ys_ps, st_ps = odeint_per_sample_with_stats(
            model, y0, t, rtol=RTOL, atol=ATOL, options=dict(pallas=True))
        torch.cuda.synchronize()
    launches = {name: kernels.launch_counts[name]
                for name in ("rk4_integrate", "dopri5_integrate_batched")}
    for name, n in launches.items():
        _check(n > 0, f"kernel {name} was not launched on the main path")
    for name, out, shape in (("dopri5", ys, (T, B, 2)),
                             ("rk4", ys_rk4, (RK4_T, B, 2)),
                             ("per_sample", ys_ps, (B, T, 2))):
        _check(tuple(out.shape) == shape and out.is_cuda
               and bool(torch.isfinite(out).all()),
               f"{name}: {tuple(out.shape)} on {out.device}, finite="
               f"{bool(torch.isfinite(out).all())}")
    _check(st.error_code == 0 and int(st_ps.error_code.max()) == 0,
           "a solve reported an error code")
    print(f"[3 main path] dopri5 B={B} H={H} T={T} float32 on CUDA: "
          f"nfe={st.nfe} steps={st.n_steps} accepted={st.n_accepted} "
          f"first-call wall={wall * 1e3:.1f} ms | rk4 route num_steps={RK4_STEPS} | "
          f"per-sample route steps {int(st_ps.n_steps.min())}.."
          f"{int(st_ps.n_steps.max())} | launches {launches}")

    # ---- 4: main path on CUDA against the CPU ----------------------------
    model_cpu, y_cpu = _spiral(torch, torch.float32, "cpu")
    model64, y_big64 = _spiral(torch, torch.float64, dev)
    model64_cpu, y64_cpu = _spiral(torch, torch.float64, "cpu")
    y064 = y_big64[:B].contiguous()
    with torch.no_grad():
        ys_cpu, st_cpu = odeint_with_stats(model_cpu, y_cpu[:B], t,
                                           method="dopri5", rtol=RTOL,
                                           atol=ATOL)
        err32 = float((ys.cpu() - ys_cpu).abs().max())
        dsteps32 = abs(st.n_steps - st_cpu.n_steps)
        warm = []
        for _ in range(3):   # the main path again, warm: host wall clock
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            odeint_with_stats(model, y0, t, method="dopri5", rtol=RTOL,
                              atol=ATOL)
            torch.cuda.synchronize()
            warm.append(time.perf_counter() - w0)
        _check(err32 <= F32_ADAPTIVE_VALUES
               and dsteps32 <= F32_ADAPTIVE_STEPS,
               f"float32 CUDA vs CPU: max|dy|={err32} steps {st.n_steps} vs "
               f"{st_cpu.n_steps}")
        for _ in range(2):   # the second call is warm
            torch.cuda.synchronize()
            w0 = time.perf_counter()
            ys64, st64 = odeint_with_stats(model64, y064, t, method="dopri5",
                                           rtol=RTOL, atol=ATOL)
            torch.cuda.synchronize()
            wall64 = time.perf_counter() - w0
        ys64_cpu, st64_cpu = odeint_with_stats(
            model64_cpu, y64_cpu[:B], t, method="dopri5", rtol=RTOL,
            atol=ATOL)
        err64 = float((ys64.cpu() - ys64_cpu).abs().max())
        _check(list(st64[:5]) == list(st64_cpu[:5]) and err64 <= F64_VALUES,
               f"float64 CUDA vs CPU: max|dy|={err64} stats {st64} vs "
               f"{st64_cpu}")
    torch.cuda.synchronize()
    print(f"[4 main path vs CPU] float32: max|dy|={err32:.3e} "
          f"(<= {F32_ADAPTIVE_VALUES}), steps {st.n_steps} vs "
          f"{st_cpu.n_steps} (within {F32_ADAPTIVE_STEPS}) | float64: "
          f"max|dy|={err64:.3e} (<= {F64_VALUES}), counters "
          f"{list(st64[:5])} == CPU | main path wall float32 warm "
          f"{sorted(warm)[1] * 1e3:.1f} ms (median of 3), float64 warm "
          f"{wall64 * 1e3:.1f} ms")

    summary = []

    # ---- 5: K-rk4 against its plain version -------------------------------
    dt = 1.0 / RK4_STEPS
    every = RK4_STEPS // (RK4_T - 1)
    with torch.no_grad():
        # the route's kernel output (phase 3) against the plain version
        ref = kernels.rk4_integrate_ref(model, y0, 0.0, dt, RK4_STEPS,
                                        out_every=every)
        err_rk4 = float((ys_rk4 - ref).abs().max())
        _check(err_rk4 <= F32_RK4, f"K-rk4 float32: max|dy|={err_rk4}")
        k64 = kernels.rk4_integrate(model64, y064, 0.0, dt, RK4_STEPS,
                                    out_every=every)
        r64 = kernels.rk4_integrate_ref(model64, y064, 0.0, dt, RK4_STEPS,
                                        out_every=every)
        err_rk4_64 = float((k64 - r64).abs().max())
        _check(err_rk4_64 <= F64_VALUES, f"K-rk4 float64: max|dy|={err_rk4_64}")
        times = {}
        for b in (B, BIG_B):
            yb = y_big[:b].contiguous()
            times[b] = (
                _time_ms(torch, lambda: kernels.rk4_integrate(
                    model, yb, 0.0, dt, RK4_STEPS), 5),
                _time_ms(torch, lambda: kernels.rk4_integrate_ref(
                    model, yb, 0.0, dt, RK4_STEPS), 2))
    torch.cuda.synchronize()
    print(f"[5 K-rk4] float32 max|dy| kernel vs plain={err_rk4:.3e} "
          f"(<= {F32_RK4}), float64={err_rk4_64:.3e} (<= {F64_VALUES}) | "
          + " | ".join(f"B={b}: group width L={kernels._rk4_group_width(b, H)}"
                       f", kernel {k:.3f} ms, plain {p:.3f} ms"
                       for b, (k, p) in times.items())
          + f" | {RK4_STEPS} steps float32")
    summary.append(dict(
        name="rk4_integrate", route="cuda",
        source="torchdiffeq_tpu_torch/csrc/rk4.cu",
        replaces="torchdiffeq_tpu/ops/pallas_kernels.py:56",
        launches=launches["rk4_integrate"], max_abs_err=err_rk4,
        ms=times[B][0], plain_ms=times[B][1],
        # four field evaluations and about 15 operations a state row for
        # the stage sums, per trajectory and step; y0 read, y written.  The
        # build's --fmad=false halves the reachable rate: the floor is
        # twice the bound.
        **dict(zip(("bound_ms", "bound_by"), _rk4_bound(B))),
        bound_ms_65536=_rk4_bound(BIG_B)[0], ms_65536=times[BIG_B][0],
        plain_ms_65536=times[BIG_B][1], library_ms=None))

    # ---- 6: K-dopri5 against its plain version ----------------------------
    ts = np.linspace(0.0, 1.0, T)
    kw = dict(ts=ts.astype(np.float32), rtol=RTOL, atol=ATOL)
    with torch.no_grad():
        # the route's kernel output (phase 3) against the plain version
        ys_r, acc_r, stp_r = kernels.dopri5_integrate_batched_ref(
            model, y0.T.contiguous(), 0.0, 1.0, **kw)
        ys_k, stp_k = ys_ps.permute(1, 2, 0), st_ps.n_steps[None]
        err_l = float((ys_k - ys_r).abs().max())
        dstp = (stp_k - stp_r).abs()
        _check(err_l <= F32_ADAPTIVE_VALUES
               and int(dstp.max()) <= F32_ADAPTIVE_STEPS,
               f"K-dopri5 float32: max|dy|={err_l}, max step diff "
               f"{int(dstp.max())}")
        kw64 = dict(ts=ts, rtol=RTOL, atol=ATOL)
        y64T = y064.T.contiguous()
        ys_k64, acc_k64, stp_k64 = kernels.dopri5_integrate_batched(
            model64, y64T, 0.0, 1.0, **kw64)
        ys_r64, acc_r64, stp_r64 = kernels.dopri5_integrate_batched_ref(
            model64, y64T, 0.0, 1.0, **kw64)
        err_l64 = float((ys_k64 - ys_r64).abs().max())
        _check(torch.equal(stp_k64, stp_r64) and torch.equal(acc_k64, acc_r64)
               and err_l64 <= F64_VALUES,
               f"K-dopri5 float64: max|dy|={err_l64}, step counts equal "
               f"{torch.equal(stp_k64, stp_r64)}")
        ltimes = {}
        for b in (B, BIG_B):
            yb = y_big[:b].T.contiguous()
            ltimes[b] = _three_times(
                torch, lambda: kernels.dopri5_integrate_batched(
                    model, yb, 0.0, 1.0, **kw),
                kernels._lanes_launch(model, yb, 0.0, 1.0, **kw)[0],
                lambda: kernels.dopri5_integrate_batched_ref(
                    model, yb, 0.0, 1.0, **kw),
                kernels._lane_group_width(b, H))
        # the per-lane step counts at the large batch, for its bound
        stp_big = kernels.dopri5_integrate_batched(model, yb, 0.0, 1.0,
                                                   **kw)[2]
        # dopri8: the shared-memory instance, float64 against the plain
        # version, and its device time on that run (B=1024)
        k8 = kernels.dopri5_integrate_batched(model64, y64T, 0.0, 1.0,
                                              method="dopri8", **kw64)
        r8 = kernels.dopri5_integrate_batched_ref(model64, y64T, 0.0, 1.0,
                                                  method="dopri8", **kw64)
        l8 = _dopri8_vs_plain("K-dopri5", k8[:1], r8[:1], k8[1:], r8[1:])
        l8["dopri8_device_ms"] = _device_ms(torch, kernels._lanes_launch(
            model64, y64T, 0.0, 1.0, method="dopri8", **kw64)[0], 20)
        l8["dopri8_steps"] = f"{int(k8[2].min())}..{int(k8[2].max())}"
    torch.cuda.synchronize()
    print(f"[6 K-dopri5] float32 max|dy|={err_l:.3e} (<= "
          f"{F32_ADAPTIVE_VALUES}), lanes with equal steps "
          f"{float((dstp == 0).float().mean()):.4f}, max step diff "
          f"{int(dstp.max())} (<= {F32_ADAPTIVE_STEPS}) | float64 max|dy|="
          f"{err_l64:.3e} (<= {F64_VALUES}), per-lane steps and accepts "
          f"equal | steps {int(stp_k.min())}..{int(stp_k.max())} | "
          + " | ".join(_times_row(b, t) for b, t in ltimes.items())
          + f" | dopri8 (shared-memory instance) float64 vs plain: max|dy|="
          f"{l8['dopri8_max_abs_err']:.3e} (<= {DOPRI8_VALUES}), lanes whose "
          f"counts differ {l8['dopri8_count_flip_share']:.4f} (<= "
          f"{DOPRI8_FLIP_SHARE}), steps {l8['dopri8_steps']}; device time "
          f"float64 B={B} {l8['dopri8_device_ms']:.4f} ms")
    summary.append(dict(
        name="dopri5_integrate_batched", route="cuda",
        source="torchdiffeq_tpu_torch/csrc/dopri5_lanes.cu",
        replaces="torchdiffeq_tpu/ops/pallas_kernels.py:336",
        launches=launches["dopri5_integrate_batched"], max_abs_err=err_l,
        **_times_entry(ltimes), **l8,
        # over this run's per-lane step counts; y0 read, the T output rows
        # and two counters a lane written
        **dict(zip(("bound_ms", "bound_by"), _bound(
            _lane_flops(stp_k, DOPRI5, 2, H, 3),
            (1 + T) * B * 2 * 4 + 2 * B * 4, PEAK_F32))),
        bound_ms_65536=_bound(_lane_flops(stp_big, DOPRI5, 2, H, 3),
                              (1 + T) * BIG_B * 2 * 4 + 2 * BIG_B * 4,
                              PEAK_F32)[0],
        library_ms=None))

    # ---- 7: the event path (odeint_event, odeint_dense) -------------------
    # the batch mean of y[:, 0] at t=0 and at t=4/9 (phase 3's values); a
    # level halfway between is crossed before t=4/9 < EVENT_CUT
    means = ys[:, :, 0].double().mean(dim=1).cpu()
    thr = float((means[0] + means[4]) / 2)

    def batch_event(tt, yy):
        return torch.stack([yy[:, 0].mean() - thr, (tt - EVENT_CUT).to(yy.dtype)])

    ev_kw = dict(event_fn=batch_event, method="dopri5", rtol=RTOL, atol=ATOL)
    runs = {}
    with torch.no_grad():
        for name, m, yb in (("f32", model, y0), ("f32_cpu", model_cpu, y_cpu[:B]),
                            ("f64", model64, y064),
                            ("f64_cpu", model64_cpu, y64_cpu[:B])):
            (et, ys2), st_e = odeint_with_stats(m, yb, torch.tensor([0.0, 1.0]),
                                                **ev_kw)
            w0 = time.perf_counter()
            et_e, sol_e = odeint_event(m, yb, 0.0, **ev_kw)
            torch.cuda.synchronize()
            wall_e = time.perf_counter() - w0
            _check(float(et_e) == float(et) and torch.equal(sol_e, ys2),
                   f"{name}: odeint_event differs from odeint(event_fn=...)")
            dense, st_d = odeint_dense(m, yb, 0.0, 1.0, rtol=RTOL, atol=ATOL,
                                       _return_stats=True)
            runs[name] = (float(et), sol_e, st_e, dense(t), st_d, wall_e)
    et32, sol32, st32e, dv32, st32d, wall_e32 = runs["f32"]
    _check(sol32.is_cuda and sol32.shape == (2, B, 2)
           and bool(torch.isfinite(sol32).all()) and st32e.error_code == 0
           and 0.0 < et32 < EVENT_CUT,
           f"event path float32: event_t={et32}, {st32e}")
    d_et32 = abs(et32 - runs["f32_cpu"][0])
    d_dense32 = float((dv32.cpu() - runs["f32_cpu"][3]).abs().max())
    d_steps32 = max(abs(st32e.n_steps - runs["f32_cpu"][2].n_steps),
                    abs(st32d.n_steps - runs["f32_cpu"][4].n_steps))
    _check(d_et32 <= F32_EVENT_T and d_dense32 <= F32_ADAPTIVE_VALUES
           and d_steps32 <= F32_ADAPTIVE_STEPS,
           f"event path float32 CUDA vs CPU: |d event_t|={d_et32}, dense "
           f"max|dy|={d_dense32}, step diff {d_steps32}")
    et64, _, st64e, dv64, st64d, _ = runs["f64"]
    d_et64 = abs(et64 - runs["f64_cpu"][0])
    d_dense64 = float((dv64.cpu() - runs["f64_cpu"][3]).abs().max())
    _check(list(st64e[:5]) == list(runs["f64_cpu"][2][:5])
           and list(st64d[:5]) == list(runs["f64_cpu"][4][:5])
           and d_et64 <= F64_VALUES and d_dense64 <= F64_VALUES,
           f"event path float64 CUDA vs CPU: |d event_t|={d_et64}, dense "
           f"max|dy|={d_dense64}, counters {st64e} / {st64d}")
    d_vs_odeint = float((dv32 - ys).abs().max())
    _check(d_vs_odeint <= F32_DENSE_VS_ODEINT,
           f"dense vs odeint at the output times: max|dy|={d_vs_odeint}")
    print(f"[7 events path] odeint_event B={B} float32 on CUDA: event_t="
          f"{et32:.9f} (level {thr:.6f} on the batch mean, cut-off "
          f"{EVENT_CUT}), steps={st32e.n_steps} nfe={st32e.nfe}, wall "
          f"{wall_e32 * 1e3:.1f} ms | vs CPU: float32 |d event_t|={d_et32:.3e} "
          f"(<= {F32_EVENT_T}), float64 |d event_t|={d_et64:.3e} (<= "
          f"{F64_VALUES}), counters equal | odeint_dense [0, 1]: "
          f"steps={st32d.n_steps} nfe={st32d.nfe}, vs CPU max|dy| float32 "
          f"{d_dense32:.3e} (<= {F32_ADAPTIVE_VALUES}), float64 "
          f"{d_dense64:.3e} (<= {F64_VALUES}), counters equal; vs odeint at "
          f"T={T}: max|dy|={d_vs_odeint:.3e} (<= {F32_DENSE_VS_ODEINT})")

    # ---- 8: K-events through the per-sample event route ------------------
    def lane_event(dtype, y_lanes):
        """A threshold on y[0] at its median (about half the lanes lie on
        each side; those that reach it fire there) and a cut-off at t=1,
        which ends every other lane."""
        thr_l = float(y_lanes[:, 0].double().median())
        return LinearEvent([[1.0, 0.0], [0.0, 0.0]], time_coef=[0.0, 1.0],
                           bias=[-thr_l, -1.0], dtype=dtype,
                           device=dev).requires_grad_(False)

    t_ev = torch.tensor([0.0, 1.0], dtype=torch.float64)
    opts = dict(pallas=True, max_num_steps=EVENT_MAX_STEPS)
    event32 = lane_event(torch.float32, y0)
    with torch.no_grad():
        kernels.reset_launch_counts()
        (et_ps, ys2_ps), st_ev = odeint_per_sample_with_stats(
            model, y0, t_ev, event_fn=event32, rtol=RTOL, atol=ATOL,
            options=opts)
        torch.cuda.synchronize()
        ev_launches = kernels.launch_counts["dopri5_events_batched"]
        _check(ev_launches > 0, "kernel dopri5_events_batched was not "
               "launched on the per-sample event route")
        _check(tuple(ys2_ps.shape) == (B, 2, 2) and ys2_ps.is_cuda
               and bool(torch.isfinite(ys2_ps).all())
               and bool(torch.isfinite(et_ps).all())
               and int(st_ev.error_code.max()) == 0,
               "per-sample event route: a lane did not fire or is not finite")
        at_cut = (et_ps - 1.0).abs() <= 1e-6
        # the route's kernel output against the plain version
        sign0 = torch.sign(event32(torch.zeros((), dtype=torch.float32,
                                               device=dev), y0)).T.contiguous()
        ekw = dict(rtol=RTOL, atol=ATOL, max_steps=EVENT_MAX_STEPS,
                   ev_params=(sign0,))
        ref32 = kernels.dopri5_events_batched_ref(model, y0.T.contiguous(),
                                                  0.0, event32, **ekw)
        err_ev32 = float((et_ps - ref32[0][0]).abs().max())
        d_ev_steps = (st_ev.n_steps - ref32[4][0]).abs()
        _check(torch.equal(ref32[2][0], torch.ones_like(ref32[2][0]))
               and err_ev32 <= F32_EVENT_T
               and int(d_ev_steps.max()) <= F32_ADAPTIVE_STEPS,
               f"K-events float32: max|d event_t|={err_ev32}, max step diff "
               f"{int(d_ev_steps.max())}")
        y64T = y064.T.contiguous()
        event64 = lane_event(torch.float64, y064)
        sign64 = torch.sign(event64(torch.zeros((), dtype=torch.float64,
                                                device=dev), y064)).T.contiguous()
        ekw64 = dict(ekw, ev_params=(sign64,))
        k64 = kernels.dopri5_events_batched(model64, y64T, 0.0, event64, **ekw64)
        r64 = kernels.dopri5_events_batched_ref(model64, y64T, 0.0, event64,
                                                **ekw64)
        err_ev64 = float((k64[0] - r64[0]).abs().max())
        err_ye64 = float((k64[1] - r64[1]).abs().max())
        _check(all(torch.equal(a, b) for a, b in zip(k64[2:], r64[2:]))
               and bool(r64[2].all()) and err_ev64 <= F64_VALUES
               and err_ye64 <= F64_VALUES,
               f"K-events float64: max|d event_t|={err_ev64}, max|d y|="
               f"{err_ye64}, found/acc/steps equal "
               f"{[torch.equal(a, b) for a, b in zip(k64[2:], r64[2:])]}")
        etimes = {}
        for b in (B, BIG_B):
            yb = y_big[:b].T.contiguous()
            eb = lane_event(torch.float32, y_big[:b])
            sb = torch.sign(eb(torch.zeros((), dtype=torch.float32, device=dev),
                               y_big[:b])).T.contiguous()
            kwb = dict(ekw, ev_params=(sb,))
            etimes[b] = _three_times(
                torch, lambda: kernels.dopri5_events_batched(
                    model, yb, 0.0, eb, **kwb),
                kernels._events_launch(model, yb, 0.0, eb, **kwb)[0],
                lambda: kernels.dopri5_events_batched_ref(
                    model, yb, 0.0, eb, **kwb),
                kernels._lane_group_width(b, H))
        # the per-lane step counts at the large batch, for its bound
        ev_stp_big = kernels.dopri5_events_batched(model, yb, 0.0, eb,
                                                   **kwb)[4]
        # dopri8, as in phase 6
        k8 = kernels.dopri5_events_batched(model64, y64T, 0.0, event64,
                                           method="dopri8", **ekw64)
        r8 = kernels.dopri5_events_batched_ref(model64, y64T, 0.0, event64,
                                               method="dopri8", **ekw64)
        e8 = _dopri8_vs_plain("K-events", k8[:2], r8[:2], k8[2:], r8[2:])
        e8["dopri8_device_ms"] = _device_ms(torch, kernels._events_launch(
            model64, y64T, 0.0, event64, method="dopri8", **ekw64)[0], 20)
        e8["dopri8_steps"] = f"{int(k8[4].min())}..{int(k8[4].max())}"
    torch.cuda.synchronize()
    print(f"[8 K-events] per-sample event route B={B} float32: lanes fired "
          f"on the y[0] threshold {float((~at_cut).float().mean()):.4f}, on "
          f"the t=1 cut-off {float(at_cut.float().mean()):.4f}; steps "
          f"{int(st_ev.n_steps.min())}..{int(st_ev.n_steps.max())}; launches "
          f"{ev_launches} | kernel vs plain: float32 max|d event_t|="
          f"{err_ev32:.3e} (<= {F32_EVENT_T}), lanes with equal steps "
          f"{float((d_ev_steps == 0).float().mean()):.4f}, max step diff "
          f"{int(d_ev_steps.max())} (<= {F32_ADAPTIVE_STEPS}) | float64 "
          f"max|d event_t|={err_ev64:.3e}, max|d y_event|={err_ye64:.3e} (<= "
          f"{F64_VALUES}), per-lane found, steps and accepts equal | "
          + " | ".join(_times_row(b, t) for b, t in etimes.items())
          + f" | dopri8 (shared-memory instance) float64 vs plain: max|d|="
          f"{e8['dopri8_max_abs_err']:.3e} (<= {DOPRI8_VALUES}), lanes whose "
          f"counts differ {e8['dopri8_count_flip_share']:.4f} (<= "
          f"{DOPRI8_FLIP_SHARE}), steps {e8['dopri8_steps']}; device time "
          f"float64 B={B} {e8['dopri8_device_ms']:.4f} ms")
    summary.append(dict(
        name="dopri5_events_batched", route="cuda",
        source="torchdiffeq_tpu_torch/csrc/dopri5_events.cu",
        replaces="torchdiffeq_tpu/ops/pallas_kernels.py:580",
        launches=ev_launches, max_abs_err=err_ev32, **_times_entry(etimes),
        **e8,
        # over this run's per-lane step counts (`_events_bound`)
        **dict(zip(("bound_ms", "bound_by"), _events_bound(st_ev.n_steps, B))),
        bound_ms_65536=_events_bound(ev_stp_big, BIG_B)[0],
        library_ms=None))

    order2 = _order2_vs_plain(torch, kernels, dev)
    for e in summary:
        if e["name"] in order2:
            e["order2_bitwise"] = order2[e["name"]]

    summary.append(_phase_fused(torch, fused_field, kernels, DOPRI5, dev))

    train_ms = _phase_train(torch, kernels, dev)

    fixed_ms = _phase_fixed(torch, kernels, dev)

    walls_12c = _phase_implicit(torch, kernels, dev)

    _phase_conv(torch, kernels, dev)

    driver_ms = _phase_per_sample(torch, kernels, dev)

    summary.extend(_phase_per_sample_stiff(torch, kernels, dev, walls_12c))

    summary.extend(_phase_examples(torch, kernels, dev, driver_ms))

    summary.extend(_phase_dtypes(torch, kernels, dev))

    _phase_parareal(torch, kernels, dev, train_ms)

    _phase_mesh(torch, kernels, dev, summary)

    _phase_sharded_step(torch, kernels, dev, train_ms)

    _phase_grad_routes(torch, kernels, dev, fixed_ms)

    torch.cuda.synchronize()
    print(_card())
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        a = sys.argv[2:]
        sys.exit(_mesh_rank(int(a[0]), int(a[1]), a[2], a[3]))
    if sys.argv[1:2] == ["--step-rank"]:
        a = sys.argv[2:]
        sys.exit(_step_rank(int(a[0]), int(a[1]), a[2], a[3]))
    if sys.argv[1:2] == ["--grad-rank"]:
        a = sys.argv[2:]
        sys.exit(_grad_rank(int(a[0]), int(a[1]), a[2], a[3]))
    if sys.argv[1:2] == ["--mesh-cards"]:
        sys.exit(_mesh_cards())
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke test of the PyTorch / CUDA port on one NVIDIA GPU.

Drives the port's main path at the spiral neural-ODE's full width (an MLP
field 2 -> 64 -> 2 on y**3, B=1024 trajectories, T=10 output times on
[0, 1], rtol=1e-7, atol=1e-9; weights from a numpy seed) through the
public entry points, and the two CUDA kernels through the routes that run
them:

  1. the card, the torch/CUDA versions, and the kernels' build;
  2. TF32 off for matmuls and convolutions (full float32);
  3. the main path and the kernel routes, once, with the kernels' launch
     counts reset before and read after: `odeint_with_stats` (dopri5),
     `odeint(method='rk4', options=dict(pallas=True, num_steps=1000))` and
     `odeint_per_sample_with_stats(options=dict(pallas=True))`;
  4. the main path on CUDA against the same call on the CPU, float32 and
     float64;
  5. K-rk4 against its plain PyTorch version on the same CUDA tensors, and
     both timed at B=1024 and B=65536;
  6. K-dopri5 likewise, with per-lane step counts;
  7. one JSON line per kernel summary, the card's name and power limit,
     then the result line.

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


def _ptxas_summary(log):
    """Registers per thread of the path's kernels (D=2) and the kernels
    that spill, from the `-Xptxas -v` lines of the kernels' build."""
    regs, spills, name = {}, [], None
    for line in log.splitlines():
        m = re.search(r"(?:entry function|Function properties for) '?(\w+)",
                      line)
        if m:
            k = re.search(r"(rk4|lanes)_kernelI([fd])Li(\d+)E", m.group(1))
            name = k and f"{k.group(1)}<{k.group(2)},D={k.group(3)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name and m.group(1) != "0":
            spills.append(name)
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            regs[name] = int(m.group(1))
    path = {k: v for k, v in regs.items() if k.endswith("D=2>")}
    return (f"registers {path}; {len(set(spills))} of {len(regs)} kernels "
            f"spill: {sorted(set(spills))}")


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


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def main():
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    from torchdiffeq_tpu_torch import (odeint, odeint_with_stats,
                                       odeint_per_sample_with_stats)
    from torchdiffeq_tpu_torch.ops import _build, kernels

    dev = torch.device("cuda")
    card = _card()
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"[1 device] {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()} | kernels built and loaded in "
          f"{build_s:.1f} s | ptxas: {_ptxas_summary(_build.build_info['log'])}")

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
    launches = dict(kernels.launch_counts)
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
          + " | ".join(f"B={b}: kernel {k:.3f} ms, plain {p:.3f} ms"
                       for b, (k, p) in times.items())
          + f" | {RK4_STEPS} steps float32")
    summary.append(dict(
        name="rk4_integrate", route="cuda",
        source="torchdiffeq_tpu_torch/csrc/rk4.cu",
        replaces="torchdiffeq_tpu/ops/pallas_kernels.py:56",
        launches=launches["rk4_integrate"], max_abs_err=err_rk4,
        ms=times[B][0], plain_ms=times[B][1]))

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
            ltimes[b] = (
                _time_ms(torch, lambda: kernels.dopri5_integrate_batched(
                    model, yb, 0.0, 1.0, **kw), 5),
                _time_ms(torch, lambda: kernels.dopri5_integrate_batched_ref(
                    model, yb, 0.0, 1.0, **kw), 2))
    torch.cuda.synchronize()
    print(f"[6 K-dopri5] float32 max|dy|={err_l:.3e} (<= "
          f"{F32_ADAPTIVE_VALUES}), lanes with equal steps "
          f"{float((dstp == 0).float().mean()):.4f}, max step diff "
          f"{int(dstp.max())} (<= {F32_ADAPTIVE_STEPS}) | float64 max|dy|="
          f"{err_l64:.3e} (<= {F64_VALUES}), per-lane steps and accepts "
          f"equal | steps {int(stp_k.min())}..{int(stp_k.max())} | "
          + " | ".join(f"B={b}: kernel {k:.3f} ms, plain {p:.3f} ms"
                       for b, (k, p) in ltimes.items()))
    summary.append(dict(
        name="dopri5_integrate_batched", route="cuda",
        source="torchdiffeq_tpu_torch/csrc/dopri5_lanes.cu",
        replaces="torchdiffeq_tpu/ops/pallas_kernels.py:336",
        launches=launches["dopri5_integrate_batched"], max_abs_err=err_l,
        ms=ltimes[B][0], plain_ms=ltimes[B][1]))

    torch.cuda.synchronize()
    print(_card())
    print(json.dumps({"kernels": summary}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

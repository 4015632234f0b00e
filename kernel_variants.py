#!/usr/bin/env python3
"""Where K-fused's, K-rk4's, K-dopri5's and K-events' time goes, on one
NVIDIA GPU.

Builds variants of ``torchdiffeq_tpu_torch/csrc/fused_step.cu`` (each a
text substitution of the source, compiled alone with the port's nvcc flags
into ``build/variants/``) and times each at ``chip_smoke.py``'s phase-9
shape (B=4096, D=256, H=1024, one dopri5 step at dt=1e-4, float32 and
bfloat16) by CUDA events around its bare launch, holding its outputs to
``ops/fused_field.kernel_bounds`` against the plain version:

  kernel     the source as it is;
  no_copies  the weight tiles never copied (the products read stale slots;
             what is left is the products, the stage sums and the barriers);
  no_mma     the two products left out (what is left is the weight stream,
             the stage sums and the barriers);
  cluster1, cluster4  bfloat16's weight tiles shared by clusters of 1 or 4
             blocks instead of 2 (float32 runs no cluster: the same kernel);
  ring3, ring6  the ring of weight tiles with 3 or 6 slots instead of 4
             (6 does not fit beside float32's operands: refused).

Then K-rk4 (``csrc/rk4.cu``, 1000 steps of the spiral field, D=2, H=64,
float32) at each group width L at B=1024, 16384, 32768 and 65536, by its C
entry point with L given.  A variant's outputs other than `kernel`'s are
printed with their share of the bound and are not checked.

Then K-dopri5 and K-events (``csrc/dopri5_lanes.cu``,
``csrc/dopri5_events.cu``) at each group width L from 1 to 32 at the same
batches, on ``chip_smoke.py``'s phase-6 and phase-8 problems (the spiral
field in float32, rtol=1e-7, atol=1e-9; ten output times on [0, 1], and a
threshold on y[0] at its median with a cut-off at t=1), each by its C entry
point with L given, its device time alone (``chip_smoke._device_ms``).

Then (`wrapped`) the same two kernels through their public wrappers at
B=1024 and 65536, at the width the host picks: the time of a call, and its
device time alone (the wrapper's calls queued behind a sleep; it launches
nothing else on the device).  It uses only what every version of the port
has, so ``--tree DIR`` times the package of another checkout in DIR (a
`git archive` of an earlier commit, say) with this script's method, for a
comparison of two versions on one card.

    python3 kernel_variants.py [fused] [rk4] [lanes] [wrapped] [--tree DIR]
    (default: all four sections)
"""
import ctypes
import importlib
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "variants"
VARIANTS = {
    "kernel": [],
    "no_copies": [("      if (g < n_tiles)\n        load_tile",
                   "      if (false)\n        load_tile"),
                  ("          if (g + kAhead < n_tiles)\n            load_tile",
                   "          if (false)\n            load_tile"),
                  ("        for (int g = 0; g < n_tiles; ++g)\n          issue_tile",
                   "        for (int g = 0; g < 0; ++g)\n          issue_tile"),
                  ("          mbar_wait(&full[g % P::kStages], (g / P::kStages) & 1);", "")],
    "no_mma": [("first_product<T, D>(acc, slot, s_y, t);", ";"),
               ("second_product<T, D>(acc, slot, s_h, t - P::kTiles1);", ";")],
    "cluster1": [("constexpr int kCluster = 2;", "constexpr int kCluster = 1;")],
    "cluster4": [("constexpr int kCluster = 2;", "constexpr int kCluster = 4;")],
    "ring3": [("static constexpr int kStages = 4;",
               "static constexpr int kStages = 3;")],
    "ring6": [("static constexpr int kStages = 4;",
               "static constexpr int kStages = 6;")],
}
RK4_WIDTHS = {1024: (1, 4, 8, 16, 32), 16384: (1, 2, 4, 8),
              32768: (1, 2, 4), 65536: (1, 2)}
LANE_BATCHES = (1024, 16384, 32768, 65536)
LANE_WIDTHS = (1, 2, 4, 8, 16, 32)
SECTIONS = ("fused", "rk4", "lanes", "wrapped")


def _build_variants(_build_mod):
    """Compile every variant in parallel; return {name: ctypes library}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = (_build_mod.CSRC / "fused_step.cu").read_text()
    texts = {}
    for name, subs in VARIANTS.items():
        text = src
        for old, new in subs:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: {old!r} not found once")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        cu, so = OUT / f"{name}.cu", OUT / f"{name}.so"
        cu.write_text(text)
        procs[name] = (subprocess.Popen(
            [_build_mod._nvcc(), *_build_mod.NVCC_FLAGS, "-shared", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on variant {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(str(so))
        lib.tdt_fused_step.argtypes = _build_mod._SIGNATURES["tdt_fused_step"]
        lib.tdt_fused_step.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _fused(torch, dev, _build, fused_field, tableaus, ptr, stream):
    """K-fused's variants at the bench's shape, both dtypes."""
    from chip_smoke import _time_ms
    t0 = time.perf_counter()
    libs = _build_variants(_build)
    print(f"{len(libs)} variants built in {time.perf_counter() - t0:.1f} s",
          flush=True)
    rng = np.random.RandomState(1)
    B, D, H = 4096, 256, 1024
    w1 = (rng.randn(D, H) * 0.05).astype(np.float32)
    w2 = (rng.randn(H, D) * 0.05).astype(np.float32)
    y0_np = rng.randn(B, D).astype(np.float32)
    tab, dt32 = tableaus.DOPRI5, np.float32(1e-4)
    coefs, masks = fused_field._packed_coefs(tab, dt32)
    for dtype in (torch.float32, torch.bfloat16):
        params = tuple(torch.from_numpy(a).to(dev).to(dtype) for a in
                       (w1, np.zeros(H, np.float32), w2,
                        np.zeros(D, np.float32)))
        y0 = torch.from_numpy(y0_np).to(dev).to(dtype)
        f0 = fused_field.mlp_field(0.0, y0, *params)
        want = fused_field.fused_stage_step_ref(fused_field.mlp_field, params,
                                                y0, f0, 0.0, dt32, tab)
        bounds = fused_field.kernel_bounds(want, params[2], dt32, tab)
        for name, lib in libs.items():
            outs = [torch.empty_like(y0), torch.empty_like(y0),
                    torch.empty((B, D), device=dev),
                    torch.empty((B, D), device=dev)]
            scratch = torch.empty((len(tab.alpha), B, D), device=dev)

            def launch():
                return lib.tdt_fused_step(
                    0 if dtype == torch.float32 else 1, B, D, H, ptr(y0),
                    ptr(f0), *map(ptr, params),
                    coefs.ctypes.data_as(ctypes.c_void_p),
                    masks.ctypes.data_as(ctypes.c_void_p), len(tab.alpha),
                    int(tab.is_fsal), ptr(scratch), *map(ptr, outs), stream())

            code = launch()
            if code:
                print(f"K-fused {str(dtype)[6:]:8s} {name:9s} refused "
                      f"(CUDA error {code})", flush=True)
                continue
            ms = _time_ms(torch, launch, 30)
            worst = max(float(((g.float() - w.float()).abs() / b).max())
                        for g, w, b in zip(outs, want, bounds))
            if name == "kernel" and not worst <= 1.0:
                raise AssertionError(f"K-fused {dtype}: {worst} of the bound")
            print(f"K-fused {str(dtype)[6:]:8s} {name:9s} {ms:.3f} ms "
                  f"(worst {worst:.3g} of the bound)", flush=True)


def _rk4(torch, dev, _build, ptr, stream):
    """K-rk4 at each group width."""
    from chip_smoke import _time_ms
    lib = _build.library()
    rng = np.random.RandomState(0)
    ws = [torch.from_numpy(a.astype(np.float32)).to(dev) for a in
          (rng.randn(2, 64) * 0.1, np.zeros(64), rng.randn(64, 2) * 0.1,
           np.zeros(2))]
    y_big = torch.from_numpy(rng.randn(65536, 2).astype(np.float32)).to(dev)
    for b, widths in RK4_WIDTHS.items():
        yb = y_big[:b].contiguous()
        out = torch.empty_like(yb)
        row = []
        for L in widths:
            def launch():
                code = lib.tdt_rk4(0, b, 2, 64, 3, ptr(yb), *map(ptr, ws),
                                   1e-3, 1000, 0, L, ptr(out), stream())
                assert code == 0, code
            row.append(f"L={L} {_time_ms(torch, launch, 3):.3f} ms")
        print(f"K-rk4 B={b}: " + ", ".join(row), flush=True)


def _lane_problems(torch, dev, cs, y_big, b):
    """chip_smoke.py's phase-6 and phase-8 problems on the first b
    trajectories: the states (2, b), K-dopri5's keywords, the event and
    K-events' keywords."""
    from torchdiffeq_tpu_torch.models import LinearEvent
    yb = y_big[:b].T.contiguous()
    event = LinearEvent([[1.0, 0.0], [0.0, 0.0]], time_coef=[0.0, 1.0],
                        bias=[-float(yb[0].double().median()), -1.0],
                        dtype=torch.float32, device=dev).requires_grad_(False)
    sign0 = torch.sign(event.lanes(torch.zeros_like(yb[:1]), yb)).contiguous()
    kw = dict(ts=np.linspace(0.0, 1.0, cs.T).astype(np.float32),
              rtol=cs.RTOL, atol=cs.ATOL)
    ekw = dict(rtol=cs.RTOL, atol=cs.ATOL, max_steps=cs.EVENT_MAX_STEPS,
               ev_params=(sign0,))
    return yb, kw, event, ekw


def _lanes(torch, dev):
    """K-dopri5 and K-events at each group width: device time alone."""
    import chip_smoke as cs
    from torchdiffeq_tpu_torch.ops import kernels
    model, y_big = cs._spiral(torch, torch.float32, dev)
    with torch.no_grad():
        for b in LANE_BATCHES:
            yb, kw, event, ekw = _lane_problems(torch, dev, cs, y_big, b)
            for name, make in (
                    ("K-dopri5", lambda L: kernels._lanes_launch(
                        model, yb, 0.0, 1.0, group=L, **kw)[0]),
                    ("K-events", lambda L: kernels._events_launch(
                        model, yb, 0.0, event, group=L, **ekw)[0])):
                row = [f"L={L} {cs._device_ms(torch, make(L), 10):.4f} ms"
                       for L in LANE_WIDTHS]
                print(f"{name} B={b} device time: " + ", ".join(row)
                      + f" (the host picks L="
                      f"{kernels._lane_group_width(b, cs.H)})", flush=True)


def _wrapped(torch, dev, tree):
    """K-dopri5 and K-events through their public wrappers, as phases 6 and
    8 of chip_smoke.py call them: per call, and on the device alone."""
    import chip_smoke as cs
    from torchdiffeq_tpu_torch.ops import kernels
    model, y_big = cs._spiral(torch, torch.float32, dev)
    rows = []
    with torch.no_grad():
        for b in (cs.B, cs.BIG_B):
            yb, kw, event, ekw = _lane_problems(torch, dev, cs, y_big, b)
            for name, call in (
                    ("K-dopri5", lambda: kernels.dopri5_integrate_batched(
                        model, yb, 0.0, 1.0, **kw)),
                    ("K-events", lambda: kernels.dopri5_events_batched(
                        model, yb, 0.0, event, **ekw))):
                rows.append(f"{name} B={b}: call "
                            f"{cs._time_ms(torch, call, 20):.4f} ms, device "
                            f"{cs._device_ms(torch, call, 20):.4f} ms")
    print(f"wrapped ({tree}): " + " | ".join(rows), flush=True)


def main():
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    tree = ROOT
    if "--tree" in args:
        i = args.index("--tree")
        tree = Path(args[i + 1]).resolve()
        del args[i:i + 2]
    sections = args or SECTIONS
    if not set(sections) <= set(SECTIONS) or (tree != ROOT
                                              and sections != ["wrapped"]):
        print(f"kernel_variants: sections are {SECTIONS}; --tree takes "
              "`wrapped` alone", file=sys.stderr)
        return 2
    # this checkout's timing helpers, loaded before DIR goes on the path
    importlib.import_module("chip_smoke")
    sys.path.insert(0, str(tree))
    from torchdiffeq_tpu_torch.ops import _build, fused_field, tableaus
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    if "fused" in sections:
        _fused(torch, dev, _build, fused_field, tableaus, ptr, stream)
    if "rk4" in sections:
        _rk4(torch, dev, _build, ptr, stream)
    if "lanes" in sections:
        _lanes(torch, dev)
    if "wrapped" in sections:
        _wrapped(torch, dev, tree)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where K-fused's and K-rk4's time goes, on one NVIDIA GPU.

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

    python3 kernel_variants.py
"""
import ctypes
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


def _time_ms(torch, fn, reps):
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


def main():
    import torch
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from torchdiffeq_tpu_torch.ops import _build, fused_field, tableaus
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    t0 = time.perf_counter()
    libs = _build_variants(_build)
    print(f"{card} | {len(libs)} variants built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    stream = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

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
    return 0


if __name__ == "__main__":
    sys.exit(main())

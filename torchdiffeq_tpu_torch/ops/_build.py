"""Build and load the port's CUDA kernels (``torchdiffeq_tpu_torch/csrc``).

The kernels have a plain C interface: ``nvcc`` compiles each
``csrc/*.cu`` to an object file, all of them at once in parallel
processes, and links the objects into one shared library, which `ctypes`
loads.  The build happens at first use, into ``build/torch_kernels/`` at
the repository root, keyed by a hash of the sources and flags, so a second
process reuses it.  The build's output (ptxas register and spill counts)
is kept in a ``.log`` file beside the library and read back with it.
``nvcc`` comes from ``$CUDA_HOME/bin`` or the ``PATH``.  Nothing is
compiled on import.

A traced instance of the per-lane kernels (``ops/traced.py``) is a
translation unit of its own, emitted at run time: `traced_library` builds
it alone, into ``build/torch_kernels/traced/``, keyed by the hash of its
source.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "--fmad=false", "-std=c++17", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # tdt_rk4(dtype, B, D, H, power, y0, w1, b1, w2, b2, dt, n_steps,
    #         out_every, group, out, stream)
    "tdt_rk4": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _D, _I, _I, _I, _P,
                _P],
    # tdt_dopri5_lanes(dtype, B, D, H, power, y0, ts, S, t0, t1, rtol, atol,
    #   safety, ifactor, dfactor, first_step, use_first_step, max_steps,
    #   tab, n_alpha, order, fsal, w1, b1, w2, b2, group, threads, ys, n_acc,
    #   n_steps, stream)
    "tdt_dopri5_lanes": [_I, _I, _I, _I, _I, _P, _P, _I, _D, _D, _D, _D, _D,
                         _D, _D, _D, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P,
                         _I, _I, _P, _P, _P, _P],
    # tdt_dopri5_events(dtype, B, D, H, power, y0, t0, rtol, atol, safety,
    #   ifactor, dfactor, first_step, use_first_step, max_steps, tab,
    #   n_alpha, order, fsal, w1, b1, w2, b2, K, ev_w, ev_c, ev_b, sign0,
    #   bisect_iters, group, threads, event_t, y_event, found, n_acc,
    #   n_steps, stream)
    "tdt_dopri5_events": [_I, _I, _I, _I, _I, _P, _D, _D, _D, _D, _D, _D,
                          _D, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P, _I,
                          _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _P,
                          _P],
    # tdt_max_shared_bytes(out[1])
    "tdt_max_shared_bytes": [_P],
    # tdt_fused_step(dtype, B, D, H, y0, f0, w1, b1, w2, b2, coefs, masks,
    #   n_alpha, fsal, kbuf, y1, f1, err, dmid, stream)
    "tdt_fused_step": [_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                       _I, _P, _P, _P, _P, _P, _P],
    # tdt_fused_plan(dtype, D, out[6])
    "tdt_fused_plan": [_I, _I, _P],
}

# what the build printed (ptxas register and spill counts), read back from
# the log beside a cached library, and how long this process's build took
build_info = {"seconds": None, "log": "", "path": None}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the port's "
            "CUDA kernels are built from torchdiffeq_tpu_torch/csrc at first "
            "use on a machine with the CUDA toolkit")
    return found


def _build(cu, so_path):
    """Compile every source in parallel, link, and move the library into
    place atomically (a concurrent build of the same hash is harmless).
    Returns the compilers' output."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in cu]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                                   str(src)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(cu, objs)]
        outs = [p.communicate()[0] for p in procs]
        log = "".join(outs)
        for src, p, out in zip(cu, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                                   f"{src.name}:\n{out[-4000:]}")
        lib = Path(tmp) / "lib.so"
        proc = subprocess.run([nvcc, "-shared", "-o", str(lib),
                               *map(str, objs)], capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{(proc.stdout + proc.stderr)[-4000:]}")
        log_tmp = Path(tmp) / "build.log"
        log_tmp.write_text(log)
        os.replace(log_tmp, so_path.with_suffix(".log"))
        os.replace(lib, so_path)
    return log


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first if its hash is new."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so_path = BUILD_DIR / f"libtdt_kernels_{digest.hexdigest()[:16]}.so"
    if so_path.exists():
        log_path = so_path.with_suffix(".log")
        build_info["log"] = log_path.read_text() if log_path.exists() else ""
    else:
        start = time.perf_counter()
        build_info["log"] = _build(cu, so_path)
        build_info["seconds"] = time.perf_counter() - start
    build_info["path"] = str(so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.tdt_error_string.argtypes = [ctypes.c_int]
    lib.tdt_error_string.restype = ctypes.c_char_p
    return lib


# the traced instances' C entry points (ops/traced.py emits them)
_TRACED_SIGNATURES = {
    # tdt_traced_lanes(B, y0, ts, S, t0, t1, rtol, atol, safety, ifactor,
    #   dfactor, first_step, use_first_step, max_steps, lane, shared,
    #   threads, ys, n_acc, n_steps, stream); the tableau is compiled in
    "tdt_traced_lanes": [_I, _P, _P, _I, _D, _D, _D, _D, _D, _D, _D, _D, _I,
                         _I, _P, _P, _I, _P, _P, _P, _P],
    # tdt_traced_events(B, y0, t0, rtol, atol, safety, ifactor, dfactor,
    #   first_step, use_first_step, max_steps, lane, shared, sign0,
    #   ev_shared, bisect_iters, threads, event_t, y_event, found, n_acc,
    #   n_steps, stream)
    "tdt_traced_events": [_I, _P, _D, _D, _D, _D, _D, _D, _D, _I, _I, _P, _P,
                          _P, _P, _I, _I, _P, _P, _P, _P, _P, _P],
}

# the first-use build of each traced instance this process built: its
# source's hash -> seconds (a cached library adds nothing)
traced_builds = {}


@functools.lru_cache(maxsize=None)
def traced_library(source):
    """The library of one traced instance (`source`, a translation unit that
    ops/traced.py emitted, which includes ``csrc/traced_field.cuh``), built
    at first use into ``build/torch_kernels/traced/`` and keyed by the hash
    of the source, the headers and the flags.  Its one entry point,
    ``tdt_traced_lanes`` or ``tdt_traced_events``, is typed on return."""
    _, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    digest.update(source.encode())
    for path in cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    key = digest.hexdigest()[:16]
    out_dir = BUILD_DIR / "traced"
    so_path = out_dir / f"libtdt_traced_{key}.so"
    if not so_path.exists():
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        start = time.perf_counter()
        with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
            src = Path(tmp) / f"traced_{key}.cu"
            src.write_text(source)
            lib = Path(tmp) / "lib.so"
            proc = subprocess.run(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-shared", "-o",
                 str(lib), str(src)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on a traced instance:\n"
                    f"{(proc.stdout + proc.stderr)[-4000:]}")
            (Path(tmp) / "build.log").write_text(proc.stdout + proc.stderr)
            os.replace(Path(tmp) / "build.log", so_path.with_suffix(".log"))
            os.replace(src, so_path.with_suffix(".cu"))
            os.replace(lib, so_path)
        traced_builds[key] = time.perf_counter() - start
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _TRACED_SIGNATURES.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.tdt_error_string.argtypes = [ctypes.c_int]
    lib.tdt_error_string.restype = ctypes.c_char_p
    return lib


def check(lib, code, kernel):
    """Raise if a launcher returned a CUDA error."""
    if code != 0:
        msg = lib.tdt_error_string(code).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {code} ({msg})")

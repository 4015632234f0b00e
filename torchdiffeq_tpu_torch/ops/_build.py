"""Build and load the port's CUDA kernels (``torchdiffeq_tpu_torch/csrc``).

The kernels have a plain C interface: ``nvcc`` compiles every ``csrc/*.cu``
into one shared library, which `ctypes` loads.  The build happens at first
use, into ``build/torch_kernels/`` at the repository root, keyed by a hash
of the sources and flags, so a second process reuses it.  ``nvcc`` comes
from ``$CUDA_HOME/bin`` or the ``PATH``.  Nothing is compiled on import.
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
              "--fmad=false", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
_SIGNATURES = {
    # tdt_rk4(dtype, B, D, H, power, y0, w1, b1, w2, b2, dt, n_steps,
    #         out_every, out, stream)
    "tdt_rk4": [_I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _D, _I, _I, _P, _P],
    # tdt_dopri5_lanes(dtype, B, D, H, power, y0, ts, S, t0, t1, rtol, atol,
    #   safety, ifactor, dfactor, first_step, use_first_step, max_steps,
    #   tab, n_alpha, order, fsal, w1, b1, w2, b2, ys, n_acc, n_steps, stream)
    "tdt_dopri5_lanes": [_I, _I, _I, _I, _I, _P, _P, _I, _D, _D, _D, _D, _D,
                         _D, _D, _D, _I, _I, _P, _I, _I, _I, _P, _P, _P, _P,
                         _P, _P, _P, _P],
}

# what the last build printed (ptxas register and spill counts) and took
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


@functools.lru_cache(maxsize=None)
def library():
    """The loaded kernel library, built first if its hash is new."""
    cu, cuh = _sources()
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in cu + cuh:
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    so_path = BUILD_DIR / f"libtdt_kernels_{digest.hexdigest()[:16]}.so"
    if not so_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *map(str, cu)]
        start = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_info["seconds"] = time.perf_counter() - start
        build_info["log"] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{build_info['log'][-4000:]}")
        os.replace(tmp, so_path)   # atomic: a concurrent build is harmless
    build_info["path"] = str(so_path)
    lib = ctypes.CDLL(str(so_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
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

"""Build and load the hand-written Hopper kernels (`fgoicp_tpu_torch/csrc`).

The CUDA sources have a plain C interface (no PyTorch headers), so one nvcc
call compiles them in seconds into a shared library that is loaded with
ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -shared -Xcompiler -fPIC -o build/fgoicp_tpu_torch/<lib>.so csrc/*.cu

The library name carries a hash of the sources and flags, so an edited
source is rebuilt at its first use and a stale library is never loaded.
`--fmad=false` (and no `--use_fast_math`) keeps every multiply and add
rounded on its own, the way PyTorch's elementwise kernels round them, so the
kernels agree with their plain torch versions bit for bit where the
arithmetic order is the same.

Nothing here runs at import time: `load()` is called by the first kernel
launch, and by `chip_smoke.py` to time the build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fgoicp_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes.  Every one returns cudaGetLastError().
_SIGNATURES = {
    # (queries, points, M, T, d2_out, idx_out, stream)
    "fgoicp_nn_argmin": (_P, _P, _I, _I, _P, _P, _P),
    # (queries, points, M, T, d2_out, stream)
    "fgoicp_nn_min": (_P, _P, _I, _I, _P, _P),
    # (base, gids, t, proxies, gam_ub, gam_lb, gam_t, w, slack,
    #  G, ns, P, L, lb_out, ub_out, stream)
    "fgoicp_bounds_lanes": (_P, _P, _P, _P, _P, _P, _P, _P, _F,
                            _I, _I, _I, _I, _P, _P, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
            "fgoicp_tpu_torch CUDA kernels are built from source at first use")
    return path


def sources() -> list[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> pathlib.Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfgoicp_tpu_torch_{h.hexdigest()[:16]}.so"


@functools.cache
def load() -> ctypes.CDLL:
    """Build the kernel library if its sources changed, load it, and
    declare every entry point's argument and return types."""
    lib_path = library_path()
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(lib_path.name + f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               *[str(s) for s in sources()]]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.fgoicp_error_string.argtypes = [ctypes.c_int]
    lib.fgoicp_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error at its launch."""
    if err != 0:
        msg = load().fgoicp_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} at launch: {msg}")

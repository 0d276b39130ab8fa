"""Build and load the hand-written Hopper kernels (`fgoicp_tpu_torch/csrc`).

The CUDA sources have a plain C interface (no PyTorch headers), so nvcc
compiles them in seconds: one nvcc per source, all started together, then
one link into a shared library that is loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 --fmad=false
         -Xcompiler -fPIC -c csrc/<name>.cu -o build/fgoicp_tpu_torch/<hash>/<name>.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <lib>.so *.o

The library name carries a hash of the sources (`*.cu` and `*.cuh`) and
flags, so an edited source is rebuilt at its first use and a stale library
is never loaded.
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
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "--fmad=false", "-Xcompiler",
              "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: name -> argtypes.  Every one returns cudaGetLastError().
_SIGNATURES = {
    # (queries, points, M, T, splits, chunk, d2_out, idx_out, keys, stream)
    "fgoicp_nn_argmin": (_P, _P, _I, _I, _I, _I, _P, _P, _P, _P),
    # (queries, points, M, T, splits, chunk, d2_out, stream)
    "fgoicp_nn_min": (_P, _P, _I, _I, _I, _I, _P, _P),
    # (base, gids, t, rows, boxes, order, gam_ub, gam_lb, gam_t, w, slack,
    #  G, ns, n_buckets, L, counts, lb_out, ub_out, stream)
    "fgoicp_bounds_lanes": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                            _I, _I, _I, _I, _P, _P, _P, _P),
    # (base, t_centers, rows, boxes, order, gam_ub, gam_lb, gam_t, w, slack,
    #  G, B, ns, n_buckets, counts, lb_out, ub_out, stream)
    "fgoicp_bounds_grid": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _F,
                           _I, _I, _I, _I, _P, _P, _P, _P),
    # (ns, n_buckets, int* fits)
    "fgoicp_bounds_lanes_trimmed_fits": (_I, _I, ctypes.POINTER(_I)),
    # (base, gids, t, rows, boxes, order, gam_ub, gam_lb, gam_t, w, slack,
    #  G, ns, n_buckets, L, n_drop, scratch, counts, lb_out, ub_out, stream)
    "fgoicp_bounds_lanes_trimmed": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _F, _I, _I, _I, _I, _I, _P, _P, _P, _P,
                                    _P),
    # (g, res, lines, n, counts, out, stream)
    "fgoicp_minplus_1d": (_P, _F, _I, _I, _P, _P, _P),
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
    for src in sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfgoicp_tpu_torch_{h.hexdigest()[:16]}.so"


def _run(cmds: list[list[str]]) -> None:
    """Run the commands in parallel; raise with the output of a failure."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out}")


@functools.cache
def load() -> ctypes.CDLL:
    """Build the kernel library if its sources changed, load it, and
    declare every entry point's argument and return types."""
    lib_path = library_path()
    if not lib_path.exists():
        nvcc = _nvcc()
        obj_dir = BUILD_DIR / f"{lib_path.stem}.{os.getpid()}"
        obj_dir.mkdir(parents=True, exist_ok=True)
        objs = [obj_dir / f"{s.stem}.o" for s in sources()]
        _run([[nvcc, *NVCC_FLAGS, "-c", str(s), "-o", str(o)]
              for s, o in zip(sources(), objs)])
        tmp = lib_path.with_name(lib_path.name + f".{os.getpid()}.tmp")
        _run([[nvcc, *ARCH, "-shared", "-o", str(tmp),
               *[str(o) for o in objs]]])
        os.replace(tmp, lib_path)
        shutil.rmtree(obj_dir, ignore_errors=True)
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

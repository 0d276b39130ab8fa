"""Farthest-point sampling: the CUDA kernel (`csrc/fps.cu`) and its plain
torch version.

No TPU kernel: the JAX package's FPS (`fgoicp_tpu/ops/coreset.py::
farthest_point_sample`) is a `lax.fori_loop` of XLA ops.  Both versions
pick the JAX package's indices: start `seed % n`; each step the first
index among the maxima of the running minimum squared distance to the
points picked so far, the distances computed as d = p - c per axis, then
(dx*dx + dy*dy) + dz*dz, each operation rounded on its own.

Dispatch: tensors on the CPU go to the plain version, the loop that issues
about 11 small ops a step; CUDA tensors launch the kernel, all k - 1 steps
in one launch, or raise — there is no fallback from the card to the plain
version.  `farthest_point_sample.launches` counts the kernel launches (the
plain path does not count; a request reads it through
`utils/trace.py::LAUNCH_COUNTERS`).  Inside a request each call is a
"construct.fps" span that adds its k - 1 steps to "fps_steps".

On the card one block walks every step; where it keeps the points and
their running minima follows from n alone (`plan_layout`).
"""

from __future__ import annotations

import torch

from ..kernels import build
from ..utils import debug, trace

# The kernel's block (csrc/fps.cu: one block of THREADS threads) and the
# shared memory its dynamic part may take, passed to the C entry: an H100's
# opt-in 232,448 bytes a block, less the kernel's static buffer of 2 x 32
# 64-bit keys.
THREADS = 1024
SMEM_LIMIT = 232_448 - 2 * 32 * 8
# Where the kernel keeps the points and their minima, in the C entry's
# numbering, with the shared-memory bytes a point takes (csrc/fps.cu's
# carve-up).
LAYOUTS = {"shared": (0, 16), "minima": (1, 4), "global": (2, 0)}


def plan_layout(n: int) -> str:
    """The kernel's layout for n points: "shared" (coordinates and minima
    in shared memory) while 16 bytes a point fit SMEM_LIMIT, else "minima"
    (coordinates read from global memory each step, minima in shared
    memory) while 4 bytes a point fit, else "global" (minima in a global
    scratch too)."""
    for name in ("shared", "minima"):
        if n * LAYOUTS[name][1] <= SMEM_LIMIT:
            return name
    return "global"


def _sq_dist_to(points: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    d = points - c
    return d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]


def farthest_point_sample_plain(points: torch.Tensor, k: int,
                                seed: int = 0) -> torch.Tensor:
    """Plain torch version, on any device: k int64 indices, O(k * n); the
    loop never waits for the device."""
    n = points.shape[0]
    start = seed % n
    idx = torch.empty(k, dtype=torch.int64, device=points.device)
    idx[0] = start
    mind2 = _sq_dist_to(points, points[start])
    for i in range(1, k):
        # First index among equal maxima, kept on the device (index_select
        # rather than indexing with a 0-d tensor, which reads it back).
        far = torch.argmax(mind2).reshape(1)
        idx[i:i + 1] = far
        mind2 = torch.minimum(
            mind2, _sq_dist_to(points, points.index_select(0, far)))
    return idx


def _check(points: torch.Tensor, k: int) -> torch.device:
    if points.dtype != torch.float32:
        raise TypeError(f"farthest_point_sample: points must be "
                        f"torch.float32, got {points.dtype}")
    if points.ndim != 2 or points.shape[1] != 3 or points.shape[0] == 0:
        raise ValueError(f"farthest_point_sample: points must be [n>0, 3], "
                         f"got {tuple(points.shape)}")
    if not points.is_contiguous():
        raise ValueError("farthest_point_sample: points must be contiguous")
    if points.shape[0] >= 2 ** 31 or not 1 <= k < 2 ** 31:
        raise ValueError(f"farthest_point_sample: needs n < 2^31 and "
                         f"1 <= k < 2^31, got n {points.shape[0]}, k {k}")
    return points.device


@trace.spanned("construct.fps")
@debug.checked("farthest_point_sample", inputs=True)
def farthest_point_sample(points: torch.Tensor, k: int,
                          seed: int = 0) -> torch.Tensor:
    """k int64 indices of a greedy farthest-point subsample of points
    [n, 3] (float32, contiguous), maximizing the min spacing, starting at
    `seed % n`; on the card one launch, which never synchronizes."""
    device = _check(points, k)
    trace.count("fps_steps", k - 1)
    if device.type == "cpu":
        return farthest_point_sample_plain(points, k, seed)
    lib = build.load()
    n = points.shape[0]
    layout = plan_layout(n)
    idx = torch.empty(k, dtype=torch.int64, device=device)
    # Freed on return while the kernel may still run: the caching allocator
    # reuses it only in this stream's order.
    scratch = torch.empty(n if layout == "global" else 0,
                          dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_fps(
            points.data_ptr(), n, k, seed % n, LAYOUTS[layout][0],
            SMEM_LIMIT, scratch.data_ptr() or None, idx.data_ptr(), stream),
            "farthest_point_sample")
    farthest_point_sample.launches += 1
    return idx


farthest_point_sample.launches = 0

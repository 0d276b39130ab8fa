"""1-D parabolic min-plus transform: the CUDA kernel (`csrc/minplus.cu`) and
its plain torch version.

Counterpart of the Pallas kernel `fgoicp_tpu/ops/pallas_minplus.py::
minplus_1d`, computed as the JAX package's production path
`fgoicp_tpu/ops/distance_field.py::_minplus_1d` rounds it:

    out[l, i] = min_j g[l, j] + c * c,   c = (float32(i - j)) * res

with every product and sum rounded on its own in float32.  It is the pass
that the exact EDT (`ops/distance_field.py::_build_edt`) runs along each
axis of the grid.

Dispatch: CPU tensors go to the plain version; CUDA tensors launch the kernel
or raise.  `minplus_1d.launches` counts the kernel launches.  The kernel
equals the plain version bit for bit: min is exact, and the kernel skips
only (line, output, chunk of j) triples that provably cannot win (see the
source note).  Its layout: blocks of TILE_LINES lines, warps of
WARP_LINES, output tiles of TILE_OUT (OUTS_PER_THREAD a thread), chunks of
CHUNK j.
"""

from __future__ import annotations

import torch

from ..kernels import build
from .cuda_nn import check_f32

# The kernel's layout (csrc/minplus.cu): lines per block and per warp,
# outputs per tile and per thread, and j per chunk.
TILE_LINES, WARP_LINES, TILE_OUT, OUTS_PER_THREAD, CHUNK = 64, 8, 128, 4, 32


def minplus_1d_plain(g: torch.Tensor, res: float, out_chunk: int = 128,
                     line_chunk: int = 1024) -> torch.Tensor:
    """Plain torch version, on any device.  Lines are taken `line_chunk` and
    outputs `out_chunk` at a time, so the largest temporary is
    [line_chunk, n, out_chunk] whatever L is."""
    lines, n = g.shape
    out = torch.empty_like(g)
    res_t = torch.tensor(res, dtype=torch.float32, device=g.device)
    j = torch.arange(n, dtype=torch.float32, device=g.device)
    for i0 in range(0, n, out_chunk):
        i = torch.arange(i0, min(i0 + out_chunk, n), dtype=torch.float32,
                         device=g.device)
        x = (i[None, :] - j[:, None]) * res_t                    # [n, oc]
        cost = x * x
        for l0 in range(0, lines, line_chunk):
            out[l0:l0 + line_chunk, i0:i0 + out_chunk] = torch.amin(
                g[l0:l0 + line_chunk, :, None] + cost[None], dim=1)
    return out


def minplus_1d(g: torch.Tensor, res: float) -> torch.Tensor:
    """out [L, n] f32 with out[l, i] = min_j g[l, j] + ((i - j) * res)^2.

    g [L, n]: float32, contiguous.  Replaces
    `fgoicp_tpu/ops/pallas_minplus.py::minplus_1d`."""
    if g.ndim != 2:
        raise ValueError(f"minplus_1d: g must be [L, n], got {tuple(g.shape)}")
    device = check_f32("minplus_1d", g=g)
    lines, n = g.shape
    if lines >= 2 ** 31 or n >= 2 ** 24:
        raise ValueError(f"minplus_1d: [L, n] = {(lines, n)} needs L < 2^31 "
                         f"and n < 2^24")
    if device.type == "cpu" or g.numel() == 0:
        return minplus_1d_plain(g, res)
    out = _launch(g, res)
    minplus_1d.launches += 1
    return out


def _launch(g: torch.Tensor, res: float, counts=None) -> torch.Tensor:
    """The kernel on a checked CUDA g.  counts, an int64 CUDA tensor [2] or
    None, gets the (line, i, j) triples evaluated and the (warp, chunk)
    pairs staged added.  Counts no launch."""
    lib = build.load()
    lines, n = g.shape
    out = torch.empty_like(g)
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        build.check(lib.fgoicp_minplus_1d(
            g.data_ptr(), float(res), lines, n,
            None if counts is None else counts.data_ptr(), out.data_ptr(),
            stream), "minplus_1d")
    return out


minplus_1d.launches = 0

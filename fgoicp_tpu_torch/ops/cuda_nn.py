"""Exact nearest neighbour: the CUDA kernels (`csrc/nn.cu`) and their plain
torch versions.

Counterpart of the Pallas kernels `fgoicp_tpu/ops/pallas_nn.py::nn_argmin`
and `::nn_min`.  Both compute, per query, the exact f32 minimum of
(c - q)_x^2 + (c - q)_y^2 + (c - q)_z^2 over the target points by direct
differences (never the norm expansion), starting from BIG = 1e10 and keeping
the first index among equal minima.

Dispatch: tensors on the CPU go to the plain version; CUDA tensors launch the
kernel or raise — there is no fallback from the card to the plain version.
Each wrapper's `launches` attribute counts its kernel launches (the plain
path does not count), so a run can show that it went through the kernel.
"""

from __future__ import annotations

import torch

from ..kernels import build

BIG = 1e10  # the kernels' initial running minimum (pallas_nn.BIG)

# Elements of one [queries, targets] distance block in the plain versions
# (a few such temporaries are alive at once).
_PLAIN_BLOCK = 1 << 24


def check_f32(name: str, **tensors) -> torch.device:
    """Common argument checks of the kernel wrappers: float32 (int32 for
    `gids`), contiguous, all on one device.  Returns that device."""
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name}: tensors on several devices {devices}")
    for key, t in tensors.items():
        want = torch.int32 if key == "gids" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name}: {key} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    return devices.pop()


def _check_points(name: str, queries, points):
    if queries.ndim != 2 or queries.shape[1] != 3:
        raise ValueError(f"{name}: queries must be [M, 3], got {tuple(queries.shape)}")
    if points.ndim != 2 or points.shape[1] != 3 or points.shape[0] == 0:
        raise ValueError(f"{name}: points must be [T>0, 3], got {tuple(points.shape)}")
    if queries.shape[0] >= 2 ** 31 or points.shape[0] >= 2 ** 31:
        raise ValueError(f"{name}: sizes must fit in int32")
    return check_f32(name, queries=queries, points=points)


def _sq_dist_block(points, q):
    """[len(q), T] squared distances, rounded like the kernels:
    dx = c - q per axis, then (dx*dx + dy*dy) + dz*dz."""
    dx = points[None, :, 0] - q[:, 0:1]
    dy = points[None, :, 1] - q[:, 1:2]
    dz = points[None, :, 2] - q[:, 2:3]
    return dx * dx + dy * dy + dz * dz


def nn_argmin_plain(queries: torch.Tensor, points: torch.Tensor):
    """Plain torch version of `nn_argmin`, on any device: query-chunked
    direct differences; `torch.min` keeps the first index among ties."""
    m, t = queries.shape[0], points.shape[0]
    d2_out = torch.empty(m, dtype=torch.float32, device=queries.device)
    idx_out = torch.empty(m, dtype=torch.int32, device=queries.device)
    rows = max(1, _PLAIN_BLOCK // t)
    for s in range(0, m, rows):
        val, arg = torch.min(_sq_dist_block(points, queries[s:s + rows]), dim=1)
        # The kernels start from BIG with a strict `<`: a minimum that does
        # not beat BIG leaves (BIG, 0).
        beat = val < BIG
        d2_out[s:s + rows] = torch.where(beat, val, BIG)
        idx_out[s:s + rows] = torch.where(beat, arg, 0).to(torch.int32)
    return d2_out, idx_out


def nn_min_plain(queries: torch.Tensor, points: torch.Tensor):
    """Plain torch version of `nn_min`, on any device."""
    m, t = queries.shape[0], points.shape[0]
    d2_out = torch.empty(m, dtype=torch.float32, device=queries.device)
    rows = max(1, _PLAIN_BLOCK // t)
    for s in range(0, m, rows):
        val = torch.amin(_sq_dist_block(points, queries[s:s + rows]), dim=1)
        d2_out[s:s + rows] = torch.clamp(val, max=BIG)
    return d2_out


def nn_argmin(queries: torch.Tensor, points: torch.Tensor):
    """(d2 [M] f32, idx [M] i32) of the nearest target point per query.

    queries [M, 3], points [T, 3]: float32, contiguous, one device.
    Replaces `fgoicp_tpu/ops/pallas_nn.py::nn_argmin`."""
    device = _check_points("nn_argmin", queries, points)
    if device.type == "cpu":
        return nn_argmin_plain(queries, points)
    lib = build.load()
    m, t = queries.shape[0], points.shape[0]
    d2 = torch.empty(m, dtype=torch.float32, device=device)
    idx = torch.empty(m, dtype=torch.int32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_nn_argmin(
            queries.data_ptr(), points.data_ptr(), m, t, d2.data_ptr(),
            idx.data_ptr(), stream), "nn_argmin")
    nn_argmin.launches += 1
    return d2, idx


def nn_min(queries: torch.Tensor, points: torch.Tensor):
    """d2 [M] f32 of the nearest target point per query (no argmin).

    Replaces `fgoicp_tpu/ops/pallas_nn.py::nn_min`."""
    device = _check_points("nn_min", queries, points)
    if device.type == "cpu":
        return nn_min_plain(queries, points)
    lib = build.load()
    m, t = queries.shape[0], points.shape[0]
    d2 = torch.empty(m, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_nn_min(
            queries.data_ptr(), points.data_ptr(), m, t, d2.data_ptr(),
            stream), "nn_min")
    nn_min.launches += 1
    return d2


nn_argmin.launches = 0
nn_min.launches = 0

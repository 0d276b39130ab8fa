"""Fused per-lane bound evaluation: the CUDA kernel (`csrc/bounds_lanes.cu`)
and its plain torch version.

Counterpart of the Pallas kernel
`fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes`, the pooled inner
frontier's hot operation.  For lane l with g = gids[l]:

    q   = base[g, i] + t[l]
    d   = sqrt(max(min(BIG, min_p ||c_p - q||^2), 0))
    ub_l = sum_i w_i * relu(d - gam_ub[g, i])^2
    lb_l = sum_i w_i * relu(d - slack - gam_lb[g, i] - gam_t[l])^2

Dispatch: CPU tensors go to the plain version; CUDA tensors launch the
kernel or raise.  `fused_bounds_lanes.launches` counts kernel launches.
The only rounding difference between the two is the order of the final sums
over i, hence the rtol 2e-4 / atol 2e-5 they are compared at (the JAX
package's tolerance between its Pallas kernel and XLA path).
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import build
from .cuda_nn import BIG, check_f32

# Elements of one [lanes, ns, P] distance block in the plain version.
_PLAIN_BLOCK = 1 << 24


def fused_bounds_lanes_plain(base, gids, t_lanes, proxies, gam_ub, gam_lb,
                             gam_t_lanes, slack: float, w):
    """Plain torch version of `fused_bounds_lanes`, on any device:
    lane-chunked, with the kernel's evaluation order per point."""
    lanes = gids.shape[0]
    ns, n_prox = base.shape[1], proxies.shape[0]
    lb = torch.empty(lanes, dtype=torch.float32, device=base.device)
    ub = torch.empty(lanes, dtype=torch.float32, device=base.device)
    chunk = max(1, _PLAIN_BLOCK // max(1, ns * n_prox))
    for s in range(0, lanes, chunk):
        g = gids[s:s + chunk].long()
        q = base[g] + t_lanes[s:s + chunk, None, :]             # [c, ns, 3]
        dx = proxies[:, 0] - q[..., 0:1]                        # [c, ns, P]
        dy = proxies[:, 1] - q[..., 1:2]
        dz = proxies[:, 2] - q[..., 2:3]
        m = torch.amin(dx * dx + dy * dy + dz * dz, dim=-1)
        d = torch.sqrt(torch.clamp(torch.clamp(m, max=BIG), min=0.0))
        u = torch.clamp(d - gam_ub[g], min=0.0)
        v = torch.clamp(d - slack - gam_lb[g]
                        - gam_t_lanes[s:s + chunk, None], min=0.0)
        ub[s:s + chunk] = torch.sum(w * (u * u), dim=-1)
        lb[s:s + chunk] = torch.sum(w * (v * v), dim=-1)
    return lb, ub


def fused_bounds_lanes(base, gids, t_lanes, proxies, gam_ub, gam_t_lanes,
                       slack, point_weights=None, gam_lb=None):
    """lb, ub [L] for L independent lanes (the pooled-frontier hot op).

    base [G, ns, 3] rotated source per group; gids [L] int32 group per
    lane; t_lanes [L, 3]; proxies [P, 3]; gam_ub / gam_lb [G, ns]
    (gam_lb defaults to gam_ub); gam_t_lanes [L]; slack a Python float or
    0-d tensor (rounded to float32); point_weights [ns] (default ones).
    Same layout and argument order as the JAX package's function.
    Replaces `fgoicp_tpu/ops/pallas_bounds.py::fused_bounds_lanes`."""
    if gam_lb is None:
        gam_lb = gam_ub
    if base.ndim != 3 or base.shape[2] != 3:
        raise ValueError(f"fused_bounds_lanes: base must be [G, ns, 3], "
                         f"got {tuple(base.shape)}")
    n_groups, ns, _ = base.shape
    lanes = gids.shape[0]
    if point_weights is None:
        point_weights = torch.ones(ns, dtype=torch.float32, device=base.device)
    shapes = {"gids": (lanes,), "t_lanes": (lanes, 3),
              "gam_ub": (n_groups, ns), "gam_lb": (n_groups, ns),
              "gam_t_lanes": (lanes,), "point_weights": (ns,)}
    args = dict(base=base, gids=gids, t_lanes=t_lanes, proxies=proxies,
                gam_ub=gam_ub, gam_lb=gam_lb, gam_t_lanes=gam_t_lanes,
                point_weights=point_weights)
    for key, shape in shapes.items():
        if tuple(args[key].shape) != shape:
            raise ValueError(f"fused_bounds_lanes: {key} must be {shape}, "
                             f"got {tuple(args[key].shape)}")
    if proxies.ndim != 2 or proxies.shape[1] != 3 or proxies.shape[0] == 0:
        raise ValueError(f"fused_bounds_lanes: proxies must be [P>0, 3], "
                         f"got {tuple(proxies.shape)}")
    device = check_f32("fused_bounds_lanes", **args)
    slack = float(np.float32(float(slack)))
    if device.type == "cpu":
        return fused_bounds_lanes_plain(base, gids, t_lanes, proxies, gam_ub,
                                        gam_lb, gam_t_lanes, slack,
                                        point_weights)
    lib = build.load()
    lb = torch.empty(lanes, dtype=torch.float32, device=device)
    ub = torch.empty(lanes, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        build.check(lib.fgoicp_bounds_lanes(
            base.data_ptr(), gids.data_ptr(), t_lanes.data_ptr(),
            proxies.data_ptr(), gam_ub.data_ptr(), gam_lb.data_ptr(),
            gam_t_lanes.data_ptr(), point_weights.data_ptr(), slack,
            n_groups, ns, proxies.shape[0], lanes, lb.data_ptr(),
            ub.data_ptr(), stream), "fused_bounds_lanes")
    fused_bounds_lanes.launches += 1
    return lb, ub


fused_bounds_lanes.launches = 0

"""Peaks of the card and the work of the nearest-neighbour kernels.

Peaks: NVIDIA's data sheet for one H100 SXM at its 700 W limit, float32
outside the tensor cores and HBM3 bandwidth.  The NN kernels (`nn_argmin`,
`nn_min`) implement the exhaustive scan: every (query, target) pair costs
8 flops (3 sub, 3 mul, 2 add; the compare and the min left out), each
input byte is read once (12 bytes a point), each output written once
(d2 as float32, and for the argmin an int32 index).  A change that drops
the scan (a spatial index) needs this count redone first.
"""

from __future__ import annotations

PEAK_F32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
NN_FLOPS_PER_PAIR = 8
POINT_BYTES = 12
OUT_BYTES = {"nn_argmin": 8, "nn_min": 4}


def nn_work(kind: str, m: int, t: int) -> tuple:
    """(flops, bytes) of one NN call of m queries against t targets."""
    return (NN_FLOPS_PER_PAIR * m * t,
            POINT_BYTES * (m + t) + OUT_BYTES[kind] * m)


def bound_s(flops: float, nbytes: float) -> float:
    """The least seconds the card could take: the larger of the flops at
    the float32 peak and the bytes at the HBM peak."""
    return max(flops / PEAK_F32_FLOPS, nbytes / PEAK_BYTES)


def nn_bound_s(calls) -> float:
    """The summed bound of NN calls [(kind, m, t)]."""
    return sum(bound_s(*nn_work(k, m, t)) for k, m, t in calls)

"""The work of the bound kernels (`fused_bounds_lanes`, its trimmed form,
`fused_bounds`) and their share of it.

The kernels prune: each warp finds its points' nearest proxies by a box
test per bucket and scans only the buckets a box test leaves open, so the
work depends on the data.  The program counts it in each request
(`fgoicp_tpu_torch/utils/trace.py`): "bound_pairs", the (point, proxy)
pairs evaluated, 8 flops each (3 sub, 3 mul, 2 add; the min left out);
"bound_box_tests", the (point, box) tests, 17 flops each (6 sub, 6 max,
3 mul, 2 add: `csrc/bounds_terms.cuh::box_d2`, the count chip_smoke.py
uses);
"bound_bytes", each launch's distinct inputs read once and its lb and ub
written once.  The bound is the larger of the flops at the float32 peak and
the bytes at the HBM peak (`roofline.bound_s`); the share is that bound
over the kernels' device time in the traced requests.  The time covers the
work counted, so the share cannot pass 100 % however much the kernels
prune.
"""

from __future__ import annotations

from . import readers, roofline

KERNELS = ("bounds_lanes_kernel", "bounds_lanes_trimmed_kernel",
           "bounds_grid_kernel")
FLOPS_PER_PAIR = 8
FLOPS_PER_BOX_TEST = 17


def bound_s(pairs: int, box_tests: int, nbytes: int) -> float:
    return roofline.bound_s(FLOPS_PER_PAIR * pairs
                            + FLOPS_PER_BOX_TEST * box_tests, nbytes)


def profiled(ctx):
    """The program's records of the traced requests (those just before the
    window's later ones), or None."""
    p = ctx["profile"]
    if p is None or not p["requests"]:
        return None
    try:
        from fgoicp_tpu_torch.utils import trace
    except ImportError:
        return None
    recs = trace.requests()
    end = len(recs) - ctx["later_requests"]
    return recs[end - p["requests"]:end] if end >= p["requests"] else None


def share(ctx):
    """The bound kernels' share of their counted work's bound, in %; None
    where the traced requests launched none or counted nothing."""
    recs = profiled(ctx)
    if recs is None:
        return None
    pairs, tests, nbytes = (sum(r.counts[k] for r in recs) for k in (
        "bound_pairs", "bound_box_tests", "bound_bytes"))
    busy = readers.kernel_s(ctx["profile"], KERNELS)
    if not pairs or not busy:
        return None
    return 100.0 * bound_s(pairs, tests, nbytes) / busy

"""The trimmed lane kernel on the box-pruned search
(fgoicp_tpu_torch/csrc/bounds_lanes_trimmed.cu): a plain mirror of what it
computes, kept here, against the plain version
`fused_bounds_lanes_trimmed_plain`.

The mirror takes every point's nearest-proxy value m from the pruned
search's mirror (tests/test_torch_bound_buckets.py::pruned_min_mirror) on
the proxies' buckets and the source order, forms the terms as the plain
version does, and runs the kernel's double bisection in float32 numpy (mid
= 0.5 * (lo + hi), exact counts) and its direct kept sums.  The terms and
both thresholds must equal the plain version's bit for bit; lb / ub agree
within rtol 2e-4 / atol 2e-5, since the kept sums run in another order.
"""
import numpy as np
import pytest
import torch

from fgoicp_tpu_torch.ops import cuda_bounds
from test_torch_bound_buckets import pruned_min_mirror

ITERS = cuda_bounds.BISECT_ITERS


def _bisect_mirror(x, n_drop):
    """The kernel's bisection of one lane's terms x [ns] float32 numpy:
    (lo, hi) after ITERS steps, from lo = 0, hi = max(0, max x)."""
    lo, hi = np.float32(0.0), np.float32(max(0.0, float(x.max())))
    for _ in range(ITERS):
        mid = np.float32(0.5) * np.float32(lo + hi)
        if int(np.count_nonzero(x > mid)) >= n_drop:
            lo = mid
        else:
            hi = mid
    return lo, hi


def _kept(x, threshold, lo, n_drop):
    """The kernel's kept sum: the terms <= threshold summed directly, less
    (n_drop - count(x > threshold)) * lo, in float32."""
    kept = x <= threshold
    s = np.float32(np.sum(x[kept], dtype=np.float32))
    return np.float32(s - np.float32(n_drop - int((~kept).sum())) * lo)


def mirror_trimmed(base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t,
                   slack, w, n_drop):
    """(lb, ub [L], terms (ut, lt) [L, ns], thresholds [L, 4] as (lo_u, hi_u,
    lo_l, hi_l)) of the trimmed lane kernel, m from the pruned search on
    the proxies' buckets and base[0]'s source order."""
    g = gids.long()
    m, _ = pruned_min_mirror(base[g] + t_lanes[:, None, :],
                             cuda_bounds.proxy_buckets(proxies),
                             cuda_bounds.source_order(base[0]))
    d = torch.sqrt(torch.clamp(m, min=0.0))
    u = torch.clamp(d - gam_ub[g], min=0.0)
    v = torch.clamp(d - slack - gam_lb[g] - gam_t[:, None], min=0.0)
    ut, lt = w * (u * u), w * (v * v)
    lb, ub, thr = [], [], []
    for xu, xl in zip(ut.numpy(), lt.numpy()):
        lo_u, hi_u = _bisect_mirror(xu, n_drop)
        lo_l, hi_l = _bisect_mirror(xl, n_drop)
        ub.append(_kept(xu, hi_u, lo_u, n_drop))
        lb.append(_kept(xl, lo_l, lo_l, n_drop))
        thr.append((lo_u, hi_u, lo_l, hi_l))
    return (torch.tensor(np.array(lb)), torch.tensor(np.array(ub)), (ut, lt),
            torch.tensor(np.array(thr)))


def _case(p, ns, lanes=6, groups=3):
    rng = np.random.default_rng(10 * p + ns)
    f32 = lambda a: torch.from_numpy(np.asarray(a, np.float32))
    src = f32(rng.uniform(-0.7, 0.7, size=(ns, 3)))
    angles = rng.uniform(-0.5, 0.5, size=groups)
    R = np.stack([[[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                   [0, 0, 1]] for a in angles]).astype(np.float32)
    base = torch.einsum("grc,nc->gnr", f32(R), src).contiguous()
    gam_ub = f32(rng.uniform(0.0, 0.05, size=(groups, ns)))
    gam_lb = gam_ub + f32(rng.uniform(0.0, 0.02, size=(groups, ns)))
    w = f32(rng.uniform(size=ns) < 0.9)           # a 0/1 mask
    gids = torch.from_numpy(rng.integers(0, groups, size=lanes)
                            .astype(np.int32))
    return dict(base=base, gids=gids,
                t_lanes=f32(rng.uniform(-0.4, 0.4, size=(lanes, 3))),
                proxies=f32(rng.uniform(-0.9, 0.9, size=(p, 3))),
                gam_ub=gam_ub, gam_lb=gam_lb,
                gam_t=f32(rng.uniform(0.0, 0.1, size=lanes)),
                slack=float(np.float32(0.01)), w=w,
                n_drop=int(round(0.3 * ns)))


@pytest.mark.parametrize("p", [33, 1024, 2049])
@pytest.mark.parametrize("ns", [129, 3000])
def test_pruned_trimmed_mirror_equals_plain(p, ns):
    c = _case(p, ns)
    lb_m, ub_m, (ut_m, lt_m), thr_m = mirror_trimmed(**c)
    args = (c["base"], c["gids"], c["t_lanes"], c["proxies"], c["gam_ub"],
            c["gam_lb"], c["gam_t"], c["slack"], c["w"])
    parts = list(cuda_bounds._lane_terms_plain(*args))
    ut_p = torch.cat([ut for _, ut, _ in parts])
    lt_p = torch.cat([lt for _, _, lt in parts])
    assert torch.equal(ut_m, ut_p) and torch.equal(lt_m, lt_p)
    kf = torch.tensor(float(c["n_drop"]))
    hi_u, lo_u = cuda_bounds._bisect(ut_p, kf, "under", ITERS)
    hi_l, lo_l = cuda_bounds._bisect(lt_p, kf, "under", ITERS)
    assert torch.equal(thr_m, torch.stack([lo_u, hi_u, lo_l, hi_l], dim=1))
    lb_p, ub_p = cuda_bounds.fused_bounds_lanes_trimmed_plain(
        *args, c["n_drop"])
    np.testing.assert_allclose(ub_m.numpy(), ub_p.numpy(), rtol=2e-4,
                               atol=2e-5)
    np.testing.assert_allclose(lb_m.numpy(), lb_p.numpy(), rtol=2e-4,
                               atol=2e-5)
    assert bool(torch.all(lb_m <= ub_m + 1e-5))


def test_wrapper_takes_buckets_and_order_on_the_cpu():
    """A `ProxyBuckets` and a point order give the plain version's results
    on the CPU, bit for bit, and launch nothing."""
    c = _case(1024, 129)
    before = cuda_bounds.fused_bounds_lanes_trimmed.launches
    call = lambda px, order: cuda_bounds.fused_bounds_lanes_trimmed(
        c["base"], c["gids"], c["t_lanes"], px, c["gam_ub"], c["gam_t"],
        c["slack"], c["n_drop"], point_weights=c["w"], gam_lb=c["gam_lb"],
        point_order=order)
    want = call(c["proxies"], None)
    got = call(cuda_bounds.proxy_buckets(c["proxies"]),
               cuda_bounds.source_order(c["base"][0]))
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert cuda_bounds.fused_bounds_lanes_trimmed.launches == before

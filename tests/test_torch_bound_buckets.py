"""The layout of the bound kernels' box-pruned nearest-proxy
search (fgoicp_tpu_torch/ops/cuda_bounds.py: `morton_codes`,
`spatial_order`, `proxy_buckets`, `source_order`), the wrappers' buckets
and point order arguments, and a plain torch mirror of the kernels'
pruning rule (csrc/bounds_terms.cuh::node_bounds), kept here.

The mirror must give every point's nearest-proxy value m bit for bit as
the full scan of `fused_bounds_lanes_plain` does (`torch.equal`): skipping
a bucket whose box lower bound is at least m changes no minimum.  Its
lb / ub must agree with the JAX package's Pallas kernels (interpret mode)
within rtol 2e-4 / atol 2e-5 (tests/test_pallas_bounds.py): the sums over
source points run in another order on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import bounds as jbounds
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu.ops import pallas_bounds
from fgoicp_tpu_torch.ops import cuda_bounds
from fgoicp_tpu_torch.ops.cuda_nn import BIG
from torch_threads import one_torch_thread  # noqa: F401


def T(a):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _sq_dist(c, q):
    """[..., n] squared distances of q [..., 3] to c [n, 3], rounded as the
    kernels and the plain versions round them."""
    dx = c[:, 0] - q[..., 0:1]
    dy = c[:, 1] - q[..., 1:2]
    dz = c[:, 2] - q[..., 2:3]
    return dx * dx + dy * dy + dz * dz


def _box_d2(lo, hi, q):
    """The kernels' box_d2: per axis max(lo - q, q - hi, 0), then
    (gx*gx + gy*gy) + gz*gz."""
    g = torch.clamp(torch.maximum(lo - q, q - hi), min=0.0)
    return g[..., 0] * g[..., 0] + g[..., 1] * g[..., 1] + g[..., 2] * g[..., 2]


def full_scan_min(q, proxies):
    """m = min(BIG, min_p ||c_p - q||^2) over all proxies, for q [N, ns, 3],
    as `fused_bounds_lanes_plain` computes it."""
    return torch.clamp(torch.amin(_sq_dist(proxies, q), dim=-1), max=BIG)


def pruned_min_mirror(q, buckets, order=None):
    """Plain torch mirror of the kernels' box-pruned search for q [N, ns, 3]
    (node n's query points base[g_n] + t_n) over `ProxyBuckets`: (m [N, ns],
    pairs evaluated).

    Warps own runs of WARP_POINTS consecutive entries of order [ns] (the
    identity when None).
    Pass 1 evaluates member BUCKET // 2 of every bucket; pass 2 visits the
    buckets in order and scans one for a run when box_d2 < m for any valid
    point of the run (the warp vote), else skips it for the whole run.
    pairs counts, per valid point, one pair per bucket in pass 1 and BUCKET
    per scanned bucket, as the kernels' counters do."""
    n, ns, _ = q.shape
    run, bucket = cuda_bounds.WARP_POINTS, cuda_bounds.BUCKET
    rows, boxes = buckets.rows, buckets.boxes
    runs = -(-ns // run)
    pos = torch.arange(runs * run)
    valid = (pos < ns).reshape(runs, run)
    order = torch.arange(ns) if order is None else order.long()
    qo = q[:, order[pos.clamp(max=ns - 1)]].reshape(n, runs, run, 3)
    m = torch.minimum(torch.full((n, runs, run), BIG),
                      torch.amin(_sq_dist(rows[bucket // 2::bucket], qo), -1))
    scanned = torch.zeros(n, runs, dtype=torch.int64)
    for b in range(boxes.shape[0]):
        need = ((_box_d2(boxes[b, :3], boxes[b, 3:], qo) < m)
                & valid).any(-1)
        if bool(need.any()):
            part = torch.amin(_sq_dist(rows[b * bucket:(b + 1) * bucket], qo),
                              -1)
            m = torch.where(need[..., None], torch.minimum(m, part), m)
            scanned += need
    pairs = int((valid.sum(-1) * (boxes.shape[0] + bucket * scanned)).sum())
    out = torch.empty(n, ns)
    out[:, order] = m.reshape(n, -1)[:, :ns]
    return out, pairs


def mirror_lane_bounds(base, gids, t_lanes, proxies, gam_ub, gam_lb,
                       gam_t_lanes, slack, w):
    """lb, ub [L] of `fused_bounds_lanes` with m from the pruned mirror on
    the proxies' buckets and base[0]'s source order, as GoICP hands them to
    the kernel; the terms as the plain version forms them, summed in the
    source order as the kernels sum them."""
    order = cuda_bounds.source_order(base[0]).long()
    g = gids.long()
    m, _ = pruned_min_mirror(base[g] + t_lanes[:, None, :],
                             cuda_bounds.proxy_buckets(proxies), order)
    d = torch.sqrt(torch.clamp(m, min=0.0))
    u = torch.clamp(d - gam_ub[g], min=0.0)
    v = torch.clamp(d - slack - gam_lb[g] - gam_t_lanes[:, None], min=0.0)
    return (torch.sum((w * (v * v))[:, order], dim=-1),
            torch.sum((w * (u * u))[:, order], dim=-1))


def _cloud(rng, n, lo=-0.9, hi=0.9):
    return T(rng.uniform(lo, hi, size=(n, 3)).astype(np.float32))


def _rotations(rng, g):
    R = jgeo.quat_cube_to_matrix(
        jnp.asarray(rng.uniform(-0.5, 0.5, size=(g, 3)), jnp.float32))
    return T(R)


def _queries(rng, src, nodes, spread=0.4):
    """q [nodes, ns, 3] = R_n src + t_n for seeded rotations and
    translations."""
    R = _rotations(rng, nodes)
    t = _cloud(rng, nodes, -spread, spread)
    return torch.einsum("grc,nc->gnr", R, src) + t[:, None, :]


# --- the bucket layout -----------------------------------------------------

@pytest.mark.parametrize("p", [1, 31, 33, 1024, 2049])
def test_proxy_buckets_hold_every_proxy_once_inside_its_box(p):
    rng = np.random.default_rng(p)
    proxies = _cloud(rng, p)
    points, rows, boxes = cuda_bounds.proxy_buckets(proxies)
    assert points is proxies
    bucket = cuda_bounds.BUCKET
    nb = -(-p // bucket)
    assert rows.shape == (nb * bucket, 3) and boxes.shape == (nb, 6)
    # The first P rows are the proxies, each exactly once.
    key = lambda a: a[np.lexsort(a.T[::-1])]
    np.testing.assert_array_equal(key(rows[:p].numpy()), key(proxies.numpy()))
    # Pads are copies of a member of their own (the last) bucket.
    last = rows[(nb - 1) * bucket:p]
    for pad in rows[p:]:
        assert bool(torch.any(torch.all(last == pad, dim=1)))
    # Each box is the exact min / max of its members.
    members = rows.view(nb, bucket, 3)
    assert torch.equal(boxes[:, :3], members.amin(1))
    assert torch.equal(boxes[:, 3:], members.amax(1))
    assert bool(torch.all(members >= boxes[:, None, :3]))
    assert bool(torch.all(members <= boxes[:, None, 3:]))


def test_proxy_buckets_keep_duplicates_and_split_them():
    """33 copies of one point (more than a bucket) among other proxies:
    they fill more than one bucket, and every copy is kept."""
    rng = np.random.default_rng(4)
    dup = torch.tensor([[0.25, -0.5, 0.125]])
    proxies = torch.cat([_cloud(rng, 60), dup.expand(33, 3), _cloud(rng, 7)])
    rows = cuda_bounds.proxy_buckets(proxies).rows
    n = proxies.shape[0]
    assert int(torch.all(rows[:n] == dup, dim=1).sum()) == 33
    holding = torch.all(rows.view(-1, cuda_bounds.BUCKET, 3) == dup,
                        dim=2).any(1)
    assert int(holding.sum()) >= 2


def _morton_reference(points):
    """Morton codes by a plain loop over the bits, from the same cells."""
    pts = points.numpy().astype(np.float32)
    top = 2 ** cuda_bounds.MORTON_BITS - 1
    lo, hi = pts.min(0), pts.max(0)
    unit = (pts - lo) / np.maximum(hi - lo, np.float32(1e-30))
    cells = np.clip((unit * np.float32(top)).astype(np.int64), 0, top)
    codes = np.zeros(len(pts), np.int64)
    for b in range(cuda_bounds.MORTON_BITS):
        for a in range(3):
            codes |= ((cells[:, a] >> b) & 1) << (3 * b + a)
    return codes


def test_morton_and_spatial_order_are_deterministic():
    rng = np.random.default_rng(2)
    pts = _cloud(rng, 1000)
    codes = cuda_bounds.morton_codes(pts)
    np.testing.assert_array_equal(codes.numpy(), _morton_reference(pts))
    first = cuda_bounds.spatial_order(pts, cuda_bounds.BUCKET)
    again = cuda_bounds.spatial_order(pts.clone(), cuda_bounds.BUCKET)
    assert torch.equal(first, again)
    assert torch.equal(torch.sort(first).values, torch.arange(1000))
    # Equal codes keep their input order (stable sorts).
    same = torch.zeros(40, 3)
    assert torch.equal(cuda_bounds.spatial_order(same, 8), torch.arange(40))
    assert cuda_bounds.morton_codes(torch.zeros(0, 3)).shape == (0,)


@pytest.mark.parametrize("ns", [1, 129, 3000])
def test_source_order_is_a_permutation(ns):
    rng = np.random.default_rng(ns)
    src = _cloud(rng, ns)
    order = cuda_bounds.source_order(src)
    assert order.dtype == torch.int32 and order.shape == (ns,)
    assert torch.equal(torch.sort(order.long()).values, torch.arange(ns))
    assert torch.equal(order, cuda_bounds.source_order(src.clone()))


def test_refined_buckets_are_more_compact_than_morton_runs():
    """The median splits leave smaller boxes than plain Morton runs on a
    seeded curve: what the pruning feeds on."""
    rng = np.random.default_rng(6)
    s = rng.uniform(0.0, 4.5, size=1024)
    curve = T(np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                        0.4 * np.sin(3 * s + 0.5)], 1).astype(np.float32))
    boxes = cuda_bounds.proxy_buckets(curve).boxes
    morton = curve[torch.argsort(cuda_bounds.morton_codes(curve), stable=True)]
    m_lo, m_hi = torch.aminmax(morton.view(32, 32, 3), dim=1)
    diag = lambda lo, hi: torch.linalg.vector_norm(hi - lo, dim=1).mean()
    assert float(diag(boxes[:, :3], boxes[:, 3:])) < float(diag(m_lo, m_hi))


# --- the pruning rule --------------------------------------------------------

@pytest.mark.parametrize("p", [1, 31, 33, 1024, 2049])
@pytest.mark.parametrize("ns", [1, 129, 3000])
def test_pruned_mirror_equals_full_scan(p, ns):
    rng = np.random.default_rng(1000 * p + ns)
    proxies = _cloud(rng, p)
    src = _cloud(rng, ns, -0.7, 0.7)
    q = _queries(rng, src, 3)
    m, pairs = pruned_min_mirror(q, cuda_bounds.proxy_buckets(proxies),
                                 cuda_bounds.source_order(src))
    assert torch.equal(m, full_scan_min(q, proxies))
    nb = -(-p // cuda_bounds.BUCKET)
    assert 3 * ns * nb <= pairs <= 3 * ns * (nb + nb * cuda_bounds.BUCKET)


def _grid_points(k):
    g = np.mgrid[0:k, 0:k, 0:k].reshape(3, -1).T.astype(np.float32)
    return T(g * np.float32(0.125))


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("case", ["faces_and_corners", "duplicates",
                                  "all_above_big"])
def test_pruned_mirror_equals_full_scan_on_edge_cases(case, ordered):
    """Points exactly on box faces and corners (proxies on a grid, queries
    on its nodes and face midpoints, no translation); 33 copies of one
    proxy split across buckets; every d2 above BIG.  With the source order
    and without one (the points as they come)."""
    rng = np.random.default_rng(9)
    if case == "faces_and_corners":
        proxies = _grid_points(8)                            # 512 nodes
        src = torch.cat([proxies, proxies + torch.tensor([0.0625, 0, 0]),
                         proxies + torch.tensor([0.0625, 0.0625, 0])])
        q = torch.stack([src, src + torch.tensor([0.125, 0.0, -0.125])])
    elif case == "duplicates":
        dup = torch.tensor([[0.3, 0.1, -0.2]])
        proxies = torch.cat([_cloud(rng, 100), dup.expand(33, 3),
                             _cloud(rng, 30)])
        src = torch.cat([_cloud(rng, 200), dup.expand(20, 3)])
        q = _queries(rng, src, 2, spread=0.05)
    else:
        proxies = _cloud(rng, 700)
        src = _cloud(rng, 300) + 2e5
        q = torch.stack([src, src - 1e3])
    order = cuda_bounds.source_order(q[0]) if ordered else None
    m, _ = pruned_min_mirror(q, cuda_bounds.proxy_buckets(proxies), order)
    full = full_scan_min(q, proxies)
    assert torch.equal(m, full)
    if case == "faces_and_corners":
        assert int((full == 0).sum()) >= 512
    if case == "all_above_big":
        assert bool(torch.all(m == BIG))


def test_pruning_skips_most_pairs_on_a_seeded_curve():
    """Proxies on a seeded curve, a rotated and shifted copy of it as the
    source: the pruned search evaluates under half the full scan's pairs
    while staying bit-equal."""
    rng = np.random.default_rng(12)
    s = rng.uniform(0.0, 4.5, size=(1024 + 1000))
    curve = T(np.stack([np.cos(s), 0.7 * np.sin(2 * s),
                        0.4 * np.sin(3 * s + 0.5)], 1).astype(np.float32))
    proxies, src = curve[:1024], curve[1024:]
    q = _queries(rng, src, 4, spread=0.3)
    m, pairs = pruned_min_mirror(q, cuda_bounds.proxy_buckets(proxies),
                                 cuda_bounds.source_order(src))
    assert torch.equal(m, full_scan_min(q, proxies))
    assert pairs < 0.5 * 4 * 1000 * 1024


# --- lb / ub against the JAX package -----------------------------------------

def _lane_inputs(seed, g, lanes, ns, p):
    rng = np.random.default_rng(seed)
    pcs = jnp.asarray(rng.uniform(-0.7, 0.7, size=(ns, 3)), jnp.float32)
    proxies = jnp.asarray(rng.uniform(-0.9, 0.9, size=(p, 3)), jnp.float32)
    R = jgeo.quat_cube_to_matrix(
        jnp.asarray(rng.uniform(-0.4, 0.4, size=(g, 3)), jnp.float32))
    spans = jnp.asarray(rng.uniform(0.05, 0.4, size=(g,)), jnp.float32)
    fix = jnp.arange(g) % 2 == 0
    deltas = jnp.asarray(rng.uniform(0.0, 0.03, size=(ns,)), jnp.float32)
    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = jbounds.gamma_arrays(jnp.linalg.norm(pcs, axis=-1),
                                          spans, fix, point_deltas=deltas)
    w = jnp.asarray(rng.integers(1, 6, size=(ns,)), jnp.float32)
    return rng, base, proxies, gam_ub, gam_lb, w


@pytest.mark.parametrize("ns,p", [(129, 33), (700, 300), (600, 2049)])
def test_mirror_lane_bounds_match_pallas(ns, p):
    rng, base, prox, gam_ub, gam_lb, w = _lane_inputs(ns + p, 4, 12, ns, p)
    gids = jnp.asarray(rng.integers(0, 4, size=(12,)), jnp.int32)
    t = jnp.asarray(rng.uniform(-0.4, 0.4, size=(12, 3)), jnp.float32)
    gam_t = jgeo.translation_uncertainty_radius(
        jnp.asarray(rng.uniform(0.05, 0.3, size=(12,)), jnp.float32))
    slack = np.float32(0.02)
    lb_k, ub_k = pallas_bounds.fused_bounds_lanes(
        base, gids, t, prox, gam_ub, gam_t, slack, point_weights=w,
        gam_lb=gam_lb, interpret=True)
    lb_m, ub_m = mirror_lane_bounds(T(base), T(gids), T(t), T(prox),
                                    T(gam_ub), T(gam_lb), T(gam_t),
                                    float(slack), T(w))
    np.testing.assert_allclose(ub_m.numpy(), np.asarray(ub_k),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lb_m.numpy(), np.asarray(lb_k),
                               rtol=2e-4, atol=2e-5)
    assert bool(torch.all(lb_m <= ub_m + 1e-5))


def test_mirror_grid_bounds_match_pallas():
    """The grid form: node (g, b) as lane g * B + b of the mirror."""
    g, b, ns, p = 3, 5, 700, 300
    rng, base, prox, gam_ub, gam_lb, w = _lane_inputs(5, g, 1, ns, p)
    tc = jnp.asarray(rng.uniform(-0.5, 0.5, size=(g, b, 3)), jnp.float32)
    gam_t = jgeo.translation_uncertainty_radius(
        jnp.asarray(rng.uniform(0.05, 0.3, size=(g, b)), jnp.float32))
    slack = np.float32(0.01)
    lb_k, ub_k = pallas_bounds.fused_bounds(
        base, tc, prox, gam_ub, gam_t, slack, point_weights=w,
        gam_lb=gam_lb, interpret=True)
    gids = torch.arange(g, dtype=torch.int32).repeat_interleave(b)
    lb_m, ub_m = mirror_lane_bounds(
        T(base), gids, T(tc).reshape(-1, 3), T(prox), T(gam_ub), T(gam_lb),
        T(gam_t).reshape(-1), float(slack), T(w))
    np.testing.assert_allclose(ub_m.reshape(g, b).numpy(), np.asarray(ub_k),
                               rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(lb_m.reshape(g, b).numpy(), np.asarray(lb_k),
                               rtol=2e-4, atol=2e-5)


def test_one_hot_weights_give_single_terms_bit_for_bit():
    """With one-hot point_weights each node's sum is one term, so the
    mirror's lb / ub equal the plain version's bit for bit whatever the
    sum order: the check kernel_check makes of the kernels."""
    rng, base, prox, gam_ub, gam_lb, _ = _lane_inputs(3, 4, 1, 300, 200)
    gids = T(rng.integers(0, 4, size=(16,)).astype(np.int32))
    t = _cloud(rng, 16, -0.4, 0.4)
    gam_t = T(rng.uniform(0.0, 0.1, size=(16,)).astype(np.float32))
    for j in (0, 7, 299):
        w = torch.zeros(300)
        w[j] = 1.0
        got = mirror_lane_bounds(T(base), gids, t, T(prox), T(gam_ub),
                                 T(gam_lb), gam_t, 0.01, w)
        want = cuda_bounds.fused_bounds_lanes_plain(
            T(base), gids, t, T(prox), T(gam_ub), T(gam_lb), gam_t, 0.01, w)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


# --- the wrappers' buckets and point order ----------------------------------

def _wrapper_args(rng, ns=50, p=40):
    base = torch.stack([_cloud(rng, ns)] * 2)
    prox = _cloud(rng, p)
    gam = torch.zeros(2, ns)
    gids = torch.zeros(3, dtype=torch.int32)
    return base, prox, (base, gids, torch.zeros(3, 3), prox, gam,
                        torch.zeros(3), 0.0)


def test_wrappers_take_buckets_and_a_point_order():
    """On the CPU a `ProxyBuckets` and a point order give the plain
    version's results on its points, as a bare tensor does."""
    rng = np.random.default_rng(8)
    base, prox, args = _wrapper_args(rng)
    buckets = cuda_bounds.proxy_buckets(prox)
    order = cuda_bounds.source_order(base[0])
    want = cuda_bounds.fused_bounds_lanes(*args)
    lanes = list(args)
    lanes[3] = buckets
    got = cuda_bounds.fused_bounds_lanes(*lanes, point_order=order)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    grid = (base, torch.full((2, 4, 3), 0.1), prox, args[4],
            torch.zeros(2, 4), 0.0)
    want = cuda_bounds.fused_bounds(*grid)
    got = cuda_bounds.fused_bounds(*grid[:2], buckets, *grid[3:],
                                   point_order=order)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("fault,error", [
    ("short order", ValueError), ("int64 order", TypeError),
    ("short boxes", ValueError), ("rows on float64", TypeError)])
def test_wrappers_check_buckets_and_point_order(fault, error):
    rng = np.random.default_rng(8)
    base, prox, args = _wrapper_args(rng)
    buckets = cuda_bounds.proxy_buckets(prox)
    order = cuda_bounds.source_order(base[0])
    if fault == "short order":
        order = order[:10]
    elif fault == "int64 order":
        order = order.long()
    elif fault == "short boxes":
        buckets = buckets._replace(boxes=buckets.boxes[:1])
    else:
        buckets = buckets._replace(rows=buckets.rows.double())
    lanes = list(args)
    lanes[3] = buckets
    with pytest.raises(error):
        cuda_bounds.fused_bounds_lanes(*lanes, point_order=order)
    with pytest.raises(error):
        cuda_bounds.fused_bounds_lanes_trimmed(*lanes[:7], 10,
                                               point_order=order)
    with pytest.raises(error):
        cuda_bounds.fused_bounds(base, torch.zeros(2, 4, 3), buckets,
                                 args[4], torch.zeros(2, 4), 0.0,
                                 point_order=order)


def test_proxy_backend_owns_its_buckets():
    """The backend builds its coreset's buckets once, on first use."""
    from fgoicp_tpu_torch.ops import bounds as bounds_ops
    rng = np.random.default_rng(3)
    backend = bounds_ops.make_backend(_cloud(rng, 300), proxy_size=64)
    buckets = backend.buckets
    assert buckets is backend.buckets
    assert buckets.points is not None and torch.equal(
        buckets.points, backend.coreset.points)
    assert buckets.boxes.shape == (2, 6)

"""Port parity: the plain torch versions of the fused bound kernels
(fgoicp_tpu_torch/ops/cuda_bounds.py: `fused_bounds_lanes`,
`fused_bounds_lanes_trimmed`, `fused_bounds`) against the JAX package's
Pallas kernels (interpret mode) and its XLA paths, with source-cluster
weights and gam_lb != gam_ub; `gamma_arrays` parity; and the bound property
lb <= exact SSE <= ub on random nodes.

Tolerance rtol 2e-4 / atol 2e-5 (tests/test_pallas_bounds.py): the sums
over source points run in another order on each side.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import bounds as jbounds
from fgoicp_tpu.ops import geometry as jgeo
from fgoicp_tpu.ops import pallas_bounds
from fgoicp_tpu.ops.pool_frontier import _eval_lanes_xla
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import coreset as tcoreset
from fgoicp_tpu_torch.ops import cuda_bounds
from fgoicp_tpu_torch.ops import geometry as tgeo
from fgoicp_tpu_torch.models import icp as ticp


def T(a):
    """A torch tensor holding a copy of a numpy or JAX array."""
    return torch.from_numpy(np.array(a))


def _lane_case(seed=7, g=4, lanes=16, ns=700, p=300):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    return dict(
        pcs=f32(rng.uniform(-0.7, 0.7, size=(ns, 3))),
        proxies=f32(rng.uniform(-0.9, 0.9, size=(p, 3))),
        xyz=f32(rng.uniform(-0.4, 0.4, size=(g, 3))),
        spans=f32(rng.uniform(0.05, 0.4, size=(g,))),
        fix=np.asarray([True, False, True, False][:g]),
        weights=f32(rng.integers(1, 6, size=(ns,))),
        deltas=f32(rng.uniform(0.0, 0.03, size=(ns,))),
        gids=rng.integers(0, g, size=(lanes,)).astype(np.int32),
        t=f32(rng.uniform(-0.4, 0.4, size=(lanes, 3))),
        tspan=f32(rng.uniform(0.05, 0.3, size=(lanes,))),
        slack=np.float32(0.03))


def _jax_inputs(c):
    R = jgeo.quat_cube_to_matrix(jnp.asarray(c["xyz"]))
    base = jnp.einsum("grc,nc->gnr", R, jnp.asarray(c["pcs"]),
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = jbounds.gamma_arrays(
        jnp.linalg.norm(jnp.asarray(c["pcs"]), axis=-1),
        jnp.asarray(c["spans"]), jnp.asarray(c["fix"]),
        point_deltas=jnp.asarray(c["deltas"]))
    gam_t = jgeo.translation_uncertainty_radius(jnp.asarray(c["tspan"]))
    return base, gam_ub, gam_lb, gam_t


def test_gamma_arrays_match_jax():
    c = _lane_case()
    _, gub_j, glb_j, _ = _jax_inputs(c)
    norms = torch.linalg.vector_norm(T(c["pcs"]), dim=-1)
    gub_t, glb_t = tbounds.gamma_arrays(norms, T(c["spans"]), T(c["fix"]),
                                        point_deltas=T(c["deltas"]))
    np.testing.assert_allclose(gub_t.numpy(), np.asarray(gub_j),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(glb_t.numpy(), np.asarray(glb_j),
                               rtol=1e-6, atol=1e-7)
    assert not np.allclose(gub_t.numpy(), glb_t.numpy())
    # Plain point sources: one radius, zero on fixed-rotation rows.
    g1, g2 = tbounds.gamma_arrays(norms, T(c["spans"]), T(c["fix"]))
    assert torch.equal(g1, g2)
    assert float(g1[T(c["fix"])].abs().max()) == 0.0


@pytest.mark.parametrize("weighted", [True, False])
def test_fused_lanes_plain_matches_pallas_and_xla(weighted):
    c = _lane_case()
    base, gam_ub, gam_lb, gam_t = _jax_inputs(c)
    w = c["weights"] if weighted else None
    lb_k, ub_k = pallas_bounds.fused_bounds_lanes(
        base, jnp.asarray(c["gids"]), jnp.asarray(c["t"]),
        jnp.asarray(c["proxies"]), gam_ub, gam_t, c["slack"],
        point_weights=None if w is None else jnp.asarray(w), gam_lb=gam_lb,
        interpret=True)
    backend = jbounds.ProxyBackend(coreset=jbounds.coreset_ops.ProxyCoreset(
        points=jnp.asarray(c["proxies"]), eps=jnp.float32(c["slack"])))
    lb_x, ub_x = _eval_lanes_xla(
        backend, base, jnp.asarray(c["gids"]), jnp.asarray(c["t"]), gam_ub,
        gam_lb, gam_t, None if w is None else jnp.asarray(w), None)

    before = cuda_bounds.fused_bounds_lanes.launches
    lb_t, ub_t = cuda_bounds.fused_bounds_lanes(
        T(base), T(c["gids"]), T(c["t"]), T(c["proxies"]),
        T(gam_ub), T(gam_t), float(c["slack"]),
        point_weights=None if w is None else T(w),
        gam_lb=T(gam_lb))
    assert cuda_bounds.fused_bounds_lanes.launches == before
    for ref_lb, ref_ub in ((lb_k, ub_k), (lb_x, ub_x)):
        np.testing.assert_allclose(ub_t.numpy(), np.asarray(ref_ub),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(lb_t.numpy(), np.asarray(ref_lb),
                                   rtol=2e-4, atol=2e-5)
    assert bool(torch.all(lb_t <= ub_t + 1e-5))


def _trimmed_lane_case(seed, g, lanes, ns, p, weights=None):
    """The inputs of tests/test_pallas_bounds.py's trimmed-kernel tests:
    plain sources (gam_lb == gam_ub), random lanes."""
    rng = np.random.default_rng(seed)
    pcs = jnp.asarray(rng.uniform(-0.7, 0.7, size=(ns, 3)), jnp.float32)
    proxies = jnp.asarray(rng.uniform(-0.9, 0.9, size=(p, 3)), jnp.float32)
    xyz = jnp.asarray(rng.uniform(-0.4, 0.4, size=(g, 3)), jnp.float32)
    R = jgeo.quat_cube_to_matrix(xyz)
    rot_spans = jnp.asarray(rng.uniform(0.05, 0.4, size=(g,)), jnp.float32)
    fix = jnp.asarray([True, False, True, False][:g])
    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)
    gam_ub, gam_lb = jbounds.gamma_arrays(jnp.linalg.norm(pcs, axis=-1),
                                          rot_spans, fix)
    gids = jnp.asarray(rng.integers(0, g, size=(lanes,)), jnp.int32)
    t_lanes = jnp.asarray(rng.uniform(-0.4, 0.4, size=(lanes, 3)),
                          jnp.float32)
    gam_t = jgeo.translation_uncertainty_radius(
        jnp.asarray(rng.uniform(0.05, 0.3, size=(lanes,)), jnp.float32))
    return base, gids, t_lanes, proxies, gam_ub, gam_lb, gam_t


@pytest.mark.parametrize("keep_of,search", [
    ("ns-1", "bare"), ("0.7ns", "bare"), ("ns/3", "bare"),
    ("ns-1", "buckets"), ("0.7ns", "buckets"), ("ns/3", "buckets")],
    ids=["ns-1", "0.7ns", "ns/3", "ns-1-buckets", "0.7ns-buckets",
         "ns/3-buckets"])
def test_fused_lanes_trimmed_plain_matches_pallas_and_xla(keep_of, search):
    """The trim_keep values of test_fused_lanes_trimmed_matches_xla_bracket:
    the plain version against the Pallas kernel and the XLA lane path,
    given bare proxies or their `ProxyBuckets` and the source order (as
    the pooled frontier gives them)."""
    ns = 700
    trim_keep = {"ns-1": ns - 1, "0.7ns": int(0.7 * ns), "ns/3": ns // 3}[
        keep_of]
    base, gids, t_l, prox, gam_ub, gam_lb, gam_t = _trimmed_lane_case(
        7, 4, 16, ns, 300)
    slack = jnp.float32(0.03)
    lb_k, ub_k = pallas_bounds.fused_bounds_lanes_trimmed(
        base, gids, t_l, prox, gam_ub, gam_t, slack, n_drop=ns - trim_keep,
        gam_lb=gam_lb, interpret=True)
    backend = jbounds.ProxyBackend(coreset=jbounds.coreset_ops.ProxyCoreset(
        points=prox, eps=slack))
    lb_x, ub_x = _eval_lanes_xla(backend, base, gids, t_l, gam_ub, gam_lb,
                                 gam_t, None, trim_keep)
    proxies, order = T(prox), None
    if search == "buckets":
        proxies = cuda_bounds.proxy_buckets(proxies)
        order = cuda_bounds.source_order(T(base)[0])
    before = cuda_bounds.fused_bounds_lanes_trimmed.launches
    lb_t, ub_t = cuda_bounds.fused_bounds_lanes_trimmed(
        T(base), T(gids), T(t_l), proxies, T(gam_ub), T(gam_t), float(slack),
        ns - trim_keep, gam_lb=T(gam_lb), point_order=order)
    assert cuda_bounds.fused_bounds_lanes_trimmed.launches == before
    for ref_lb, ref_ub in ((lb_k, ub_k), (lb_x, ub_x)):
        np.testing.assert_allclose(ub_t.numpy(), np.asarray(ref_ub),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(lb_t.numpy(), np.asarray(ref_lb),
                                   rtol=2e-4, atol=2e-5)
    assert bool(torch.all(lb_t <= ub_t + 1e-5))
    # Trimming removes something from every lane with positive terms.
    lb_u, ub_u = cuda_bounds.fused_bounds_lanes(
        T(base), T(gids), T(t_l), T(prox), T(gam_ub), T(gam_t), float(slack),
        gam_lb=T(gam_lb))
    assert bool(torch.all(ub_t <= ub_u)) and bool(torch.all(lb_t <= lb_u))


def test_fused_lanes_trimmed_weight_mask():
    """0/1 padding weights (test_fused_lanes_trimmed_weight_mask's case):
    the plain version equals the XLA path over the real points
    (trim_ns = the real count) and the Pallas kernel."""
    ns_real, pad = 500, 140
    ns = ns_real + pad
    base, gids, t_l, prox, gam_ub, gam_lb, gam_t = _trimmed_lane_case(
        8, 3, 8, ns, 256)
    w = np.ones(ns, np.float32)
    w[ns_real:] = 0.0
    slack, trim_keep = jnp.float32(0.02), 350
    lb_k, ub_k = pallas_bounds.fused_bounds_lanes_trimmed(
        base, gids, t_l, prox, gam_ub, gam_t, slack,
        n_drop=ns_real - trim_keep, point_weights=jnp.asarray(w),
        gam_lb=gam_lb, interpret=True)
    backend = jbounds.ProxyBackend(coreset=jbounds.coreset_ops.ProxyCoreset(
        points=prox, eps=slack))
    lb_x, ub_x = _eval_lanes_xla(backend, base, gids, t_l, gam_ub, gam_lb,
                                 gam_t, jnp.asarray(w), trim_keep,
                                 trim_ns=ns_real)
    lb_t, ub_t = cuda_bounds.fused_bounds_lanes_trimmed(
        T(base), T(gids), T(t_l), T(prox), T(gam_ub), T(gam_t), float(slack),
        ns_real - trim_keep, point_weights=T(w), gam_lb=T(gam_lb))
    for ref_lb, ref_ub in ((lb_k, ub_k), (lb_x, ub_x)):
        np.testing.assert_allclose(ub_t.numpy(), np.asarray(ref_ub),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(lb_t.numpy(), np.asarray(ref_lb),
                                   rtol=2e-4, atol=2e-5)


def _grid_case(seed=0, g=3, b=5, ns=700, p=300):
    """tests/test_pallas_bounds.py::_case."""
    rng = np.random.default_rng(seed)
    pcs = jnp.asarray(rng.uniform(-0.7, 0.7, size=(ns, 3)), jnp.float32)
    proxies = jnp.asarray(rng.uniform(-0.9, 0.9, size=(p, 3)), jnp.float32)
    xyz = jnp.asarray(rng.uniform(-0.4, 0.4, size=(g, 3)), jnp.float32)
    R = jgeo.quat_cube_to_matrix(xyz)
    rot_spans = jnp.asarray(rng.uniform(0.05, 0.4, size=(g,)), jnp.float32)
    fix = jnp.asarray([True, False, True][:g])
    tc = jnp.asarray(rng.uniform(-0.5, 0.5, size=(g, b, 3)), jnp.float32)
    ts = jnp.asarray(rng.uniform(0.05, 0.3, size=(g, b)), jnp.float32)
    return pcs, proxies, R, rot_spans, fix, tc, ts


@pytest.mark.parametrize("case", ["plain", "padding_mask", "clusters"])
def test_fused_grid_plain_matches_pallas_and_xla(case):
    """`fused_bounds` (the grid form) on the shapes of
    tests/test_pallas_bounds.py::_case: plain points, a 0/1 padding mask
    (test_fused_point_weights_mask_padding) and cluster weights with
    gam_lb != gam_ub."""
    ns = 600 if case == "padding_mask" else 700
    pcs, prox, R, rot_spans, fix, tc, ts = _grid_case(
        seed=1 if case == "padding_mask" else 0, ns=ns)
    rng = np.random.default_rng(3)
    w = deltas = None
    if case == "padding_mask":
        w = np.ones(ns, np.float32)
        w[500:] = 0.0
    elif case == "clusters":
        w = rng.integers(1, 6, size=(ns,)).astype(np.float32)
        deltas = rng.uniform(0.0, 0.03, size=(ns,)).astype(np.float32)
    slack = jnp.float32(0.01)
    gam_ub, gam_lb = jbounds.gamma_arrays(
        jnp.linalg.norm(pcs, axis=-1), rot_spans, fix,
        point_deltas=None if deltas is None else jnp.asarray(deltas))
    gam_t = jgeo.translation_uncertainty_radius(ts)
    base = jnp.einsum("grc,nc->gnr", R, pcs,
                      precision=jax.lax.Precision.HIGHEST)
    jw = None if w is None else jnp.asarray(w)
    lb_k, ub_k = pallas_bounds.fused_bounds(
        base, tc, prox, gam_ub, gam_t, slack, point_weights=jw,
        gam_lb=gam_lb, interpret=True)
    backend = jbounds.ProxyBackend(coreset=jbounds.coreset_ops.ProxyCoreset(
        points=prox, eps=slack))
    lb_x, ub_x = jbounds.evaluate_bounds(
        backend, pcs, R, rot_spans, fix, tc, ts, point_weights=jw,
        point_deltas=None if deltas is None else jnp.asarray(deltas))
    before = cuda_bounds.fused_bounds.launches
    lb_t, ub_t = cuda_bounds.fused_bounds(
        T(base), T(tc), T(prox), T(gam_ub), T(gam_t), float(slack),
        point_weights=None if w is None else T(w), gam_lb=T(gam_lb))
    assert cuda_bounds.fused_bounds.launches == before
    assert lb_t.shape == ub_t.shape == (3, 5)
    for ref_lb, ref_ub in ((lb_k, ub_k), (lb_x, ub_x)):
        np.testing.assert_allclose(ub_t.numpy(), np.asarray(ref_ub),
                                   rtol=2e-4, atol=2e-5)
        np.testing.assert_allclose(lb_t.numpy(), np.asarray(ref_lb),
                                   rtol=2e-4, atol=2e-5)
    assert bool(torch.all(lb_t <= ub_t + 1e-5))


def test_grid_and_trimmed_wrappers_check_shapes():
    base, gam = torch.zeros(2, 20, 3), torch.zeros(2, 20)
    prox = torch.ones(10, 3)
    lb, ub = cuda_bounds.fused_bounds(base, torch.zeros(2, 4, 3), prox, gam,
                                      torch.zeros(2, 4), 0.0)
    assert lb.shape == ub.shape == (2, 4)
    with pytest.raises(ValueError, match="gam_t"):
        cuda_bounds.fused_bounds(base, torch.zeros(2, 4, 3), prox, gam,
                                 torch.zeros(4), 0.0)
    with pytest.raises(ValueError, match="t_centers"):
        cuda_bounds.fused_bounds(base, torch.zeros(8, 3), prox, gam,
                                 torch.zeros(2, 4), 0.0)
    gids = torch.zeros(4, dtype=torch.int32)
    lb, ub = cuda_bounds.fused_bounds_lanes_trimmed(
        base, gids, torch.zeros(4, 3), prox, gam, torch.zeros(4), 0.0, 5)
    assert lb.shape == ub.shape == (4,)
    with pytest.raises(ValueError, match="proxies"):
        cuda_bounds.fused_bounds_lanes_trimmed(
            base, gids, torch.zeros(4, 3), torch.zeros(0, 3), gam,
            torch.zeros(4), 0.0, 5)


def test_fused_lanes_checks_shapes():
    c = _lane_case(g=2, lanes=4, ns=20, p=10)
    base = torch.zeros(2, 20, 3)
    gam = torch.zeros(2, 20)
    args = (base, T(c["gids"]), T(c["t"]), T(c["proxies"]), gam,
            torch.zeros(4), 0.0)
    lb, ub = cuda_bounds.fused_bounds_lanes(*args)
    assert lb.shape == (4,) and ub.shape == (4,)
    with pytest.raises(ValueError, match="gam_ub"):
        cuda_bounds.fused_bounds_lanes(base, *args[1:4], torch.zeros(3, 20),
                                       *args[5:])
    with pytest.raises(TypeError, match="gids"):
        cuda_bounds.fused_bounds_lanes(base, T(c["gids"]).long(), *args[2:])


def test_bounds_bracket_exact_sse_on_random_nodes():
    """lb <= SSE(R, t) for every pose inside a (rotation cube, translation
    cube) node, and SSE(R_center, t_center) <= ub — with a proxy coreset
    (eps > 0) and weighted source clusters (deltas > 0)."""
    rng = np.random.default_rng(5)
    tgt = T(rng.uniform(-1, 1, size=(900, 3)).astype(np.float32))
    src = T(rng.uniform(-0.8, 0.8, size=(400, 3)).astype(np.float32))
    backend = tbounds.make_backend(tgt, kind="proxy", proxy_size=128, seed=0)
    assert float(backend.coreset.eps) > 0
    cl = tcoreset.build_weighted(src, size=100, seed=2)
    g = 6
    xyz = T(rng.uniform(-0.4, 0.4, size=(g, 3)).astype(np.float32))
    spans = T(rng.uniform(0.02, 0.1, size=(g,)).astype(np.float32))
    R = tgeo.quat_cube_to_matrix(xyz)
    norms = torch.linalg.vector_norm(cl.reps, dim=-1)
    tc = T(rng.uniform(-0.3, 0.3, size=(g, 3)).astype(np.float32))
    tspan = T(rng.uniform(0.02, 0.1, size=(g,)).astype(np.float32))
    base = torch.einsum("grc,nc->gnr", R, cl.reps).contiguous()
    slack = float(backend.coreset.eps)
    gids = torch.arange(g, dtype=torch.int32)
    gam_t = tgeo.translation_uncertainty_radius(tspan)
    # Lower bound: free rotation within the cube.
    gub, glb = tbounds.gamma_arrays(norms, spans, torch.zeros(g, dtype=bool),
                                    point_deltas=cl.deltas)
    lb, _ = cuda_bounds.fused_bounds_lanes(
        base, gids, tc, backend.coreset.points, gub.contiguous(), gam_t,
        slack, point_weights=cl.weights, gam_lb=glb.contiguous())
    # Upper bound: the ub pass at the node center (fixed rotation).
    fub, flb = tbounds.gamma_arrays(norms, spans, torch.ones(g, dtype=bool),
                                    point_deltas=cl.deltas)
    _, ub = cuda_bounds.fused_bounds_lanes(
        base, gids, tc, backend.coreset.points, fub.contiguous(), gam_t,
        slack, point_weights=cl.weights, gam_lb=flb.contiguous())
    sse_c = ticp.exact_sse_batched(tgt, src, R, tc)
    assert bool(torch.all(sse_c <= ub * (1 + 1e-5) + 1e-5))
    for _ in range(8):
        dx = T(rng.uniform(-1, 1, size=(g, 3)).astype(np.float32))
        dt = T(rng.uniform(-1, 1, size=(g, 3)).astype(np.float32))
        Rr = tgeo.quat_cube_to_matrix(xyz + dx * spans[:, None])
        tr = tc + dt * tspan[:, None]
        sse = ticp.exact_sse_batched(tgt, src, Rr, tr)
        assert bool(torch.all(lb <= sse * (1 + 1e-5) + 1e-5))


def test_distance_estimates_bracket_target_distance():
    rng = np.random.default_rng(9)
    tgt = T(rng.uniform(-1, 1, size=(700, 3)).astype(np.float32))
    q = T(rng.uniform(-1.2, 1.2, size=(5, 40, 3)).astype(np.float32))
    backend = tbounds.make_backend(tgt, kind="proxy", proxy_size=64, seed=1)
    d_ub, d_lb = tbounds.distance_estimates(backend, q)
    assert d_ub.shape == (5, 40)
    diff = q.reshape(-1, 1, 3).double() - tgt.double()[None]
    d_true = diff.pow(2).sum(-1).min(dim=1).values.sqrt().reshape(5, 40)
    assert bool(torch.all(d_lb.double() <= d_true + 1e-6))
    assert bool(torch.all(d_true <= d_ub.double() + 1e-6))
    exact = tbounds.make_backend(tgt, kind="exact")
    assert float(exact.coreset.eps) == 0.0

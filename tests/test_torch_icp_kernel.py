"""The ICP iteration's kernels (`fgoicp_tpu_torch/csrc/icp_step.cu`, wrapper
`ops/cuda_icp.py`): `icp_align` and `icp_commit` around the NN query.

On the CPU: a numpy float32 mirror of the kernel's 3x3 recurrence (the
cofactor determinant and inverse, the rank guard's ridge, the Newton
steps' clamps, the Jacobi eigenvector of the reflection fix) against
`ops/procrustes.py::closest_rotation` and the JAX package's, on
`test_torch_ops.py`'s Procrustes cases; the block planner; the wrappers'
argument checks; CPU tensors take the plain versions (no launch, so the
request's summary reads no kernel iteration), which leave done lanes
untouched.

On the card (`card` tests, skipped without one; JAX is imported only by the
CPU tests' fixture, so `python -m pytest tests/test_torch_icp_kernel.py -q
-m card` runs them there): at the main paths' shapes, each iteration's
kernel step (align, NN, commit) against the plain step from the same
state, the whole `icp_batched` against its plain loop on the same CUDA
tensors, and 2 + 1 launches an iteration.  Tolerances and their reasons:
- R, t and the moved points per step within 2e-5 (atol): the kernel sums a
  lane's points in another order than torch.sum and cuBLAS's einsums
  (~1e-6 relative on coordinates of order 1), then the same recurrence;
- the per-step SSE within rtol 1e-4: the moved points differ by that
  rounding, and an NN winner may flip on a near tie;
- `done` equal except where the relative improvement lies within 1e-5 of
  the threshold, where that rounding may decide the loop guard;
- each lane's final SSE within rtol 1e-4 of the plain loop's, or lower;
  trimmed, within rtol 1e-2 or lower: the kept set switches with the
  points' rounding, so the two loops take steps of different sizes and
  stop at different iterations (1.1e-3 apart on the H100, either way).
"""
import numpy as np
import pytest
import torch

from fgoicp_tpu_torch.models import icp as ticp
from fgoicp_tpu_torch.ops import cuda_icp, cuda_nn
from fgoicp_tpu_torch.ops import procrustes as tproc
from fgoicp_tpu_torch.scripts import kernel_check as kc
from fgoicp_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32


# --- the kernel's 3x3 recurrence in numpy float32 ---------------------------

def _cofactors(a):
    """(cofactor matrix, det) of a row-major [9] float32, as `cofactors`."""
    c = np.empty(9, F)
    c[0] = a[4] * a[8] - a[5] * a[7]
    c[1] = a[5] * a[6] - a[3] * a[8]
    c[2] = a[3] * a[7] - a[4] * a[6]
    c[3] = a[2] * a[7] - a[1] * a[8]
    c[4] = a[0] * a[8] - a[2] * a[6]
    c[5] = a[1] * a[6] - a[0] * a[7]
    c[6] = a[1] * a[5] - a[2] * a[4]
    c[7] = a[2] * a[3] - a[0] * a[5]
    c[8] = a[0] * a[4] - a[1] * a[3]
    return c, (a[0] * c[0] + a[1] * c[1]) + a[2] * c[2]


def _smallest_eigvec(s):
    """`smallest_eigvec`: cyclic Jacobi (10 sweeps) on a symmetric [9]
    (theta overflows to inf on a denormal off-diagonal, t is then 0, as on
    the card)."""
    s = s.copy()
    v = np.eye(3, dtype=F).reshape(9)
    for _ in range(10):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            r = 3 - p - q
            apq = s[3 * p + q]
            if apq == 0:
                continue
            theta = (s[3 * q + q] - s[3 * p + p]) / (F(2) * apq)
            if abs(theta) > F(1e18):
                t = F(0.5) / theta
            else:
                t = F(1) / (abs(theta) + np.sqrt(theta * theta + F(1)))
                if theta < 0:
                    t = -t
            c = F(1) / np.sqrt(t * t + F(1))
            sn = t * c
            tau = sn / (F(1) + c)
            s[3 * p + p] -= t * apq
            s[3 * q + q] += t * apq
            s[3 * p + q] = s[3 * q + p] = 0
            g, h = s[3 * r + p], s[3 * r + q]
            s[3 * r + p] = s[3 * p + r] = g - sn * (h + g * tau)
            s[3 * r + q] = s[3 * q + r] = h + sn * (g - h * tau)
            for i in range(3):
                vg, vh = v[3 * i + p], v[3 * i + q]
                v[3 * i + p] = vg - sn * (vh + vg * tau)
                v[3 * i + q] = vh + sn * (vg - vh * tau)
    j = int(np.argmin([s[0], s[4], s[8]]))
    return v.reshape(3, 3)[:, j]


def _mirror_rotation(abt):
    """(Q, whether the reflection fix applied) of a [3, 3] cross-covariance:
    `closest_rotation` of csrc/icp_step.cu, one float32 op at a time."""
    m = np.ascontiguousarray(np.asarray(abt, F).T).reshape(9)
    ss = F(0)
    for e in m:
        ss = ss + e * e
    norm = max(np.sqrt(ss), F(1e-30))
    x = m / norm
    if abs(_cofactors(x)[1]) < F(1e-6):
        x[[0, 4, 8]] += F(1e-3)
    for _ in range(9):
        z = F(1) / np.cbrt(max(abs(_cofactors(x)[1]), F(1e-12)))
        z = min(max(z, F(1e-3)), F(1e6))
        zx = z * x
        c, d = _cofactors(zx)
        x = F(0.5) * (zx + c / d)
    q = x.reshape(3, 3)
    if _cofactors(x)[1] >= 0:
        return q, False
    a = (m / norm).reshape(3, 3)
    s = np.empty(9, F)
    for i in range(3):
        for j in range(3):
            s[3 * i + j] = (a[0, i] * a[0, j] + a[1, i] * a[1, j]) \
                + a[2, i] * a[2, j]
    with np.errstate(over="ignore"):
        v = _smallest_eigvec(s)
    refl = np.eye(3, dtype=F) - F(2) * v[:, None] * v[None, :]
    return (q @ refl).astype(F), True


def _mirror_procrustes(src, corr, w=None):
    """(R, t, fixed) of one lane: the kernel's centroids and centred
    cross-covariance (its sums in numpy's order), then the recurrence."""
    w = np.ones(len(src), F) if w is None else np.asarray(w, F)
    wsum = max(np.sum(w, dtype=F), F(1e-12))
    mu_s = np.sum(src * w[:, None], axis=0, dtype=F) / wsum
    mu_c = np.sum(corr * w[:, None], axis=0, dtype=F) / wsum
    a = (src - mu_s) * w[:, None]
    b = corr - mu_c
    q, fixed = _mirror_rotation((a.T @ b).astype(F))
    return q, (mu_c - q @ mu_s).astype(F), fixed


# --- CPU ------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_side():
    """test_torch_ops.py's Procrustes cases and the JAX package's procrustes
    module, imported here so that the card tests run without JAX."""
    import test_torch_ops
    from fgoicp_tpu.ops import procrustes as jproc
    return test_torch_ops._proc_case, jproc


def _proper(R, atol=1e-6):
    np.testing.assert_allclose(np.linalg.det(R.astype(np.float64)), 1.0,
                               atol=atol)


@pytest.mark.parametrize("kind", ["random", "planar", "weighted"])
def test_mirror_matches_procrustes(jax_side, kind):
    proc_case, jproc = jax_side
    src, corr = proc_case("planar" if kind == "planar" else "random",
                          seed=7 if kind == "weighted" else 4)
    mask = None
    if kind == "weighted":
        mask = (np.random.default_rng(8).uniform(size=src.shape[:2])
                > 0.3).astype(np.float32)
    R_t, t_t = tproc.procrustes(torch.from_numpy(src),
                                torch.from_numpy(corr),
                                mask=None if mask is None
                                else torch.from_numpy(mask))
    R_j, t_j = jproc.procrustes(src, corr, mask=mask)
    for g in range(src.shape[0]):
        R, t, _ = _mirror_procrustes(src[g], corr[g],
                                     None if mask is None else mask[g])
        _proper(R)
        for R_ref, t_ref in ((R_t[g].numpy(), t_t[g].numpy()),
                             (np.asarray(R_j[g]), np.asarray(t_j[g]))):
            np.testing.assert_allclose(R, R_ref, atol=1e-5)
            np.testing.assert_allclose(t, t_ref, atol=1e-5)


def test_mirror_reflection_fix_matches(jax_side):
    """test_torch_ops.py's reflection case: det(M) < 0 on half the
    matrices, where the fix (the Jacobi eigenvector) applies."""
    _, jproc = jax_side
    rng = np.random.default_rng(6)
    m = rng.normal(size=(10, 3, 3)).astype(np.float32)
    m[:, :, 0] *= np.sign(np.linalg.det(m))[:, None]
    m[::2, 0, :] *= -1
    R_t = tproc.closest_rotation(torch.from_numpy(m)).numpy()
    R_j = np.asarray(jproc.closest_rotation(m))
    fixed = []
    for g in range(len(m)):
        R, f = _mirror_rotation(m[g])
        fixed.append(f)
        _proper(R)
        np.testing.assert_allclose(R, R_t[g], atol=1e-5)
        np.testing.assert_allclose(R, R_j[g], atol=1e-5)
    assert fixed == [True, False] * 5


def test_mirror_collinear_is_a_proper_rotation(jax_side):
    """Rank-1 correspondences: any turn about the line is optimal, and
    which one the recurrence lands on follows the rounding noise of the
    covariance's zero singular values (the mirror's sums run in numpy's
    order, torch's in its own: ~2e-5 apart about the line).  So the mirror
    must give a proper rotation that maps the line onto its
    correspondences, as `test_procrustes_collinear_returns_a_proper_rotation`
    asks of the port."""
    proc_case, _ = jax_side
    for seed in (4, 5, 6):
        src, corr = proc_case("collinear", seed=seed)
        for g in range(src.shape[0]):
            R, t, _ = _mirror_procrustes(src[g], corr[g])
            _proper(R)
            assert np.abs(src[g] @ R.T + t - corr[g]).max() < 1e-2


@pytest.mark.parametrize("ns, threads", [
    (1, 32), (256, 32), (257, 64), (1024, 128), (2048, 256), (3037, 384),
    (8000, 1024), (10 ** 6, 1024)])
def test_block_threads(ns, threads):
    assert cuda_icp.block_threads(ns) == threads
    assert threads % 32 == 0 and 32 <= threads <= cuda_icp.MAX_THREADS


def _state(g, ns, nt=50, seed=0):
    """A loop state of G lanes on the CPU (ops/cuda_icp.py's arguments)."""
    rng = np.random.default_rng(seed)
    f32 = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    return dict(
        target=f32(nt, 3), cur=f32(g, ns, 3),
        idx=torch.from_numpy(rng.integers(0, nt, (g, ns)).astype(np.int32)),
        R=torch.eye(3).repeat(g, 1, 1), t=torch.zeros(g, 3),
        last_R=torch.eye(3).repeat(g, 1, 1), last_t=torch.zeros(g, 3),
        done=torch.arange(g) % 2 == 1, running=torch.zeros(1, dtype=torch.int32),
        sse=torch.full((g,), 5.0), last_sse=torch.full((g,), 9.0))


def _align(s, weights=None):
    cuda_icp.icp_align(s["target"], s["idx"], weights, s["done"], s["cur"],
                       s["R"], s["t"], s["last_R"], s["last_t"], s["running"])


@pytest.mark.parametrize("change, error", [
    (dict(cur=torch.zeros(4, 6)), ValueError),
    (dict(cur=torch.zeros(4, 0, 3)), ValueError),
    (dict(cur=torch.zeros(4, 6, 3, dtype=torch.float64)), TypeError),
    (dict(R=torch.eye(3).repeat(3, 1, 1)), ValueError),
    (dict(idx=torch.zeros(4, 6, dtype=torch.int64)), ValueError),
    (dict(idx=torch.zeros(4, 5, dtype=torch.int32)), ValueError),
    (dict(done=torch.zeros(4, dtype=torch.int32)), ValueError),
    (dict(running=torch.zeros(1)), ValueError),
    (dict(target=torch.zeros(0, 3)), ValueError),
], ids=["cur 2-D", "ns 0", "cur float64", "R lanes", "idx int64",
        "idx shape", "done int32", "running float", "target empty"])
def test_align_checks_its_arguments(change, error):
    s = {**_state(4, 6), **change}
    with pytest.raises(error, match="icp_align"):
        _align(s)


def test_commit_checks_its_arguments():
    s = _state(4, 6)
    for d2, w, error in ((torch.zeros(4), None, ValueError),
                         (torch.zeros(4, 6), torch.ones(4, 5), ValueError),
                         (torch.zeros(3, 6), None, ValueError),
                         (torch.zeros(4, 6, dtype=torch.float64), None,
                          TypeError)):
        with pytest.raises(error, match="icp_commit"):
            cuda_icp.icp_commit(d2, w, 0.01, s["done"], s["sse"],
                                s["last_sse"], s["running"])


def test_cpu_step_leaves_done_lanes_and_counts_running():
    """The plain versions move only the lanes not done, and commit counts
    the lanes still running; no launch is counted."""
    s = _state(6, 40)
    before = {k: v.clone() for k, v in s.items()}
    launches = (cuda_icp.icp_align.launches, cuda_icp.icp_commit.launches)
    _align(s, torch.rand(6, 40))
    done = before["done"]
    for key in ("cur", "R", "t"):
        assert torch.equal(s[key][done], before[key][done])
        assert not torch.equal(s[key][~done], before[key][~done])
    assert torch.equal(s["last_R"][~done], before["R"][~done])
    d2 = torch.rand(6, 40)
    cuda_icp.icp_commit(d2, None, 0.01, s["done"], s["sse"], s["last_sse"],
                        s["running"])
    assert torch.equal(s["sse"][done], before["sse"][done])
    assert torch.equal(s["sse"][~done], d2.sum(-1)[~done])
    assert torch.equal(s["last_sse"][~done], before["sse"][~done])
    # sse 5 -> ~20: no improvement, so every running lane is done.
    assert bool(s["done"].all()) and int(s["running"][0]) == 0
    assert (cuda_icp.icp_align.launches,
            cuda_icp.icp_commit.launches) == launches


def test_cpu_icp_counts_no_kernel_iteration():
    rng = np.random.default_rng(3)
    pct = torch.from_numpy(rng.normal(size=(200, 3)).astype(np.float32))
    pcs = pct[::4].clone() + 0.01
    R0 = torch.eye(3).repeat(3, 1, 1)
    t0 = torch.zeros(3, 3)
    _, (rec,) = _records(lambda: trace.entry("register")(
        lambda: ticp.icp_batched(pct, pcs, R0, t0, max_iter=30))())
    it = rec.counts["icp_iterations"]
    assert it > 0
    assert rec.launches["icp_align"] == rec.launches["icp_commit"] == 0
    assert (f"icp: icp_iterations {it}, on the kernels 0 (icp_commit "
            f"launches)") in trace.summary(rec)


def _records(fn):
    last = trace.requests()[-1].id if trace.requests() else 0
    out = fn()
    return out, [r for r in trace.requests() if r.id > last]


# --- the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the ICP kernels run only on the card")
    return torch.device("cuda")


def _curve(rng, n, noise=0.01):
    """The seeded asymmetric Lissajous curve (scripts/workloads.py)."""
    s = rng.uniform(0.0, 4.5, size=(n,))
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    return (pts + rng.normal(scale=noise, size=(n, 3))).astype(np.float32)


def _rotation(rng, angle):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    k = np.array([[0, -axis[2], axis[1]], [axis[2], 0, -axis[0]],
                  [-axis[1], axis[0], 0]])
    return (np.eye(3) + np.sin(angle) * k
            + (1 - np.cos(angle)) * k @ k).astype(np.float32)


# name -> (lanes, source points, target points, per-lane sources, weights,
# inactive lanes, trim_keep): the bunny seeding lanes on the 1,024-point
# coreset, the width-1 polish on the bunny target, the serving seeding (480
# lanes of 2,048 on the 4,096-point coreset) and polish (32 views of 8,000
# on the 6,000-point target), a ragged serving batch padded with 0-weight
# rows, lanes half inactive whose starts finish at different iterations, and
# a trimmed ICP (the mask as weights, the kept sum committed).
CASES = {
    "seeding 15x1024 on 1024": (15, 1024, 1024, False, False, 0, None),
    "polish 1x3037 on 17953": (1, 3037, 17953, False, False, 0, None),
    "serving seeding 480x2048 on 4096": (480, 2048, 4096, True, False, 0,
                                         None),
    "serving polish 32x8000 on 6000": (32, 8000, 6000, True, False, 0, None),
    "ragged 8x6000 weighted": (8, 6000, 6000, True, True, 0, None),
    "inactive and staggered 16x1024": (16, 1024, 4096, False, False, 8,
                                       None),
    "trimmed 16x1024 keep 700": (16, 1024, 4096, False, False, 0, 700),
}


def _case(dev, name, seed=0):
    """(pct, pcs, R0, t0, active, weights, trim_keep) on the card."""
    g, ns, nt, per_lane, weighted, inactive, trim = CASES[name]
    rng = np.random.default_rng(seed)
    cloud = _curve(rng, max(nt, ns) + 4000)
    pct = cloud[rng.choice(len(cloud), nt, replace=False)]
    srcs, weights = [], []
    for lane in range(g if per_lane else 1):
        pts = cloud[rng.choice(len(cloud), ns, replace=False)]
        w = np.ones(ns, np.float32)
        if weighted:
            real = int(rng.integers(ns // 2, ns + 1))
            pts[real:] = pts[0]
            w[real:] = 0
        R = _rotation(rng, 0.3)
        shift = rng.uniform(-0.05, 0.05, 3).astype(np.float32)
        srcs.append((pts - shift) @ R)
        weights.append(w)
    pcs = np.stack(srcs) if per_lane else srcs[0]
    # Starts from identity to ~0.6 rad: the lanes converge at different
    # iterations.
    R0 = np.stack([_rotation(rng, 0.6 * i / g) for i in range(g)])
    t0 = rng.uniform(-0.05, 0.05, size=(g, 3)).astype(np.float32)
    active = np.arange(g) >= inactive if inactive else np.ones(g, bool)
    if inactive:
        rng.shuffle(active)
    T = lambda a: torch.from_numpy(np.array(a)).to(dev)
    return (T(pct), T(pcs), T(R0), T(t0), T(active),
            T(np.stack(weights)) if weighted else None, trim)


THR = 1e-4


@pytest.mark.card
@pytest.mark.parametrize("name", list(CASES))
def test_card_steps_match_the_plain_step(card, name):
    """Each iteration from the plain loop's state: the kernel step against
    the plain step (module doc's tolerances)."""
    pct, pcs, R0, t0, active, w, trim = _case(card, name)
    state = kc.icp_state(pct, pcs, R0, t0, active)
    steps = 0
    while steps < 100 and int(state["running"][0]) > 0:
        k = {key: v.clone() for key, v in state.items()}
        kc.icp_step(k, pct, THR, w, trim)
        kc.icp_step(state, pct, THR, w, trim, kernels=False)
        torch.cuda.synchronize(card)
        for key in ("R", "t", "last_R", "last_t", "cur"):
            err = float(torch.max(torch.abs(k[key] - state[key])))
            assert err <= 2e-5, f"step {steps}: {key} differs by {err}"
        assert torch.equal(k["last_sse"], state["last_sse"])
        torch.testing.assert_close(k["sse"], state["sse"], rtol=1e-4,
                                   atol=0)
        rel = (state["last_sse"] - state["sse"]) / state["last_sse"]
        differ = k["done"] != state["done"]
        assert bool(torch.all(torch.abs(rel[differ] - THR) <= 1e-5)), (
            f"step {steps}: done differs away from the threshold")
        # Both sides go on from the plain state.
        running = int(state["running"][0])
        assert int(k["running"][0]) == int((~k["done"]).sum())
        assert running == int((~state["done"]).sum())
        steps += 1
    assert steps > 1


@pytest.mark.card
@pytest.mark.parametrize("name", list(CASES))
def test_card_icp_matches_the_plain_loop(card, name, monkeypatch):
    """The whole icp_batched on the kernels against its plain loop on the
    same CUDA tensors: each lane's SSE within the module doc's rtol or
    lower, the inactive lanes returned as given; 2 + 1 launches an
    iteration."""
    pct, pcs, R0, t0, active, w, trim = _case(card, name)
    run = lambda: ticp.icp_batched(pct, pcs, R0, t0, active=active,
                                   max_iter=100, convergence_threshold=THR,
                                   trim_keep=trim, point_weights=w)
    nn0 = cuda_nn.nn_argmin.launches
    (sse_k, R_k, t_k), (rec,) = _records(trace.entry("register")(run))
    torch.cuda.synchronize(card)
    it = rec.counts["icp_iterations"]
    assert it > 1
    assert rec.launches["icp_align"] == rec.launches["icp_commit"] == it
    assert f"icp_iterations {it}, on the kernels {it}" in trace.summary(rec)
    assert cuda_nn.nn_argmin.launches - nn0 == it + 1
    assert rec.host_reads == it + (it < 100)

    monkeypatch.setattr(cuda_icp, "icp_align", cuda_icp.icp_align_plain)
    monkeypatch.setattr(cuda_icp, "icp_commit", cuda_icp.icp_commit_plain)
    sse_p, R_p, t_p = run()
    torch.cuda.synchronize(card)
    on = active
    rtol = 1e-2 if trim else 1e-4
    assert bool(torch.all(sse_k[on] <= sse_p[on] * (1 + rtol))), (
        f"worst ratio {float(torch.max(sse_k[on] / sse_p[on]))}")
    assert torch.equal(R_k[~on], R0[~on]) and torch.equal(t_k[~on], t0[~on])
    assert torch.equal(sse_k[~on], sse_p[~on])


def _proc_lanes(rng, kind, g=6, n=80):
    """(src, corr) [g, n, 3]: test_torch_ops.py's Procrustes kinds in numpy,
    and `reflected` (corr a mirror image: det(M) < 0, the fix applies)."""
    if kind == "planar":
        src = rng.normal(size=(g, n, 3)) * np.asarray([1.0, 1.0, 0.0])
    elif kind == "collinear":
        src = rng.normal(size=(g, n, 1)) * np.asarray([0.3, -0.5, 0.8])
    else:
        src = rng.normal(size=(g, n, 3))
    R = np.stack([_rotation(rng, 0.5) for _ in range(g)])
    corr = np.einsum("grc,gnc->gnr", R, src) + rng.uniform(-1, 1, (g, 1, 3))
    if kind == "reflected":
        corr[..., 0] *= -1
    corr = corr + rng.normal(scale=1e-3, size=corr.shape)
    return src.astype(np.float32), corr.astype(np.float32)


@pytest.mark.card
@pytest.mark.parametrize("kind", ["random", "weighted", "planar",
                                  "reflected", "collinear"])
def test_card_align_on_procrustes_cases(card, kind):
    """One icp_align with the correspondences given (idx the identity)
    against the plain align: R within 2e-5, always a proper rotation; on
    collinear points (any turn about the line is optimal) the line mapped
    onto its correspondences."""
    rng = np.random.default_rng(12)
    src, corr = _proc_lanes(rng, kind)
    g, n = src.shape[:2]
    T = lambda a: torch.from_numpy(np.array(a)).to(card)
    w = T((rng.uniform(size=(g, n)) > 0.3).astype(np.float32)) \
        if kind == "weighted" else None
    outs = []
    for align in (cuda_icp.icp_align, cuda_icp.icp_align_plain):
        s = dict(cur=T(src), R=torch.eye(3, device=card).repeat(g, 1, 1),
                 t=torch.zeros(g, 3, device=card),
                 last_R=torch.zeros(g, 3, 3, device=card),
                 last_t=torch.zeros(g, 3, device=card))
        align(T(corr.reshape(-1, 3)),
              torch.arange(g * n, dtype=torch.int32, device=card).reshape(
                  g, n), w, torch.zeros(g, dtype=torch.bool, device=card),
              s["cur"], s["R"], s["t"], s["last_R"], s["last_t"],
              torch.zeros(1, dtype=torch.int32, device=card))
        outs.append({k: v.cpu().numpy() for k, v in s.items()})
    kern, plain = outs
    for g_ in range(g):
        _proper(kern["R"][g_])
    if kind == "collinear":
        assert np.abs(kern["cur"] - corr).max() < 1e-2
    else:
        np.testing.assert_allclose(kern["R"], plain["R"], atol=2e-5)
        np.testing.assert_allclose(kern["t"], plain["t"], atol=2e-5)
        np.testing.assert_allclose(kern["cur"], plain["cur"], atol=2e-5)

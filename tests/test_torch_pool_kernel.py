"""The pooled step's commit kernel (`fgoicp_tpu_torch/csrc/pool_step.cu`,
wrapper `ops/cuda_pool.py`): `pool_commit` against `pool_commit_plain`.

On the CPU: a numpy float32 mirror of the kernel's step (the (ub, lane)
keys of the incumbents, the twin share, the split, and the merge that
places every entry by facts (a)-(c) of the kernel's header: kept old
entries at (kept before) + 8 c, children at the histogram prefix + 8 q + j,
the rest in index order) against the plain commit's stable sort, bit for
bit, at every step of seeded searches (overflow, inactive groups, no twin
share, capacity below the lanes, more groups than lanes, a max_steps exit);
CPU tensors take the plain version (no launch); the wrapper's checks and
planner.

On the card (`card` tests, skipped without one; the file never imports
JAX, so `python -m pytest tests/test_torch_pool_kernel.py -q -m card` runs
them there): every step's kernel commit against the plain commit from the
same state, bit for bit: every field of the state, every slot of the pool
(the INVALID slots' gid, center and span too), the next lanes' inputs and
the live flag; at the search cell's shape (a search-only `GoICP` on the
smoke pair: G 256, L 1,024, CP 32,768, 1,024 source clusters), with the
trimmed lane kernel and the LUT per-point path, and on seeded pools that
overflow, hold inactive groups, take no twin share, have fewer slots than
lanes or more groups than lanes, stop at max_steps, or keep the kernel's
workspace in global memory (16,384 lanes); the whole search on the kernel
against the whole search on the plain commit, and one launch a step.
"""
import copy

import numpy as np
import pytest
import torch

from fgoicp_tpu_torch.config import EngineConfig
from fgoicp_tpu_torch.models.goicp import GoICP
from fgoicp_tpu_torch.ops import bounds as tbounds
from fgoicp_tpu_torch.ops import coreset as tcoreset
from fgoicp_tpu_torch.ops import cuda_bounds, cuda_pool
from fgoicp_tpu_torch.ops import geometry as geo
from fgoicp_tpu_torch.ops import pool_frontier as tpool
from fgoicp_tpu_torch.scripts import kernel_check as kc
from fgoicp_tpu_torch.scripts import workloads
from torch_threads import one_torch_thread  # noqa: F401

F = np.float32
U64 = np.uint64


def _problem(dev, seed=0, nt=400, ns=260, children=3, proxy=96,
             clusters=64, share=True):
    """bnb_r3_pooled's arguments on `dev`: a proxy backend on a uniform
    target, weighted clusters of a uniform source, 2 x `children` groups
    (the fixed-rotation ub pass, then the lb pass pointing at its twins)."""
    rng = np.random.default_rng(seed)
    T = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
    pct = T(rng.uniform(-0.8, 0.8, size=(nt, 3)).astype(F))
    pcs = T(rng.uniform(-0.6, 0.6, size=(ns, 3)).astype(F))
    backend = tbounds.make_backend(pct, kind="proxy", proxy_size=proxy)
    cl = tcoreset.build_weighted(pcs, size=clusters, seed=2)
    R = geo.quat_cube_to_matrix(
        T(rng.uniform(-0.5, 0.5, size=(children, 3)).astype(F)))
    twins = np.concatenate([np.full(children, -1), np.arange(children)])
    return dict(backend=backend, pcs=cl.reps.contiguous(),
                R=torch.cat([R, R]),
                rot_spans=torch.full((2 * children,), 0.125,
                                     dtype=torch.float32, device=dev),
                fix_rot=T(np.arange(2 * children) < children),
                point_weights=cl.weights, point_deltas=cl.deltas,
                err_share_from=T(twins.astype(np.int64)) if share else None,
                point_order=cuda_bounds.source_order(cl.reps))


def _search(args, best_sse=1e9, sse_threshold=1e-4, **kw):
    a = dict(args)
    return tpool.bnb_r3_pooled(
        a.pop("backend"), a.pop("pcs"), a.pop("R"), a.pop("rot_spans"),
        a.pop("fix_rot"), float(F(best_sse)), float(F(sse_threshold)),
        **a, **kw)


# name -> (problem keywords, search keywords): seeded pools that overflow
# (capacity G + 4), hold inactive groups under an incumbent, take no twin
# share, have fewer slots than lanes, more groups than lanes, or stop at
# max_steps.
CASES = {
    "twins": (dict(seed=0), dict(min_span=0.2, lanes=32, capacity=4096)),
    "overflow": (dict(seed=4), dict(lanes=8, capacity=10, max_steps=3000)),
    "inactive": (dict(seed=2), dict(
        lanes=32, capacity=4096, best_sse=5.0,
        group_active=[True, False, True, True, False, True])),
    "no share": (dict(seed=1, share=False),
                 dict(min_span=0.2, lanes=32, capacity=4096)),
    "capacity below lanes": (dict(seed=3), dict(lanes=64, capacity=40,
                                                max_steps=400)),
    "groups above lanes": (dict(seed=5, children=12),
                           dict(min_span=0.2, lanes=4, capacity=4096)),
    "max_steps": (dict(seed=6), dict(lanes=8, capacity=4096, max_steps=2)),
}


def _case(dev, name):
    prob_kw, kw = CASES[name]
    kw = dict(kw)
    if "group_active" in kw:
        kw["group_active"] = torch.tensor(kw["group_active"], device=dev)
    return _problem(dev, **prob_kw), kw


# --- the kernel's step in numpy float32 --------------------------------------

def _ord(x):
    """The orderable bits of float32 x as uint64 (csrc/pool_step.cu's ord)."""
    b = np.asarray(x, F).view(np.uint32).astype(U64)
    return np.where(b & U64(0x80000000), ~b & U64(0xFFFFFFFF),
                    b | U64(0x80000000))


def mirror_commit(s, lb_e, ub_e, share, min_span, thr):
    """The kernel's step on numpy copies: (state fields by name, lane_gid,
    gam_t, live).  Asserts fact (a) and that the ranks are a permutation."""
    n = lambda t: t.detach().cpu().numpy()
    lbs, gids, cen, spn = n(s.lbs), n(s.gids), n(s.centers), n(s.spans)
    be, bu, bt, act = n(s.best_err), n(s.best_ub), n(s.best_t), n(s.active)
    lb_e, ub_e = n(lb_e), n(ub_e)
    share = None if share is None else n(share)
    g, cp, nl = be.shape[0], lbs.shape[0], lb_e.shape[0]
    m = cp - nl
    inv, big = F(1e30), F(1e10)
    # 1-3: validity, the incumbents' keys, the twin share.
    pg, pl = gids[:nl], lbs[:nl]
    valid = (pl < inv) & (pl < be[pg]) & act[pg]
    lbm = np.where(valid, lb_e, big).astype(F)
    ubm = np.where(valid, ub_e, big).astype(F)
    lanes = np.arange(nl, dtype=U64)
    gkey = np.full(g, _ord(big) << U64(32), U64)
    gkey[pg[0]] = U64(2 ** 64 - 1)
    other = np.flatnonzero(pg != pg[0])
    if other.size:
        gkey[pg[0]] = (_ord(big) << U64(32)) | U64(other[0])
    np.minimum.at(gkey, pg, (_ord(ubm) << U64(32)) | lanes)
    arg = (gkey & U64(0xFFFFFFFF)).astype(np.int64)
    v = np.where(pg[arg] == np.arange(g), ubm[arg], big).astype(F)
    improve = act & (v < be)
    err1 = np.where(improve, v, be).astype(F)
    gerr = err1 if share is None else np.where(
        share >= 0, np.minimum(err1, err1[np.maximum(share, 0)]), err1)
    # 4: the split and the parents' sort.
    split = valid & (lbm < gerr[pg]) & (spn[:nl] >= F(min_span))
    keyc = np.where(split, lbm, inv).astype(F)
    pkept = (keyc < inv) & (keyc < gerr[pg]) & act[pg]
    pkey = np.sort(((_ord(keyc) << U64(32)) | lanes)[pkept])
    kpar = pkey.size
    place = np.full(nl, -1, np.int64)
    place[(pkey & U64(0xFFFFFFFF)).astype(np.int64)] = np.arange(kpar)
    nk = np.cumsum(~pkept) - ~pkept
    # 5: the old entries' ranks, then the children's.
    ol, og = lbs[nl:], gids[nl:]
    okept = (ol < inv) & (ol < gerr[og]) & act[og]
    keys = _ord(ol[okept]).astype(np.int64)
    assert np.all(np.diff(keys) >= 0), "fact (a): kept old entries unsorted"
    kold = int(okept.sum())
    n_valid = kold + 8 * kpar
    pre = np.cumsum(okept) - okept
    c = np.searchsorted(pkey, _ord(ol) << U64(32), side="left")
    r_old = np.where(okept, pre + 8 * c, n_valid + (np.arange(m) - pre))
    h = np.cumsum(np.bincount(c[okept], minlength=kpar + 1))
    j = np.arange(8)
    r_ch = np.where(pkept[:, None],
                    (h[np.maximum(place, 0)] + 8 * place)[:, None] + j,
                    (n_valid + (m - kold) + 8 * nk)[:, None] + j)
    ranks = np.concatenate([r_old, r_ch.reshape(-1)])
    assert np.array_equal(np.sort(ranks), np.arange(m + 8 * nl))
    half = (spn[:nl] * F(0.5)).astype(F)
    signs = np.array([[1 if (jj >> k) & 1 else -1 for k in range(3)]
                      for jj in range(8)], F)
    all_lb = np.concatenate([np.where(okept, ol, inv),
                             np.repeat(np.where(pkept, keyc, inv), 8)])
    all_gid = np.concatenate([og, np.repeat(pg, 8)])
    all_c = np.concatenate([cen[nl:], (cen[:nl, None, :] + signs[None]
                                       * half[:, None, None]).reshape(-1, 3)])
    all_s = np.concatenate([spn[nl:], np.repeat(half, 8)])
    kept = np.concatenate([okept, np.repeat(pkept, 8)])
    placed = {}
    for name, a in (("lbs", all_lb), ("gids", all_gid), ("centers", all_c),
                    ("spans", all_s), ("kept", kept)):
        placed[name] = np.empty_like(a)
        placed[name][ranks] = a
    out = {name: placed[name][:cp]
           for name in ("lbs", "gids", "centers", "spans")}
    minlb = np.full(g, inv, F)
    np.minimum.at(minlb, out["gids"], out["lbs"])
    rest = placed["kept"][cp:]
    gdrop = np.full(g, inv, F)
    np.minimum.at(gdrop, placed["gids"][cp:][rest], placed["lbs"][cp:][rest])
    active = act & ~(((gerr - minlb).astype(F) < F(thr)) | (minlb >= inv))
    out.update(
        best_err=gerr, best_ub=np.where(act, np.minimum(bu, v), bu),
        best_t=np.where(improve[:, None], cen[arg], bt), active=active,
        evaluated=n(s.evaluated) + np.bincount(pg[valid], minlength=g),
        dropped=n(s.dropped) + max(0, n_valid - cp),
        dropped_lb=np.minimum(n(s.dropped_lb), gdrop))
    lane_gid = out["gids"][:nl].astype(np.int32)
    gam_t = (F(geo.SQRT3) * out["spans"][:nl]).astype(F)
    return out, lane_gid, gam_t, int(active.any())


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint32) if a.dtype == F else a


def _same(got, want) -> bool:
    got, want = _bits(got), _bits(want)
    return got.shape == want.shape and np.array_equal(got, want)


@pytest.mark.parametrize("name", list(CASES))
def test_mirror_places_every_entry_as_the_plain_sort(name, monkeypatch):
    """At every step of the search the kernel's placement, mirrored in
    numpy, equals the plain commit's stable sort bit for bit: every field,
    every slot, the next lanes' inputs and the live flag."""
    args, kw = _case("cpu", name)
    plain = cuda_pool.pool_commit
    steps = []

    def commit(s, lb_e, ub_e, share, min_span, thr, buf):
        new = plain(s, lb_e, ub_e, share, min_span, thr, buf)
        want, lane_gid, gam_t, live = mirror_commit(s, lb_e, ub_e, share,
                                                    min_span, thr)
        for field, value in want.items():
            assert _same(getattr(new, field).numpy(), value), (
                f"step {new.steps}: {field}")
        assert _same(buf.lane_gid.numpy(), lane_gid)
        assert _same(buf.gam_t.numpy(), gam_t)
        assert int(buf.live[0]) == live
        steps.append((int(new.dropped), int((~new.active).sum())))
        return new

    monkeypatch.setattr(cuda_pool, "pool_commit", commit)
    launches = plain.launches
    st = _search(args, **kw)
    assert st.steps == len(steps) > 1
    assert plain.launches == launches
    if name == "overflow":
        assert steps[-1][0] > 0
    if name == "max_steps":
        assert st.steps == 2 and bool(st.active.any())


@pytest.mark.parametrize("shape", [(6, 64, 64, 60), (16, 64, 512, 300),
                                   (24, 8, 64, 60), (256, 1024, 4096, 3000)])
def test_mirror_on_seeded_mid_search_pools(shape):
    """The mirror against the plain commit on kernel_check's seeded pools
    (`pool_commit_args`: random groups, dominated entries, inactive
    groups, twins; every slot a lane and the children overflowing in the
    first)."""
    s, lb_e, ub_e, share, min_span, thr, buf = kc.pool_commit_args(
        *shape, "cpu")
    new = cuda_pool.pool_commit(s, lb_e, ub_e, share, min_span, thr, buf)
    want, lane_gid, gam_t, live = mirror_commit(s, lb_e, ub_e, share,
                                                min_span, thr)
    for field, value in want.items():
        assert _same(getattr(new, field).numpy(), value), field
    assert _same(buf.lane_gid.numpy(), lane_gid)
    assert _same(buf.gam_t.numpy(), gam_t)
    assert int(buf.live[0]) == live
    if shape[1] == shape[2]:
        assert int(new.dropped) > int(s.dropped)


def test_cpu_tensors_take_the_plain_commit():
    """On the CPU pool_commit is the plain version: no launch, the same
    state and buffers as pool_commit_plain."""
    args, kw = _case("cpu", "twins")
    before = cuda_pool.pool_commit.launches
    st = _search(args, **kw)
    assert cuda_pool.pool_commit.launches == before and st.steps > 1


def test_commit_checks_its_arguments():
    args, kw = _case("cpu", "max_steps")
    s0 = _search(args, **kw)
    buf = cuda_pool.CommitBuffers(s0, 8)
    lb = torch.zeros(8)
    cuda_pool.pool_commit(s0, lb, lb, None, 0.1, 1e-4, buf)
    with pytest.raises(ValueError, match="lb_e"):
        cuda_pool.pool_commit(s0, lb[:4], lb[:4], None, 0.1, 1e-4, buf)
    with pytest.raises(ValueError, match="share"):
        cuda_pool.pool_commit(s0, lb, lb, torch.zeros(2, dtype=torch.int32),
                              0.1, 1e-4, buf)
    with pytest.raises(ValueError, match="gids"):
        cuda_pool.pool_commit(s0._replace(gids=s0.gids.to(torch.int32)),
                              lb, lb, None, 0.1, 1e-4, buf)


def test_plan_and_workspace():
    assert cuda_pool.plan_cluster(32768, 1024) == 8
    assert cuda_pool.plan_cluster(40, 40) == 1
    assert cuda_pool.plan_cluster(4096 + 64, 64) == 1
    assert cuda_pool.plan_cluster(4096 + 65, 64) == 2
    # G 256, L 1,024 fits shared memory; 16,384 lanes do not.
    assert cuda_pool.workspace_bytes(256, 1024) == 31760
    assert cuda_pool.workspace_bytes(256, 1024) <= cuda_pool.SMEM_LIMIT
    assert cuda_pool.workspace_bytes(8, 16384) > cuda_pool.SMEM_LIMIT
    assert cuda_pool.workspace_bytes(1, 1) % 16 == 0


# --- the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: pool_commit runs only on the card")
    return torch.device("cuda")


class Stepper:
    """pool_commit's stand-in: each call commits on the kernel and on the
    plain version from the same state and holds every output bit for bit;
    the loop goes on from the kernel's state."""

    def __init__(self, kernel):
        self.kernel = kernel
        self.steps = 0
        self.shapes = set()
        self.dropped = 0

    # The wrapper counts its launches on the module attribute, this object
    # while it stands in: the count goes through to the kernel's.
    launches = property(lambda self: self.kernel.launches,
                        lambda self, n: setattr(self.kernel, "launches", n))

    def __call__(self, s, lb_e, ub_e, share, min_span, thr, buf):
        plain_buf = copy.copy(buf)
        for key in ("lane_gid", "gam_t", "live"):
            setattr(plain_buf, key, getattr(buf, key).clone())
        want = cuda_pool.pool_commit_plain(s, lb_e, ub_e, share, min_span,
                                           thr, plain_buf)
        got = self.kernel(s, lb_e, ub_e, share, min_span, thr, buf)
        for field in got._fields:
            a, b = getattr(got, field), getattr(want, field)
            assert (a == b if field == "steps" else torch.equal(a, b)), (
                f"step {self.steps}: {field}")
        for key in ("lane_gid", "gam_t", "live"):
            assert torch.equal(getattr(buf, key), getattr(plain_buf, key)), (
                f"step {self.steps}: {key}")
        self.steps += 1
        self.dropped = int(got.dropped)
        self.shapes.add((s.best_err.shape[0], lb_e.shape[0], s.lbs.shape[0]))
        return got


def _stepped(monkeypatch, run):
    stepper = Stepper(cuda_pool.pool_commit)
    before = cuda_pool.pool_commit.launches
    monkeypatch.setattr(cuda_pool, "pool_commit", stepper)
    try:
        out = run()
    finally:
        monkeypatch.undo()
    assert stepper.steps > 0
    assert cuda_pool.pool_commit.launches - before == stepper.steps
    return out, stepper


SPILL = (dict(seed=7, ns=520, clusters=128),
         dict(min_span=0.2, lanes=16384, capacity=32768, max_steps=6))


@pytest.mark.card
@pytest.mark.parametrize("name", [*CASES, "global workspace"])
def test_card_commit_matches_the_plain_commit(card, name, monkeypatch):
    """Every step's kernel commit against the plain commit from the same
    state (`Stepper`), then the whole search on the kernel against the whole
    search on the plain commit: equal final states, one launch a step."""
    if name == "global workspace":
        prob_kw, kw = SPILL
        args = _problem(card, **prob_kw)
        assert cuda_pool.workspace_bytes(6, 16384) > cuda_pool.SMEM_LIMIT
    else:
        args, kw = _case(card, name)
    _, stepper = _stepped(monkeypatch, lambda: _search(args, **kw))
    if name == "overflow":
        assert stepper.dropped > 0

    before = cuda_pool.pool_commit.launches
    got = _search(args, **kw)
    torch.cuda.synchronize(card)
    assert cuda_pool.pool_commit.launches - before == got.steps
    monkeypatch.setattr(cuda_pool, "pool_commit",
                        cuda_pool.pool_commit_plain)
    want = _search(args, **kw)
    for field in got._fields:
        a, b = getattr(got, field), getattr(want, field)
        assert (a == b if field == "steps" else torch.equal(a, b)), field


# name -> GoICP arguments on the card: the search cell's search-only engine
# on the smoke pair (G 256, L 1,024, CP 32,768, 1,024 source clusters), the
# trimmed search-only engine on the partial-overlap pair (the trimmed lane
# kernel), the LUT backend (the per-point path).
GOICP = {
    "search cell": lambda: (workloads.smoke_pair(), dict()),
    "trimmed": lambda: (workloads.trimmed_pair(), dict(trim_fraction=0.3)),
    "lut per-point": lambda: (workloads.smoke_pair(), dict(
        bound_backend="lut", lut_resolution=0.01)),
}


@pytest.mark.card
@pytest.mark.parametrize("name", list(GOICP))
def test_card_goicp_commits_match_the_plain_commit(card, name, monkeypatch):
    """A search-only GoICP whose every pooled step is held by `Stepper`;
    then its result on the kernel equals its result on the plain commit."""
    (pct, pcs, *_), kw = GOICP[name]()
    make = lambda: GoICP(pct, pcs, mse_threshold=1e-3, engine=EngineConfig(
        icp_multi_start=False, seed=0), device=card, **kw)
    _, stepper = _stepped(monkeypatch, lambda: make().run())
    if name == "search cell":
        assert (256, 1024, 32768) in stepper.shapes
    got = make().run()
    monkeypatch.setattr(cuda_pool, "pool_commit",
                        cuda_pool.pool_commit_plain)
    want = make().run()
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

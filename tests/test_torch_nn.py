"""Port parity: the plain torch nearest-neighbour versions of
fgoicp_tpu_torch/ops/cuda_nn.py against the JAX package's Pallas kernels
(pallas_nn.nn_argmin / nn_min in interpret mode) on the same numpy inputs.

Tolerance: idx must be equal (first index among ties) and d2 within
rtol 1e-6 / atol 1e-9 — both sides compute exact f32 direct differences.
Plain torch mirrors of the CUDA kernels' merge across target slices
(`nn_*_split_plain`, below) must equal the plain versions bit for bit, and
the planner must cut the targets into non-empty slices that cover them.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import pallas_nn
from fgoicp_tpu_torch.ops import cuda_nn, nn as tnn
from torch_threads import one_torch_thread  # noqa: F401


def _slices(t, splits):
    chunk = -(-t // splits)
    return [(lo, min(t, lo + chunk)) for lo in range(0, t, chunk)]


def _bits(x):
    """The int32 bit patterns of f32 values, as int64."""
    return x.view(torch.int32).to(torch.int64)


def nn_argmin_split_plain(queries, points, splits):
    """Plain torch mirror of csrc/nn.cu's merge across `splits` target
    slices (of ceil(T / splits) targets): each slice's plain argmin
    (d2, j) with d2 < BIG becomes the key (d2 bits << 32) | j, the keys'
    minimum starts from the key of (BIG, 0), and is unpacked into (d2, idx
    clamped to T - 1)."""
    m, t = queries.shape[0], points.shape[0]
    big = _bits(torch.tensor([cuda_nn.BIG], dtype=torch.float32))
    keys = (big << 32).expand(m)
    for lo, hi in _slices(t, splits):
        d2, j = cuda_nn.nn_argmin_plain(queries, points[lo:hi])
        part = (_bits(d2) << 32) | (j.to(torch.int64) + lo)
        keys = torch.where(d2 < cuda_nn.BIG, torch.minimum(keys, part), keys)
    d2 = (keys >> 32).to(torch.int32).view(torch.float32)
    idx = torch.clamp(keys & 0xFFFFFFFF, max=t - 1).to(torch.int32)
    return d2, idx


def nn_min_split_plain(queries, points, splits):
    """Plain torch mirror of `nn_min`'s merge: the minimum of the slices'
    d2 bit patterns below BIG's, from BIG's."""
    m, t = queries.shape[0], points.shape[0]
    bits = _bits(torch.full((m,), cuda_nn.BIG, dtype=torch.float32))
    for lo, hi in _slices(t, splits):
        d2 = cuda_nn.nn_min_plain(queries, points[lo:hi])
        bits = torch.where(d2 < cuda_nn.BIG, torch.minimum(bits, _bits(d2)),
                           bits)
    return bits.to(torch.int32).view(torch.float32)


def _grid_with_duplicates():
    """An 8x8x8 integer grid listed twice (512 + 512 targets: the copies
    sit in different 512-wide Pallas target tiles), queried at the grid
    points and at midpoints between neighbours — exact ties everywhere."""
    grid = np.mgrid[0:8, 0:8, 0:8].reshape(3, -1).T.astype(np.float32)
    points = np.concatenate([grid, grid])
    queries = np.concatenate([grid, grid + np.float32(0.5),
                              grid + np.asarray([0.5, 0, 0], np.float32)])
    return np.ascontiguousarray(queries), np.ascontiguousarray(points)


def _case(name):
    rng = np.random.default_rng(0)
    if name == "733x517":
        return (rng.uniform(-1, 1, size=(733, 3)).astype(np.float32),
                rng.uniform(-1, 1, size=(517, 3)).astype(np.float32))
    if name == "crosses_target_tiles":
        return (rng.uniform(-1, 1, size=(300, 3)).astype(np.float32),
                rng.uniform(-1, 1, size=(1700, 3)).astype(np.float32))
    return _grid_with_duplicates()


CASES = ["733x517", "crosses_target_tiles", "duplicated_grid", "far_away"]
# Each case whole (the ids the tests had before target slices), and cut
# into 3 and 7 target slices through the plain mirror of the kernels' merge.
SPLIT_CASES = [pytest.param(name, splits, id=name if splits == 1
                            else f"{name}-splits{splits}")
               for name in CASES for splits in (1, 3, 7)]


def _far_away():
    """Every distance above BIG (queries ~3.5e5 from the points, and from
    the Pallas kernels' 1e6 padding): the kernels return (BIG, 0)."""
    rng = np.random.default_rng(4)
    queries = rng.uniform(-1, 1, size=(70, 3)) - 2e5
    points = rng.uniform(-1, 1, size=(300, 3))
    return queries.astype(np.float32), points.astype(np.float32)


@functools.cache
def _pallas(name, want_idx):
    queries, points = _far_away() if name == "far_away" else _case(name)
    fn = pallas_nn.nn_argmin if want_idx else pallas_nn.nn_min
    out = fn(jnp.asarray(queries), jnp.asarray(points), interpret=True)
    return queries, points, tuple(map(np.asarray, out)) if want_idx \
        else np.asarray(out)


@pytest.mark.parametrize("name,splits", SPLIT_CASES)
def test_nn_argmin_matches_pallas(name, splits):
    queries, points, (d2_j, idx_j) = _pallas(name, True)
    q, p = torch.from_numpy(queries), torch.from_numpy(points)
    before = cuda_nn.nn_argmin.launches
    d2_t, idx_t = cuda_nn.nn_argmin(q, p)
    assert cuda_nn.nn_argmin.launches == before  # CPU: plain version only
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    d2_s, idx_s = nn_argmin_split_plain(q, p, splits)
    assert torch.equal(d2_s, d2_t) and torch.equal(idx_s, idx_t)
    np.testing.assert_array_equal(idx_t.numpy(), idx_j)
    np.testing.assert_allclose(d2_t.numpy(), d2_j, rtol=1e-6, atol=1e-9)
    if name == "far_away":
        assert bool(torch.all(d2_t == cuda_nn.BIG)) and not idx_t.any()


@pytest.mark.parametrize("name,splits", SPLIT_CASES)
def test_nn_min_matches_pallas(name, splits):
    queries, points, d2_j = _pallas(name, False)
    q, p = torch.from_numpy(queries), torch.from_numpy(points)
    before = cuda_nn.nn_min.launches
    d2_t = cuda_nn.nn_min(q, p)
    assert cuda_nn.nn_min.launches == before
    assert torch.equal(nn_min_split_plain(q, p, splits), d2_t)
    np.testing.assert_allclose(d2_t.numpy(), d2_j, rtol=1e-6, atol=1e-9)


PLAN_SHAPES = [
    # (M, T, SMs, how many slices)
    (3000, 18000, 132, "several"),      # the width-1 polish: 6 query tiles
    (10000, 20000, 132, "several"),     # the trimmed polish
    (48000, 18000, 132, "several"),     # the exact rescore
    (48000, 1024, 132, "several"),      # seeding lanes on the coreset
    (300000, 18000, 132, "one"),        # 586 query tiles fill the card
    (160000, 20000, 78, "one"),         # the same on a smaller card
    (1, 1, 132, "one"),
    (1, 1025, 132, "several"),
    (129, 2049, 132, "several"),
    (127, 127, 132, "one"),             # shorter than one slice
    (2 ** 31 - 1, 5, 132, "one"),       # the largest M the wrappers admit
]


@pytest.mark.parametrize("m,t,sms,want", PLAN_SHAPES,
                         ids=[f"{m}x{t}@{s}" for m, t, s, _ in PLAN_SHAPES])
def test_plan_splits_cover_the_targets(m, t, sms, want):
    splits, chunk = cuda_nn.plan_splits(m, t, sms)
    assert (splits == 1) == (want == "one")
    assert 1 <= splits <= cuda_nn.MAX_SPLITS
    # Non-empty slices [s * chunk, min(t, (s + 1) * chunk)) cover [0, T).
    assert (splits - 1) * chunk < t <= splits * chunk
    assert _slices(t, splits) == [
        (s * chunk, min(t, (s + 1) * chunk)) for s in range(splits)]
    if splits > 1:
        assert chunk >= cuda_nn.MIN_SLICE
        tiles = -(-m // cuda_nn.QUERY_TILE)
        # No more than 4 x FILL blocks a SM, and at least one block on
        # every SM unless the slices are as short as they may be.
        assert tiles * splits <= 4 * cuda_nn.FILL * sms + tiles
        assert tiles * splits >= sms or chunk < 2 * cuda_nn.MIN_SLICE


@pytest.mark.parametrize("m", [1, 127, 129])
@pytest.mark.parametrize("t", [1, 1023, 1025, 2049])
def test_planned_merge_equals_plain(m, t):
    """The merge at the planner's slices for a 132-SM card keeps every value
    and index of the plain versions (the edge shapes kernel_check runs on
    the card)."""
    rng = np.random.default_rng(m * 7919 + t)
    q = torch.from_numpy(rng.uniform(-1, 1, (m, 3)).astype(np.float32))
    p = torch.from_numpy(rng.uniform(-1, 1, (t, 3)).astype(np.float32))
    splits, _ = cuda_nn.plan_splits(m, t, 132)
    d2, idx = cuda_nn.nn_argmin_plain(q, p)
    d2_s, idx_s = nn_argmin_split_plain(q, p, splits)
    assert torch.equal(d2_s, d2) and torch.equal(idx_s, idx)
    assert torch.equal(nn_min_split_plain(q, p, splits), d2)


@pytest.mark.parametrize("splits", [2, 5, 8, 1024])
def test_split_merge_picks_first_index(splits):
    """Ties across slices: the two copies of the grid (and the neighbours a
    midpoint query ties with) fall in different slices; the merge keeps the
    first index, as the plain version does."""
    queries, points = _grid_with_duplicates()
    q, p = torch.from_numpy(queries), torch.from_numpy(points)
    d2, idx = nn_argmin_split_plain(q, p, splits)
    np.testing.assert_array_equal(idx[:512].numpy(), np.arange(512))
    np.testing.assert_array_equal(d2[:512].numpy(), 0.0)
    assert int(idx.max()) < 512
    whole = cuda_nn.nn_argmin_plain(q, p)
    assert torch.equal(d2, whole[0]) and torch.equal(idx, whole[1])


def test_duplicated_grid_picks_first_index():
    queries, points = _grid_with_duplicates()
    d2, idx = cuda_nn.nn_argmin(torch.from_numpy(queries),
                                torch.from_numpy(points))
    # Exact hits resolve to the first copy, never the second.
    np.testing.assert_array_equal(idx[:512].numpy(), np.arange(512))
    np.testing.assert_array_equal(d2[:512].numpy(), 0.0)
    assert int(idx.max()) < 512


def test_plain_chunking_keeps_ties_and_values(monkeypatch):
    """Query chunks of the plain version do not change any result."""
    queries, points = _grid_with_duplicates()
    q, p = torch.from_numpy(queries), torch.from_numpy(points)
    whole = cuda_nn.nn_argmin_plain(q, p)
    monkeypatch.setattr(cuda_nn, "_PLAIN_BLOCK", 3 * len(points) + 1)
    chunked = cuda_nn.nn_argmin_plain(q, p)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])
    assert torch.equal(cuda_nn.nn_min_plain(q, p), whole[0])


def test_nn_wrappers_check_arguments():
    q = torch.zeros(4, 3)
    with pytest.raises(TypeError, match="float32"):
        cuda_nn.nn_min(q.double(), q)
    with pytest.raises(ValueError, match="contiguous"):
        cuda_nn.nn_argmin(torch.zeros(3, 4).T, q)
    with pytest.raises(ValueError, match=r"\[T>0, 3\]"):
        cuda_nn.nn_min(q, torch.zeros(0, 3))


def test_exact_sse_matches_direct_sum():
    rng = np.random.default_rng(3)
    pct = torch.from_numpy(rng.uniform(-1, 1, (400, 3)).astype(np.float32))
    pcs = torch.from_numpy(rng.uniform(-1, 1, (90, 3)).astype(np.float32))
    R = torch.eye(3)
    t = torch.tensor([0.1, -0.2, 0.05])
    q = (pcs @ R.T + t).double()
    ref = (q[:, None] - pct.double()[None]).pow(2).sum(-1).min(dim=1).values.sum()
    np.testing.assert_allclose(float(tnn.exact_sse(pct, pcs, R, t)),
                               float(ref), rtol=1e-5)
    # Trimmed: the keep = round(ns * 0.9) smallest residuals, as the JAX
    # package sums them.
    from fgoicp_tpu.ops import nn as jnn
    want = jnn.exact_sse(pct.numpy(), pcs.numpy(), R.numpy(), t.numpy(),
                         trim_fraction=0.1)
    got = tnn.exact_sse(pct, pcs, R, t, trim_fraction=0.1)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    d2 = (q[:, None] - pct.double()[None]).pow(2).sum(-1).min(dim=1).values
    np.testing.assert_allclose(float(got),
                               float(torch.sort(d2).values[:81].sum()),
                               rtol=1e-5)

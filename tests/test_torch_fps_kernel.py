"""The FPS kernel (`fgoicp_tpu_torch/csrc/fps.cu`, wrapper
`ops/cuda_fps.py`).

On the CPU: a CPU tensor takes the plain loop (no launch counted; its
indices equal the JAX package's, `test_torch_ops.py`), the wrapper's
argument checks, the layout planner at its boundaries, and a numpy mirror
of the kernel's step (thread t owns the points i = t mod 1,024, keeps the
first of its equal maxima, then the largest 64-bit key (bits(m) << 32) |
(0xFFFFFFFF - i) wins) equal to the plain loop on ties, duplicates and
the edge cases of k and the seed.

On the card (`card` tests, skipped without one; no JAX is imported, so
`python -m pytest tests/test_torch_fps_kernel.py -q` runs them there): the
kernel's indices equal the plain loop's on the same CUDA tensors, bit for
bit, at the main paths' shapes, on either side of each layout boundary and
at the edge cases; one launch a call.
"""
import numpy as np
import pytest
import torch

from fgoicp_tpu_torch.ops import coreset, cuda_fps
from fgoicp_tpu_torch.utils import trace
from torch_threads import one_torch_thread  # noqa: F401

# (n, k) of the main paths: the bunny proxies (17,953 -> 1,024) and
# clusters (3,037 -> 1,024), a serving fallback's clusters (8,000 -> 2,048),
# the serving seeding coreset (6,000 -> 4,096) and fallback proxy (6,000 ->
# 1,024).
MAIN_SHAPES = ((17953, 1024), (3037, 1024), (8000, 2048), (6000, 4096),
               (6000, 1024))
SHARED_MAX = cuda_fps.SMEM_LIMIT // 16    # 14,496
MINIMA_MAX = cuda_fps.SMEM_LIMIT // 4     # 57,984


def _cloud(seed, n):
    """A noisy closed curve, as `test_torch_ops.py`'s FPS clouds."""
    rng = np.random.default_rng(seed)
    s = rng.uniform(0.0, 4.5, size=(n,))
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    return (pts + rng.normal(scale=0.01, size=(n, 3))).astype(np.float32)


def _grid_twice():
    """A 4 x 4 x 4 grid and its copy: every distance ties with a copy's."""
    grid = np.mgrid[0:4, 0:4, 0:4].reshape(3, -1).T.astype(np.float32)
    return np.ascontiguousarray(np.concatenate([grid, grid]))


# (name, points, k, seed): ties, duplicates and the edges of k and the seed.
def _edge_cases():
    curve = _cloud(4, 300)
    return [
        ("grid ties", _grid_twice(), 100, 3),
        ("all equal", np.ones((50, 3), np.float32), 7, 2),
        ("k 1", curve, 1, 5),
        ("k n", curve, 300, 0),
        ("k > n", curve[:40], 55, 1),
        ("seed >= n", curve, 64, 3 * 300 + 17),
        ("one point", curve[:1], 4, 9),
        ("n 1025", _cloud(5, 1025), 200, 1),
        # Each point's copy 1,024 rows on: ties inside one thread's points.
        ("copies a thread apart", np.concatenate([_cloud(8, 1024)] * 2),
         300, 6),
    ]


def _kernel_mirror(points, k, seed):
    """The kernel's algorithm in numpy float32: minima from +inf, each step
    every thread's first maximum, then the largest key."""
    n = len(points)
    start = seed % n
    threads = cuda_fps.THREADS
    rows = -(-n // threads)
    mind = np.full(n, np.inf, np.float32)
    idx = [start]
    c = start
    for _ in range(1, k):
        d = points - points[c]
        d2 = d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1] + d[:, 2] * d[:, 2]
        mind = np.minimum(mind, d2)
        # [rows, threads]: row j of column t is point j * threads + t.
        grid = np.full(rows * threads, -1.0, np.float32)
        grid[:n] = mind
        grid = grid.reshape(rows, threads)
        j = np.argmax(grid, axis=0)          # each thread's first maximum
        best = grid[j, np.arange(threads)]
        i = j * threads + np.arange(threads)
        keys = np.where(
            best < 0, np.uint64(0),
            (best.view(np.uint32).astype(np.uint64) << np.uint64(32))
            | (np.uint64(0xFFFFFFFF) - i.astype(np.uint64)))
        c = int(0xFFFFFFFF - (int(keys.max()) & 0xFFFFFFFF))
        idx.append(c)
    return np.array(idx, np.int64)


def _plain(points, k, seed):
    return cuda_fps.farthest_point_sample_plain(
        torch.from_numpy(points), k, seed).numpy()


# --- CPU ---------------------------------------------------------------

def test_cpu_tensor_takes_the_plain_loop():
    pts = torch.from_numpy(_cloud(1, 900))
    before = cuda_fps.farthest_point_sample.launches
    got = trace.entry("register")(
        lambda: coreset.farthest_point_sample(pts, 70, 11))()
    rec = trace.requests()[-1]
    assert torch.equal(got, cuda_fps.farthest_point_sample_plain(pts, 70, 11))
    assert got.dtype == torch.int64 and int(got[0]) == 11
    assert cuda_fps.farthest_point_sample.launches == before
    assert rec.counts["fps_steps"] == 69
    assert rec.launches["farthest_point_sample"] == 0


@pytest.mark.parametrize("points, k, error", [
    (torch.zeros(10, 3, dtype=torch.float64), 4, TypeError),
    (torch.zeros(3, 10).t(), 4, ValueError),            # not contiguous
    (torch.zeros(10, 2), 4, ValueError),
    (torch.zeros(10), 4, ValueError),
    (torch.zeros(0, 3), 4, ValueError),
    (torch.zeros(10, 3), 0, ValueError),
    (torch.zeros(10, 3), -2, ValueError),
], ids=["float64", "non-contiguous", "[n, 2]", "[n]", "n 0", "k 0", "k -2"])
def test_wrapper_checks_its_arguments(points, k, error):
    with pytest.raises(error, match="farthest_point_sample"):
        cuda_fps.farthest_point_sample(points, k)


@pytest.mark.parametrize("n, layout", [
    (1, "shared"), (SHARED_MAX, "shared"), (SHARED_MAX + 1, "minima"),
    (17953, "minima"), (MINIMA_MAX, "minima"), (MINIMA_MAX + 1, "global"),
    (10 ** 6, "global")])
def test_layout_planner_boundaries(n, layout):
    assert (SHARED_MAX, MINIMA_MAX) == (14496, 57984)
    assert cuda_fps.plan_layout(n) == layout
    assert n * cuda_fps.LAYOUTS[layout][1] <= cuda_fps.SMEM_LIMIT


@pytest.mark.parametrize("case", _edge_cases(), ids=lambda c: c[0])
def test_kernel_mirror_equals_the_plain_loop(case):
    _, points, k, seed = case
    np.testing.assert_array_equal(_kernel_mirror(points, k, seed),
                                  _plain(points, k, seed))


def test_plain_loop_edges():
    """What the kernel must reproduce at the edges: k > n repeats index 0
    once every point is picked, and the start is seed % n."""
    pts = _cloud(6, 40)
    idx = _plain(pts, 55, 1)
    assert sorted(idx[:40]) == list(range(40)) and set(idx[40:]) == {0}
    assert _plain(pts, 1, 83).tolist() == [83 % 40]


# --- the card ------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card: the FPS kernel runs only on the card")
    return torch.device("cuda")


def _same_on_card(dev, points, k, seed):
    p = torch.from_numpy(points).to(dev)
    got = cuda_fps.farthest_point_sample(p, k, seed)
    want = cuda_fps.farthest_point_sample_plain(p, k, seed)
    torch.cuda.synchronize(dev)
    assert got.shape == (k,) and got.dtype == torch.int64
    assert torch.equal(got, want), (
        f"{int((got != want).sum())} of {k} indices differ, first at "
        f"{int(torch.nonzero(got != want)[0])}")


@pytest.mark.card
@pytest.mark.parametrize("n, k", MAIN_SHAPES)
def test_card_main_shapes(card, n, k):
    _same_on_card(card, _cloud(n, n), k, 0)


@pytest.mark.card
@pytest.mark.parametrize("n", [SHARED_MAX, SHARED_MAX + 1, MINIMA_MAX,
                               MINIMA_MAX + 1])
def test_card_layout_boundaries(card, n):
    _same_on_card(card, _cloud(n, n), 300, n - 5)


@pytest.mark.card
@pytest.mark.parametrize("case", _edge_cases(), ids=lambda c: c[0])
def test_card_edge_cases(card, case):
    _, points, k, seed = case
    _same_on_card(card, points, k, seed)


@pytest.mark.card
def test_card_one_launch_a_call(card):
    p = torch.from_numpy(_cloud(7, 3037)).to(card)
    before = cuda_fps.farthest_point_sample.launches
    trace.entry("register")(
        lambda: coreset.farthest_point_sample(p, 1024, 2))()
    rec = trace.requests()[-1]
    assert cuda_fps.farthest_point_sample.launches == before + 1
    assert rec.launches["farthest_point_sample"] == 1
    assert rec.counts["fps_steps"] == 1023

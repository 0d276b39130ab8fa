"""Port parity: the plain torch nearest-neighbour versions of
fgoicp_tpu_torch/ops/cuda_nn.py against the JAX package's Pallas kernels
(pallas_nn.nn_argmin / nn_min in interpret mode) on the same numpy inputs.

Tolerance: idx must be equal (first index among ties) and d2 within
rtol 1e-6 / atol 1e-9 — both sides compute exact f32 direct differences.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.ops import pallas_nn
from fgoicp_tpu_torch.ops import cuda_nn, nn as tnn


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


CASES = ["733x517", "crosses_target_tiles", "duplicated_grid"]


@pytest.mark.parametrize("name", CASES)
def test_nn_argmin_matches_pallas(name):
    queries, points = _case(name)
    d2_j, idx_j = pallas_nn.nn_argmin(jnp.asarray(queries),
                                      jnp.asarray(points), interpret=True)
    before = cuda_nn.nn_argmin.launches
    d2_t, idx_t = cuda_nn.nn_argmin(torch.from_numpy(queries),
                                    torch.from_numpy(points))
    assert cuda_nn.nn_argmin.launches == before  # CPU: plain version only
    assert idx_t.dtype == torch.int32 and d2_t.dtype == torch.float32
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j),
                               rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", CASES)
def test_nn_min_matches_pallas(name):
    queries, points = _case(name)
    d2_j = pallas_nn.nn_min(jnp.asarray(queries), jnp.asarray(points),
                            interpret=True)
    before = cuda_nn.nn_min.launches
    d2_t = cuda_nn.nn_min(torch.from_numpy(queries), torch.from_numpy(points))
    assert cuda_nn.nn_min.launches == before
    np.testing.assert_allclose(d2_t.numpy(), np.asarray(d2_j),
                               rtol=1e-6, atol=1e-9)


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

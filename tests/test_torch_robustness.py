"""Edge cases and input validation of the port: the counterparts of the JAX
package's tests/test_robustness.py, each run on the CPU (the reference
exits or crashes on most of these; SURVEY §5 'failure detection: none').

They pin behavior the port already has: bad shapes, too few points and
non-finite values raise ValueError (in GoICP and in RegistrationService's
target), a collinear ICP source gives a finite proper rotation, Procrustes
on identical points stays finite, identical clouds register to the
identity, and the subsample extremes keep 10 and 0 points.
"""
import dataclasses

import numpy as np
import pytest
import torch

from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch.io import loader
from fgoicp_tpu_torch.models.goicp import GoICP
from fgoicp_tpu_torch.models.icp import icp_register
from fgoicp_tpu_torch.models.serving import RegistrationService
from fgoicp_tpu_torch.ops import procrustes as proc
from util import std_engine
from torch_threads import one_torch_thread  # noqa: F401


def _t_engine(**overrides):
    return TEngine(**dataclasses.asdict(std_engine(**overrides)))


def test_rejects_bad_shapes():
    good = np.zeros((10, 3), np.float32)
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        GoICP(np.zeros((10, 2), np.float32), good, device="cpu")
    with pytest.raises(ValueError, match="at least 3"):
        GoICP(good, np.zeros((2, 3), np.float32), device="cpu")
    with pytest.raises(ValueError, match=r"\[N, 3\]"):
        RegistrationService(np.zeros((10, 2), np.float32), device="cpu")


@pytest.mark.parametrize("value", [np.nan, np.inf])
def test_rejects_nonfinite(value):
    good = np.random.default_rng(0).normal(size=(20, 3)).astype(np.float32)
    bad = good.copy()
    bad[3, 1] = value
    with pytest.raises(ValueError, match="NaN"):
        GoICP(bad, good, device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        GoICP(good, bad, device="cpu")
    with pytest.raises(ValueError, match="NaN"):
        RegistrationService(bad, device="cpu")


def test_icp_degenerate_collinear_source():
    """Collinear points make the cross-covariance singular; the polar
    solve must stay finite and return a proper rotation."""
    s = np.linspace(0, 1, 40, dtype=np.float32)
    line = torch.from_numpy(np.stack([s, 2 * s, -s], axis=1))
    target = torch.from_numpy(
        np.random.default_rng(1).normal(size=(60, 3)).astype(np.float32))
    sse, R, t = icp_register(target, line, max_iter=5)
    R, t = R.numpy(), t.numpy()
    assert np.all(np.isfinite(R)) and np.all(np.isfinite(t))
    assert np.isfinite(float(sse))
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-4)
    assert np.linalg.det(R) == pytest.approx(1.0, abs=1e-4)


def test_procrustes_identical_points():
    """All-identical correspondences: zero covariance, must not NaN."""
    src = torch.zeros((2, 10, 3), dtype=torch.float32)
    corr = torch.ones((2, 10, 3), dtype=torch.float32)
    R, t = proc.procrustes(src, corr)
    assert torch.all(torch.isfinite(R))
    np.testing.assert_allclose(t.numpy(), 1.0, atol=1e-5)


def test_identical_clouds_register_to_identity():
    rng = np.random.default_rng(2)
    pc = rng.normal(size=(80, 3)).astype(np.float32)
    m = GoICP(pc, pc, mse_threshold=1e-4, engine=_t_engine(), device="cpu")
    R, t = m.run()
    np.testing.assert_allclose(R, np.eye(3), atol=1e-3)
    np.testing.assert_allclose(t, 0.0, atol=1e-3)
    assert m.last_certified_gap <= m.sse_threshold


def test_subsample_extremes():
    pts = np.arange(30, dtype=np.float32).reshape(10, 3)
    assert len(loader.subsample_cloud(pts, 1.0)) == 10
    tiny = loader.subsample_cloud(pts, 1e-5, seed=0)
    assert len(tiny) <= 1  # cap = floor(10 * 1e-5) = 0

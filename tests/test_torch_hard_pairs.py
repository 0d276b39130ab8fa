"""hard_pairs (fgoicp_tpu_torch/scripts/hard_pairs.py) against the JAX
package's GoICP on the synthetic hard pair, at a tiny size on the CPU,
where every kernel wrapper runs its plain version.

Tolerances: translation nodes, rotation children and outer steps equal to
the JAX package's GoICP, the pose within 1e-4, with the reference's
reflection fix keyed as the port keys it (ROADMAP Queue 3); on the
cross-covariances where the JAX package's closest_rotation returns a
reflection, the port's proper rotation within 1e-3 of JAX's with the
port's key.
"""
import contextlib
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fgoicp_tpu.models.goicp import GoICP as JGoICP
from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch.scripts import hard_pairs, workloads
from util import std_engine
from torch_threads import one_torch_thread  # noqa: F401


def _t_engine(**overrides):
    return TEngine(**dataclasses.asdict(std_engine(**overrides)))


# The tiny pair (400 / 200 points) at mse 1e-3 with coarse spans: a few
# outer steps on the CPU.
HARD_ENGINE = dict(rotation_min_span=0.3, translation_min_span=0.4)
HARD_FLAGS = ["--pair", "synth", "--scale", "0.02", "--mse", "1e-3",
              "--runs", "1", "--device", "cpu"]
# hard_synth's default planes and its first ones (+z target, -y source).
# On both, a triggered child's trimmed ICP at this size meets
# cross-covariances of rank 2 to rounding (a short arc of the curve is
# nearly planar): the JAX package's closest_rotation keys its reflection
# fix on det(M), which is rounding noise there, and returns reflections
# (ROADMAP Queue 3), where the port keys the fix on the polar factor's
# determinant.  The parity test runs the reference with the port's key
# (`keyed_on_polar_factor`); the test after it runs the JAX package as it
# is and records the reflections.
PLANES = {"default": {}, "zy": dict(normals=((0, 0, 1), (0, -1, 0)))}


@contextlib.contextmanager
def jax_closest_rotation(fn):
    """The JAX package's closest_rotation replaced by fn inside the block;
    the ICP's compiled program is dropped on entry and on exit, so that no
    other test sees the swapped function."""
    from fgoicp_tpu.models import icp as jicp
    from fgoicp_tpu.ops import procrustes as jproc
    real = jproc.closest_rotation
    jproc.closest_rotation = fn
    jicp.icp_batched.clear_cache()
    try:
        yield
    finally:
        jproc.closest_rotation = real
        jicp.icp_batched.clear_cache()


def keyed_on_polar_factor(abt):
    """The JAX package's closest_rotation with its reflection fix keyed on
    det(Q), Q the polar factor: the port's rule."""
    from fgoicp_tpu.ops import procrustes as jproc
    m = jnp.swapaxes(jnp.asarray(abt, jnp.float32), -1, -2)
    q = jproc._polar_orthogonal(m)
    v3 = jproc._smallest_eigvec_sym3(jnp.swapaxes(m, -1, -2) @ m)
    refl = jnp.eye(3, dtype=m.dtype) - 2.0 * (v3[..., :, None]
                                              * v3[..., None, :])
    return jnp.where((jnp.linalg.det(q) < 0)[..., None, None], q @ refl, q)


@functools.lru_cache(maxsize=None)
def _port_hard_run(planes):
    """hard_pairs on a tiny pair, once a module: (its line, the port's
    model, the start poses of its largest batch of triggered-child ICPs)."""
    from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP
    seen, starts = {}, []
    real_init, real_icp = TGoICP.__init__, TGoICP._icp_padded

    def init(self, *a, **kw):
        real_init(self, *a, **kw)
        seen["model"] = self

    def icp_padded(self, R0, t0, n_active, convergence, search=False, **kw):
        if search:
            starts.append((np.asarray(R0), np.asarray(t0)))
        return real_icp(self, R0, t0, n_active, convergence, search=search,
                        **kw)
    synth = functools.partial(workloads.hard_synth, **PLANES[planes])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(workloads, "hard_synth", synth)
        mp.setattr(TGoICP, "__init__", init)
        mp.setattr(TGoICP, "_icp_padded", icp_padded)
        (line,) = hard_pairs.run(HARD_FLAGS, engine=_t_engine(**HARD_ENGINE))
    return line, seen["model"], max(starts, key=lambda s: len(s[0]))


@pytest.mark.parametrize("planes", list(PLANES))
def test_hard_pairs_synth_matches_jax(planes):
    """hard_pairs on the tiny pair against the JAX package's GoICP (its
    reflection fix keyed as the port keys it): equal translation nodes,
    rotation children and outer steps, the pose within 1e-4, a proper
    rotation."""
    line = _port_hard_run(planes)[0]
    pct, pcs, *_ = workloads.hard_synth(400, 200, **PLANES[planes])
    assert (line["target_points"], line["source_points"]) == (400, 200)
    with jax_closest_rotation(keyed_on_polar_factor):
        jm = JGoICP(pct, pcs, engine=std_engine(**HARD_ENGINE),
                    mse_threshold=1e-3, trim_fraction=0.5)
        R_j, t_j = jm.run()
    assert line["nodes"] == jm.stats.translation_nodes > 0
    assert line["rotation_children"] == jm.stats.rotation_children > 0
    assert line["outer_steps"] == jm.stats.outer_steps
    np.testing.assert_allclose(line["R"], np.asarray(R_j), atol=1e-4)
    np.testing.assert_allclose(line["t"], np.asarray(t_j), atol=1e-4)
    assert line["certified"] == (jm.last_certified_gap <= jm.sse_threshold)
    assert np.linalg.det(np.asarray(line["R"])) == pytest.approx(1.0,
                                                                 abs=1e-5)
    assert line["seed_sse"] > 0 and "r_err" in line


def test_hard_pair_jax_reflects_where_the_port_does_not():
    """The fault the parity test steps round: the tiny pair's triggered
    children, their trimmed ICP from the same starts on the port's
    normalized clouds, through the JAX package as it is, its
    closest_rotation's inputs and results recorded.  It returns
    reflections (det -1); on those same cross-covariances the port's
    closest_rotation returns proper rotations, equal within 1e-3 to JAX's
    with the fix keyed on the polar factor (the ridged Newton iteration on
    a rank-2 input amplifies the f32 rounding of the two libraries' 3x3
    inverses to about 2e-4)."""
    import jax
    from fgoicp_tpu.models import icp as jicp
    from fgoicp_tpu.ops import procrustes as jproc
    from fgoicp_tpu_torch.ops import procrustes as tproc
    _, model, (R0, t0) = _port_hard_run("default")
    real, seen = jproc.closest_rotation, []

    def recorded(abt):
        r = real(abt)
        jax.debug.callback(
            lambda m, d: seen.append((np.asarray(m), np.asarray(d))), abt,
            jnp.linalg.det(r))
        return r
    with jax_closest_rotation(recorded):
        jax.block_until_ready(jicp.icp_batched(
            model.pct.numpy(), model.pcs.numpy(), R0, t0,
            max_iter=model.engine.icp_max_iter, trim_keep=model.trim_keep,
            convergence_threshold=model.engine.icp_convergence_bnb))
    abt = np.concatenate([m[d < 0] for m, d in seen])
    assert len(abt) > 0
    got = tproc.closest_rotation(torch.from_numpy(abt)).numpy()
    np.testing.assert_allclose(np.linalg.det(got.astype(np.float64)), 1.0,
                               atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(keyed_on_polar_factor(abt)),
                               atol=1e-3)


def test_hard_synth_is_seeded_at_its_pose():
    pct, pcs, R, t, span = workloads.hard_synth(2000, 1000)
    again = workloads.hard_synth(2000, 1000)
    np.testing.assert_array_equal(pcs, again[1])
    assert pct.shape == (2000, 3) and pcs.shape == (1000, 3)
    np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-6)
    # 90 degrees about -y: x goes to +z.
    np.testing.assert_allclose(R @ [1, 0, 0], [0, 0, 1], atol=1e-6)
    ang, axis = hard_pairs.axis_angle(R)
    assert ang == pytest.approx(90.0) and np.allclose(axis, [0, -1, 0])

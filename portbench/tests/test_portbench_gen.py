"""The generators repeat exactly from a seed."""

import numpy as np
import pytest

from portbench import gen, spec, traffic
from portbench.tests.tiny import tiny_files

MIXES = [(w["config"], w["traffic"]) for w in spec.benchmark()["workloads"]]


def _arrays(work):
    out = [] if work.target is None else [work.target]
    for req in [work.warmup] + work.pool:
        if req.target is not None:
            out.append(req.target)
        out += req.sources
        out += [x for R, t in req.truths for x in (R, t)]
    return out


@pytest.mark.parametrize("names", MIXES, ids=".".join)
def test_pool_repeats_from_seed(names):
    config, mix = tiny_files(*names)
    seed = 2 ** 31 + 12345
    a = _arrays(traffic.build(config, mix, seed))
    b = _arrays(traffic.build(config, mix, seed))
    assert len(a) == len(b) and all(np.array_equal(x, y)
                                    for x, y in zip(a, b))
    # Another seed draws other requests (a fixed set: another order; a
    # tiny set may keep its order for one seed).
    others = [_arrays(traffic.build(config, mix, seed + k))
              for k in range(1, 4)]
    assert any(not all(np.array_equal(x, y) for x, y in zip(a, c))
               for c in others)


def test_truth_maps_source_onto_cloud():
    config, mix = tiny_files("bunny_toml", "random_pose")
    work = traffic.build(config, mix, 7)
    cloud = traffic.model_cloud(config)
    req = work.pool[0]
    (R, t), = req.truths
    back = req.sources[0] @ R.T + t
    d2 = ((back[:, None, :] - cloud[None, :, :]) ** 2).sum(-1).min(1)
    assert float(d2.max()) < 1e-9
    assert abs(np.linalg.det(R) - 1.0) < 1e-5


@pytest.mark.parametrize("names", [m for m in MIXES
                                   if spec.traffic(m[1])["kind"] == "views"],
                         ids=".".join)
def test_fixed_set_is_shuffled_by_the_seed(names):
    config, mix = tiny_files(*names)
    mix["pool"] = 8
    views = lambda s: [x for r in traffic.build(config, mix, s).pool
                       for x in r.sources]
    a, b = views(1), views(2)
    key = lambda x: x.tobytes()
    assert sorted(map(key, a)) == sorted(map(key, b))
    assert list(map(key, a)) != list(map(key, b))


def test_rotations_uniform_and_proper():
    rng = gen.rng_of(3, 0)
    Rs = np.stack([gen.random_rotation(rng) for _ in range(2000)])
    assert np.allclose(np.linalg.det(Rs), 1.0, atol=1e-5)
    # E[R] = 0 for the uniform (Haar) measure on SO(3).
    assert np.abs(Rs.mean(axis=0)).max() < 0.05

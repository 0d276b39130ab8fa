"""The port's nested BnB against the plain reference of Go-ICP's mechanism
(`portbench/reference_goicp.py`, plain torch, nothing of the program) on
the CPU.

Problems: seeded pairs of a 3,000-point Lissajous curve (noise 0.01): a
300-point target and a 100-point source drawn from it independently at a
random pose (rotation uniform on SO(3), shift +-0.25 span), which one ICP
from the identity leaves in a wrong basin.  The engine seeds as the
reference does (icp_multi_start=False), with the coarse spans of the other
CPU tests, 32 source clusters and a 64-point proxy coreset, so that the
bounds carry both the cluster radii and the proxy slack.

* Node bounds (`compare_goicp`): every lane the pooled inner BnB bounds
  for a handful of rotation cubes, fixed and relaxed, against the plain
  exact node bounds, the SSE of 8 poses drawn inside each node and the
  plain ub at its centre, at the bound kernels' own tolerance; bounds from
  TF32 distances in the program's place fail the same checks.
* The search: the program's certified SSE against the plain BnB's, within
  ns x mse_threshold each way, and both at most the known pose's SSE plus
  that threshold.
"""
import numpy as np
import pytest
import torch

from fgoicp_tpu_torch.config import EngineConfig
from fgoicp_tpu_torch.models.goicp import GoICP
from portbench import compare_goicp, gen, reference, reference_goicp
from torch_threads import one_torch_thread  # noqa: F401

MSE = 1e-3
ENGINE = dict(rotation_batch=2, pool_lanes=64, pool_capacity=2048,
              rotation_min_span=0.1, translation_min_span=0.2,
              icp_multi_start=False, source_coreset=32)
PROXIES = 64


def _pair(seed):
    """(target, source, (R, t)) of a seeded problem."""
    rng = np.random.default_rng(seed)
    cloud = gen.curve(rng, rng.uniform(0.0, 4.5, 3000), 0.01)
    target = gen.subsample(rng, cloud, 300)
    R, t = gen.random_pose(rng, gen.span_of(cloud), 0.25)
    return target, gen.moved(gen.subsample(rng, cloud, 100), R, t), (R, t)


def _model(target, source):
    return GoICP(target, source, mse_threshold=MSE,
                 engine=EngineConfig(**ENGINE), proxy_size=PROXIES,
                 device="cpu")


@pytest.fixture(scope="module", params=[7, 12])
def nodes(request):
    """(captured nodes, the reference's bounds of each, the normalized
    clouds) of one inner-BnB call over eight rotation cubes of the finest
    level the outer loop splits, around the known rotation and elsewhere,
    under an incumbent no node beats, so that every group searches."""
    target, source, (R, _) = _pair(request.param)
    got = compare_goicp.fine_nodes(_model(target, source), R, 600)
    tgt, src = reference_goicp.normalized(target, source)
    return got, compare_goicp.reference_bounds(got, tgt, src), (tgt, src)


def test_fine_cubes_lie_in_so3():
    """Centres inside the unit ball at the finest split level, the first
    cube holding the known rotation."""
    for seed in (7, 12):
        R = _pair(seed)[2][0]
        c = compare_goicp.cube_coords(R)
        assert np.allclose(reference_goicp.rotation(c).numpy(), R,
                           atol=1e-5)
        cubes = compare_goicp.fine_cubes(R, ENGINE["rotation_min_span"])
        assert np.all(np.abs(np.asarray(cubes[0][:3]) - c) <= 0.125)
        for x, y, z, h in cubes:
            assert h == 0.125 and x * x + y * y + z * z <= 1.0


def test_nodes_cover_both_passes(nodes):
    got, refs, _ = nodes
    assert len(got) >= 300
    fixed = [n for n in got if n["fixed"]]
    relaxed = [n for n in got if not n["fixed"]]
    assert fixed and relaxed
    # Some relaxed nodes bound above zero, so the lb checks bite.
    assert max(r[0] for n, r in zip(got, refs) if not n["fixed"]) > 1e-3
    assert len({n["t_span"] for n in got}) >= 3


def test_program_node_bounds_hold_against_the_reference(nodes):
    got, refs, _ = nodes
    readings = compare_goicp.judge([(n["lb"], n["ub"]) for n in got], refs)
    assert all(v <= 1.0 for v in readings.values()), readings


def test_tf32_bounds_fail_the_same_checks(nodes):
    got, refs, (tgt, src) = nodes
    readings = compare_goicp.judge(
        compare_goicp.tf32_bounds(got, tgt, src), refs)
    assert max(readings.values()) > 1.0, readings


@pytest.mark.parametrize("seed", [7, 9, 10])
def test_certified_optimum_matches_the_plain_search(seed):
    target, source, truth = _pair(seed)
    model = _model(target, source)
    model.run()
    thr = len(source) * MSE
    assert model.last_certified_gap <= thr
    plain = reference_goicp.search(
        target, source, MSE, rotation_min_span=ENGINE["rotation_min_span"],
        translation_min_span=ENGINE["translation_min_span"])
    assert plain["certified"] and plain["outer_nodes"] >= 1
    assert abs(model.best_sse - plain["sse"]) <= thr
    known = reference.sse(target, source, *truth)
    assert model.best_sse <= known + thr
    assert plain["sse"] <= known + thr


def test_reference_imports_nothing_of_the_program():
    import ast
    import pathlib
    for name in ("reference_goicp.py", "reference.py"):
        tree = ast.parse((pathlib.Path(reference.__file__).parent
                          / name).read_text())
        imported = {a.name.split(".")[0] for node in ast.walk(tree)
                    if isinstance(node, ast.Import) for a in node.names}
        imported |= {node.module.split(".")[0] for node in ast.walk(tree)
                     if isinstance(node, ast.ImportFrom) and node.module}
        assert not imported & {"fgoicp_tpu_torch", "fgoicp_tpu", "jax",
                               "jaxlib"}, (name, imported)

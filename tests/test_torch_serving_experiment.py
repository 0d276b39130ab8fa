"""serving_experiment (fgoicp_tpu_torch/scripts/serving_experiment.py)
against the JAX package's RegistrationService on the same sources, at a
tiny size on the CPU, where every kernel wrapper runs its plain version.

Tolerances: certified and fallback_used per pair equal, poses within 1e-3
(test_torch_serving.py's tolerance).
"""
import dataclasses

import numpy as np
import pytest

from fgoicp_tpu.models import serving as jserving
from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch.scripts import serving_experiment
from util import std_engine
from torch_threads import one_torch_thread  # noqa: F401


def _t_engine(**overrides):
    return TEngine(**dataclasses.asdict(std_engine(**overrides)))


# 4 pairs of the skull stand-in cut to 3,000 points (a 183-point target),
# multi-start seeding and coarse spans: the fallback mode's uncertified
# view takes a short trimmed BnB in both packages.
SERVING_ENGINE = dict(icp_multi_start=True, rotation_min_span=0.3,
                      translation_min_span=0.4)


@pytest.mark.parametrize("mode", ["ragged", "fallback"])
def test_serving_experiment_matches_jax(mode):
    flags = ["--mode", mode, "--pairs", "4", "--points", "3000", "--runs",
             "1", "--device", "cpu"]
    (line,) = serving_experiment.run(flags,
                                     engine=_t_engine(**SERVING_ENGINE))
    args = serving_experiment.build_parser().parse_args(flags)
    pct, sources, Rs, ts, span, kw = serving_experiment.experiment(args)
    assert kw.get("trim_fraction", 0.0) == (0.3 if mode == "fallback"
                                            else 0.0)
    js = jserving.RegistrationService(pct, engine=std_engine(
        **SERVING_ENGINE), **kw)
    res_j = js.register(sources)
    assert line["pairs"] == len(res_j) == 4
    for got, want in zip(line["per_pair"], res_j):
        assert (got["certified"], got["fallback"]) == (
            bool(want.certified), bool(want.fallback_used))
        np.testing.assert_allclose(got["R"], np.asarray(want.R), atol=1e-3)
        np.testing.assert_allclose(got["t"], np.asarray(want.t), atol=1e-3)
    assert line["fallbacks"] == js.stats.fallbacks
    assert line["certified_by_seeding"] == js.stats.certified_by_seeding
    if mode == "fallback":
        assert line["fallbacks"] >= 1
    else:
        assert len({len(s) for s in sources}) > 1   # ragged

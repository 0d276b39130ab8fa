"""The comparison that decides `correct`, on the CPU at tiny sizes: sound
runs pass; the control (the TF32 objective in the program's place, through
`check.judge` as `portbench.calibrate` passes it) and every fault a cell
can have, planted in the program underneath a run whose look for a card
is skipped, fail.

Faults: an answer altered where it is produced (the pose a registration
returns turned by 0.2 rad, its SSE kept, or reporting the turned pose's
own SSE so that only `opt_excess` can tell); half of a batch left out (the
service registers the first half and hands its answers to the rest); a
state left unchanged (every call answers with the first call's result).
A registration across chips has no exchange to leave out: every cell runs
on one card.
"""

import time

import numpy as np
import pytest

from portbench import calibrate, check, reference, run
from portbench.tests.tiny import tiny

REGISTER = "bunny_toml.random_pose"
SERVE = "skull_serving.full_views"


def _run(cell, seed=5, seconds=0.1, trace=0):
    bench, c, config, mix = tiny(cell)
    return run.run_cell(bench, c, seed, seconds, trace, "cpu",
                        time.perf_counter(), config, mix)


@pytest.mark.parametrize("cell", [REGISTER, SERVE])
def test_sound_run_is_correct(cell):
    result, items, ctx = _run(cell)
    assert result["correct"], result["checks"]
    assert list(result)[-1] == "checks"
    assert len(items) == result["attempted"] and result["failed"] == 0
    assert result["checks"]["sse_gap"]["value"] < 1e-4


@pytest.mark.parametrize("cell", [REGISTER, "skull_serving.single_view"])
def test_traced_run_reports_its_metrics(cell):
    result, _, _ = _run(cell, trace=1)
    names = set(result["metrics"])
    assert result["correct"]
    # The CPU has no device trace: only the spans and counters read.
    assert names == {"construct_ms.register", "icp_ms.register",
                     "inner_bnb_ms.register", "device_idle_pct.register",
                     "launches_per_pair.register"} or names == {
        "seed_ms.register", "device_idle_pct.register",
        "launches_per_pair.register"}
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", [REGISTER, SERVE])
def test_control_is_not_correct(cell):
    """The reference in TF32 in the program's place, at the program's own
    poses, comes out of the run's comparison as not correct."""
    _, _, config, _ = tiny(cell)
    result, items, _ = _run(cell)
    assert result["correct"]
    got = calibrate.judged("control", calibrate.control_items(items, "cpu"),
                           config, "cpu")
    assert got["control_correct"] is False
    assert got["control_sse_gap"] > 3 * config["limits"]["sse_gap"]


@pytest.mark.parametrize("cell", [REGISTER, SERVE])
def test_altered_pose_with_its_own_sse_is_not_correct(cell):
    """A pose turned where it is produced, reporting its own exact SSE and
    its certificate: only `opt_excess` can tell, and it does."""
    _, _, config, _ = tiny(cell)
    _, items, _ = _run(cell)
    got = calibrate.judged("altered", calibrate.altered_items(items, "cpu"),
                           config, "cpu")
    assert got["altered_correct"] is False
    assert got["altered_sse_gap"] <= config["limits"]["sse_gap"]
    assert got["altered_opt_excess"] > config["limits"]["opt_excess"]


def test_tf32_rounding():
    import torch
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 3 * 2.0 ** -11, 3.0])
    assert reference.round_tf32(x).tolist() == [1.0, 1.0 + 2 ** -9, 3.0]


def test_answer_altered(monkeypatch):
    from fgoicp_tpu_torch.models import goicp
    real = goicp.GoICP.run

    def altered(self):
        R, t = real(self)
        return calibrate.turned(R), t

    monkeypatch.setattr(goicp.GoICP, "run", altered)
    result, _, _ = _run(REGISTER)
    assert not result["correct"]
    assert result["checks"]["sse_gap"]["value"] > \
        result["checks"]["sse_gap"]["limit"]


def test_answer_altered_in_serving(monkeypatch):
    from fgoicp_tpu_torch.models import serving
    real = serving._seed_pairs

    def altered(*a, **kw):
        sse, R, t, scale, mu_s = real(*a, **kw)
        return sse, R, t + 0.05 / scale[:, None], scale, mu_s

    monkeypatch.setattr(serving, "_seed_pairs", altered)
    result, _, _ = _run(SERVE)
    assert not result["correct"]


def test_half_the_batch_left_out(monkeypatch):
    from fgoicp_tpu_torch.models import serving
    real = serving.RegistrationService.register

    def half(self, sources, fallback=True):
        sources = list(sources)
        done = real(self, sources[:len(sources) // 2], fallback)
        return done + done[:len(sources) - len(done)]

    monkeypatch.setattr(serving.RegistrationService, "register", half)
    result, _, _ = _run(SERVE)
    assert not result["correct"]


@pytest.mark.parametrize("cell", [REGISTER, SERVE])
def test_state_unchanged(monkeypatch, cell):
    from fgoicp_tpu_torch.models import goicp, serving
    first = {}

    def stale(real):
        def call(*a, **kw):
            if "out" not in first:
                first["out"] = real(*a, **kw)
            return first["out"]
        return call

    if cell == REGISTER:
        monkeypatch.setattr(goicp, "register", stale(goicp.register))
    else:
        monkeypatch.setattr(serving.RegistrationService, "register",
                            stale(serving.RegistrationService.register))
    result, _, _ = _run(cell)
    assert not result["correct"]

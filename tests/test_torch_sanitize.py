"""The port's search-state sanitizer (fgoicp_tpu_torch/utils/sanitize.py), on
the cases of `tests/test_sanitize.py`: clean host and device runs pass with
`debug_checks=True`, and every corruption raises SanitizeError naming the
broken invariant, as in the JAX package.  Port only: the checks read the
port's own state (the device frontier as numpy arrays or tensors, the
incumbent's exact SSE recomputed on the model's device)."""
import dataclasses

import numpy as np
import pytest
import torch

from fgoicp_tpu_torch import EngineConfig as TEngine
from fgoicp_tpu_torch.models.goicp import GoICP as TGoICP
from fgoicp_tpu_torch.ops import so3_frontier as tso3
from fgoicp_tpu_torch.utils import sanitize
from test_checkpoint import _pair
from util import std_engine


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's CPU path runs many tiny ops: on one thread a test worker
    does not oversubscribe the cores that the other workers share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(**engine):
    pct, pcs = _pair()
    return TGoICP(pct, pcs, mse_threshold=5e-4, device="cpu",
                  engine=TEngine(**dataclasses.asdict(std_engine(**engine))))


@pytest.mark.parametrize("engine", [
    dict(), dict(outer_mode="device", so3_capacity=2048)],
    ids=["host", "device"])
def test_clean_run_passes_with_checks_on(engine, monkeypatch):
    m = _model(debug_checks=True, **engine)
    checked = []

    def counted(name):
        real = getattr(sanitize, name)

        def check(*args, **kw):
            checked.append(name)
            return real(*args, **kw)
        return check

    for name in ("check_heap", "check_device_state", "check_incumbent"):
        monkeypatch.setattr(sanitize, name, counted(name))
    m.run()
    assert m.mse < 5e-4
    want = "check_heap" if not engine else "check_device_state"
    assert want in checked and "check_incumbent" in checked


HEAP_CASES = {
    "lb > ub": (0.5, 0, (0.1, 0.2, 0.3, 0.25, 0.4)),
    "span": (0.5, 0, (0.1, 0.2, 0.3, 0.0, 1.5)),
    "finite": (-1.0, 0, (0.1, 0.2, 0.3, 0.25, 1.5)),
    "root quaternion": (0.5, 0, (2.0, 0.0, 0.0, 0.25, 1.5)),
    "translation": (0.5, 0, (0.1, 0.2, 0.3, 0.25, 1.5, np.nan, 0.0, 0.0)),
}


@pytest.mark.parametrize("case", list(HEAP_CASES), ids=list(HEAP_CASES))
def test_check_heap_catches_corruption(case):
    sanitize.check_heap([(0.5, 0, (0.1, 0.2, 0.3, 0.25, 1.5))])
    pattern = "lb .* > ub" if case == "lb > ub" else case
    with pytest.raises(sanitize.SanitizeError, match=pattern):
        sanitize.check_heap([HEAP_CASES[case]])


def _corrupt(st, case):
    if case == "sorted":
        bad = np.asarray(st.lbs).copy()
        bad[0], bad[3] = 5.0, 0.0
        return st._replace(lbs=bad)
    if case == "lb > ub":
        bad = np.asarray(st.ubs).copy()
        bad[0] = -1.0
        return st._replace(ubs=bad)
    if case == "span":
        bad = np.asarray(st.spans).copy()
        bad[0] = 0.0
        return st._replace(spans=bad)
    if case == "hist_len":
        return st._replace(hist_len=np.int32(9))
    if case == "non-increasing":
        hs = np.asarray(st.hist_sse).copy()
        hs[0], hs[1] = 1.0, 2.0
        return st._replace(hist_sse=hs, hist_len=np.int32(2),
                           best_sse=np.float32(2.0))
    return st._replace(pruned=np.int32(-1))


@pytest.mark.parametrize("on_tensors", [False, True],
                         ids=["numpy", "tensors"])
@pytest.mark.parametrize("case", ["sorted", "lb > ub", "span", "hist_len",
                                  "non-increasing", "counter"])
def test_check_device_state_catches_corruption(case, on_tensors):
    st = tso3.initial_state(8, history_capacity=4)
    bad = _corrupt(st, case)
    if on_tensors:
        st, bad = (tso3.to_device(s, "cpu") for s in (st, bad))
    sanitize.check_device_state(st)
    with pytest.raises(sanitize.SanitizeError, match=case):
        sanitize.check_device_state(bad)


def test_check_incumbent_catches_mismatch():
    m = _model()
    sanitize.check_incumbent(m)  # no incumbent yet: a no-op
    m.best_rotation = np.eye(3, dtype=np.float32)
    m.best_translation = np.zeros(3, np.float32)
    m.best_sse = 123.456
    with pytest.raises(sanitize.SanitizeError, match="exact SSE"):
        sanitize.check_incumbent(m)

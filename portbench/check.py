"""Whether what the timed path returned is correct.

Each answer of the window carries a world pose (R, t), the normalized-frame
SSE the program reports for it, and whether the program certified it (its
optimality gap at most ns x mse_threshold).  The reference
(`reference.py`) works the objective out again from the request's own
clouds, and three numbers are compared, each with its limit from the
configuration's `limits`:

* `missing`: answers that never came or hold a non-finite number
  (limit 0);
* `sse_gap`: over the answers, the largest |SSE reported - SSE of
  the returned pose| / SSE of the returned pose: the reported objective
  must be that of the pose;
* `opt_excess`: over the certified answers, the largest (SSE of
  the returned pose - SSE of the known true pose) / (ns x mse_threshold).
  A certificate bounds every pose's SSE from below to within the
  threshold, the true pose's too, so it is at most 1 (the limit the
  certificate states).

An answer the program did not certify says nothing wrong: it is counted
as failed (not as work) by the run, and its SSE gap is still compared.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from . import reference

NUMBERS = ("missing", "sse_gap", "opt_excess")


@dataclasses.dataclass
class Answer:
    R: np.ndarray
    t: np.ndarray
    sse: float
    certified: bool

    def finite(self) -> bool:
        return bool(np.all(np.isfinite(self.R)) and np.all(np.isfinite(self.t))
                    and math.isfinite(self.sse))


@dataclasses.dataclass
class Item:
    """One answered source: its clouds, its known pose and the answer."""
    target: np.ndarray
    source: np.ndarray
    truth: tuple
    answer: Answer


def readings(items: list, mse_threshold: float, device) -> dict:
    """`sse_gap` and `opt_excess` over items (-inf where none counts)."""
    gap = excess = -math.inf
    for it in items:
        a = it.answer
        ref = reference.sse(it.target, it.source, a.R, a.t, device)
        gap = max(gap, abs(a.sse - ref) / max(ref, 1e-30))
        if a.certified:
            true = reference.sse(it.target, it.source, *it.truth, device)
            excess = max(excess, (ref - true)
                         / (len(it.source) * mse_threshold))
    return {"sse_gap": gap, "opt_excess": excess}


def judge(expected: int, items: list, mse_threshold: float, limits: dict,
          device) -> tuple:
    """(correct, {number: {"value", "limit"}}) of a window that owed
    `expected` answers and returned `items`."""
    good = [it for it in items if it.answer.finite()]
    values = {"missing": expected - len(good)}
    values.update(readings(good, mse_threshold, device))
    checks, correct = {}, bool(good)
    for name in NUMBERS:
        v, lim = values[name], float(limits[name])
        # -inf: no answer of that kind came, nothing to exceed.
        checks[name] = {"value": v if math.isfinite(v) else None,
                        "limit": lim}
        correct = correct and v <= lim
    return correct, checks

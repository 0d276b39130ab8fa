"""Search-state invariant sanitizer.

Counterpart of `fgoicp_tpu/utils/sanitize.py`.  The reference ships no
sanitizer (its `cudaCheckError` is compiled out by default, fgoicp/
common.hpp:15).  The BnB's correctness rests on search-state invariants that
a kernel bug, an unsound bound or a checkpoint slip can break silently, and a
broken invariant does not crash: it returns a confidently wrong "global
optimum".  This module checks them:

* the structure of the host heap and of the device SO3State frontier,
* lb <= ub on every live node,
* incumbent faithfulness: best_sse equals the exact (trimmed) SSE recomputed
  from (best_R, best_t) against the full clouds, on the model's device.

`EngineConfig.debug_checks = True` runs them at every host outer step and at
every device-state retrieval and chunk boundary (models/goicp.py), turning
silent corruption into a SanitizeError naming the broken invariant.  Cost:
one exact-SSE evaluation per check.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import icp as icp_model
from ..ops import so3_frontier as so3


class SanitizeError(AssertionError):
    """A search-state invariant does not hold."""


def _fail(msg: str):
    raise SanitizeError(f"search-state invariant violated: {msg}")


def check_heap(heap, context: str = "outer heap") -> None:
    """Structural invariants of the host outer frontier.

    Entries are (lb, tie, (x, y, z, span, ub, tx, ty, tz)): bounds finite
    and non-negative with lb <= ub (ub may be the BIG sentinel of
    never-evaluated requeued children), spans in (0, 1], and cube centers
    inside the root quaternion cube expanded by their span.
    """
    for lb, _tie, node in heap:
        x, y, z, span, ub = node[:5]
        if len(node) >= 8 and not all(np.isfinite(v) for v in node[5:8]):
            _fail(f"{context}: node translation {node[5:8]} not finite")
        if not np.isfinite(lb) or lb < 0.0:
            _fail(f"{context}: node lb {lb} not finite/non-negative")
        if lb > ub + 1e-6 * max(abs(ub), 1.0):
            _fail(f"{context}: node lb {lb} > ub {ub}")
        if not (0.0 < span <= 1.0):
            _fail(f"{context}: node span {span} outside (0, 1]")
        for c in (x, y, z):
            if abs(c) > 1.0 + span + 1e-6:
                _fail(f"{context}: cube center {(x, y, z)} outside the "
                      f"root quaternion cube (span {span})")


def check_device_state(st, context: str = "device SO3State") -> None:
    """Structural invariants of the device outer frontier (an SO3State of
    numpy arrays or tensors).

    The frontier is lb-sorted ascending with an INVALID tail; live rows have
    spans in (0, 1] and lb <= ub; counters are non-negative; the improvement
    ring is non-increasing in sse with hist_len <= its capacity.
    """
    st = so3.SO3State(*(so3.as_numpy(f) for f in st))
    lbs = np.asarray(st.lbs, np.float64)
    ubs = np.asarray(st.ubs, np.float64)
    spans = np.asarray(st.spans, np.float64)
    if np.any(np.diff(lbs) < -1e-6):
        _fail(f"{context}: frontier lbs not sorted ascending")
    live = lbs < so3.INVALID
    if np.any(lbs[live] < 0.0):
        _fail(f"{context}: negative lb on a live node")
    if np.any(lbs[live] > ubs[live] + 1e-6 * np.maximum(
            np.abs(ubs[live]), 1.0)):
        _fail(f"{context}: lb > ub on a live node")
    if np.any(spans[live] <= 0.0) or np.any(spans[live] > 1.0 + 1e-6):
        _fail(f"{context}: live node span outside (0, 1]")
    for f in ("outer_steps", "nodes_expanded", "children_evaluated",
              "inner_nodes", "icp_runs", "icp_triggered", "pruned"):
        if int(getattr(st, f)) < 0:
            _fail(f"{context}: counter {f} negative")
    n_hist = int(st.hist_len)
    cap = int(st.hist_sse.shape[0])
    if not (0 <= n_hist <= cap):
        _fail(f"{context}: hist_len {n_hist} outside [0, {cap}]")
    hs = np.asarray(st.hist_sse, np.float64)[:n_hist]
    if np.any(np.diff(hs) > 1e-6 * np.maximum(np.abs(hs[:-1]), 1.0)):
        _fail(f"{context}: improvement history sse not non-increasing")
    if n_hist > 0 and float(st.best_sse) > hs[-1] + 1e-6 * max(
            abs(hs[-1]), 1.0):
        _fail(f"{context}: best_sse {float(st.best_sse)} above the last "
              f"recorded improvement {hs[-1]}")


def check_incumbent(model, context: str = "incumbent",
                    rtol: float = 5e-4, atol: float = 1e-6) -> None:
    """best_sse must equal the exact (trimmed) SSE recomputed from
    (best_rotation, best_translation) against the model's full normalized
    clouds, on its device: every prune decision rests on it.  Skipped while
    no incumbent exists (best_sse at the BIG sentinel)."""
    if model.best_sse >= so3.BIG:
        return
    f32 = dict(dtype=torch.float32, device=model.pcs.device)
    R = torch.as_tensor(np.asarray(model.best_rotation, np.float32), **f32)
    t = torch.as_tensor(np.asarray(model.best_translation, np.float32), **f32)
    sse = float(icp_model.exact_sse_batched(
        model.pct, model.pcs, R[None], t[None],
        trim_keep=model.trim_keep)[0])
    if abs(sse - model.best_sse) > rtol * max(abs(sse), 1.0) + atol:
        _fail(f"{context}: best_sse {model.best_sse} != exact SSE "
              f"{sse} recomputed at (best_R, best_t)")

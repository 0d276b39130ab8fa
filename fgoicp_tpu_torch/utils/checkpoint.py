"""Checkpoint/resume of the Go-ICP search state.

A numpy-only copy of `fgoicp_tpu/utils/checkpoint.py` (the port cannot
import the JAX package, whose `__init__` imports jax).  The container is the
same, byte for byte: a checkpoint written by either package resumes in the
other.

The reference keeps its BnB state (priority queues + incumbent) purely
in memory, so a killed run restarts from scratch (reference
fgoicp/fgoicp.cpp:35,111).  Here the outer frontier is a host heap of plain
node tuples and the incumbent is three small arrays, so the whole search
state serializes to one .npz: atomic write (tmp + rename), versioned, with
cloud fingerprints so a checkpoint is never resumed against different data.

Two checkpoint kinds share the container format:

* ``host_heap`` — the host outer loop's heap + incumbent (save/load).
* ``device_state`` — the device outer loop's SO3State arrays
  (save_device_state/load_device_state): outer_mode='device' runs in
  checkpoint_every-step chunks (models/goicp.py), persisting the state
  between chunks, so a killed device-mode run resumes mid-search like the
  host loop does.
"""

from __future__ import annotations

import hashlib
import json
import os
import tempfile

import numpy as np

FORMAT_VERSION = 1


def cloud_fingerprint(pct: np.ndarray, pcs: np.ndarray) -> str:
    """16 hex digits of the SHA-256 of both clouds' float32 bytes and
    shapes.  GoICP hashes the clouds as given, before normalization."""
    h = hashlib.sha256()
    for a in (pct, pcs):
        arr = np.ascontiguousarray(np.asarray(a, np.float32))
        h.update(str(arr.shape).encode())
        h.update(arr.tobytes())
    return h.hexdigest()[:16]


def save(path: str, *, heap, tie: int, best_sse: float, best_rotation,
         best_translation, stats: dict, fingerprint: str,
         closed_leaf_lb: float = 1e29) -> None:
    """Atomically write the host loop's search state.

    heap: list of (lb, tie, (x, y, z, span, ub, tx, ty, tz)) outer-frontier
    entries (the translation triple is the node's inner best, the ICP start
    of leaf-claim refines; shorter items pad with zeros).
    closed_leaf_lb: min lb of terminal leaves the host loop already closed
    (1e29 = none); without it a resumed search would read exhaustion as an
    exhaustive certificate.
    """
    n = len(heap)
    lbs = np.empty((n,), np.float64)
    ties = np.empty((n,), np.int64)
    nodes = np.zeros((n, 8), np.float64)
    for i, (lb, t_, item) in enumerate(heap):
        lbs[i] = lb
        ties[i] = t_
        nodes[i, :len(item)] = item
    payload = {
        "version": np.int64(FORMAT_VERSION),
        "kind": np.bytes_(b"host_heap"),
        "fingerprint": np.bytes_(fingerprint.encode()),
        "heap_lbs": lbs, "heap_ties": ties, "heap_nodes": nodes,
        "tie": np.int64(tie),
        "best_sse": np.float64(best_sse),
        "best_rotation": np.asarray(best_rotation, np.float64),
        "best_translation": np.asarray(best_translation, np.float64),
        "closed_leaf_lb": np.float64(closed_leaf_lb),
        "stats_json": np.bytes_(json.dumps(stats).encode()),
    }
    _atomic_savez(path, payload)


def _atomic_savez(path: str, payload: dict) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".npz.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **payload)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def peek_kind(path: str) -> str:
    """Checkpoint kind without validation ('host_heap' for v1 files written
    before the kind field existed)."""
    with np.load(path) as z:
        return bytes(z["kind"]).decode() if "kind" in z else "host_heap"


def _check_header(z, fingerprint: str, expect_kind: str) -> None:
    version = int(z["version"])
    if version != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint version {version} != {FORMAT_VERSION}")
    kind = bytes(z["kind"]).decode() if "kind" in z else "host_heap"
    if kind != expect_kind:
        other = ("outer_mode='device'" if kind == "device_state"
                 else "outer_mode='host'")
        raise ValueError(
            f"checkpoint kind {kind!r} cannot resume here; it was "
            f"written by {other} — resume with that outer_mode")
    ckpt_fp = bytes(z["fingerprint"]).decode()
    if ckpt_fp != fingerprint:
        raise ValueError(
            f"checkpoint fingerprint {ckpt_fp} does not match the "
            f"loaded clouds ({fingerprint}); refusing to resume")


def save_device_state(path: str, *, state_arrays: dict, stats: dict,
                      fingerprint: str) -> None:
    """Atomically write a device-mode (SO3State) checkpoint.

    state_arrays: field name -> numpy array, one per SO3State field.
    """
    payload = {
        "version": np.int64(FORMAT_VERSION),
        "kind": np.bytes_(b"device_state"),
        "fingerprint": np.bytes_(fingerprint.encode()),
        "stats_json": np.bytes_(json.dumps(stats).encode()),
    }
    for k, v in state_arrays.items():
        payload["so3_" + k] = np.asarray(v)
    _atomic_savez(path, payload)


def load_device_state(path: str, *, fingerprint: str) -> dict:
    """Load a device-mode checkpoint; raises on version/kind/fingerprint
    mismatch.  Returns {"state_arrays": {...}, "stats": {...}}."""
    with np.load(path) as z:
        _check_header(z, fingerprint, "device_state")
        arrays = {k[len("so3_"):]: np.asarray(z[k])
                  for k in z.files if k.startswith("so3_")}
        return {
            "state_arrays": arrays,
            "stats": json.loads(bytes(z["stats_json"]).decode()),
        }


def load(path: str, *, fingerprint: str) -> dict:
    """Load a host-heap checkpoint; raises on version/kind/fingerprint
    mismatch."""
    with np.load(path) as z:
        _check_header(z, fingerprint, "host_heap")
        heap = [
            # Older checkpoints stored 5-wide nodes (no per-node
            # translation): pad with zeros.
            (float(lb), int(t_),
             tuple(float(v) for v in node) + (0.0,) * max(0, 8 - len(node)))
            for lb, t_, node in zip(z["heap_lbs"], z["heap_ties"],
                                    z["heap_nodes"])
        ]
        return {
            "heap": heap,
            "tie": int(z["tie"]),
            "best_sse": float(z["best_sse"]),
            "best_rotation": np.asarray(z["best_rotation"], np.float32),
            "best_translation": np.asarray(z["best_translation"], np.float32),
            # Older checkpoints lack the field; 1e29 = no closed leaves.
            "closed_leaf_lb": (float(z["closed_leaf_lb"])
                               if "closed_leaf_lb" in z.files else 1e29),
            "stats": json.loads(bytes(z["stats_json"]).decode()),
        }

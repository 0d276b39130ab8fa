"""Point-cloud loading with seeded random subsampling.

A copy of the JAX package's `fgoicp_tpu/io/loader.py` without its optional
native C++ fast path (that library lives inside `fgoicp_tpu/`, whose import
pulls in jax).  The numpy parsers return the same arrays.

Parity with the reference's load_cloud dispatch (reference src/
utilities.hpp:237-260): `.ply` via the PLY parser, `.txt` with a
first-line count followed by `x y z` rows, case-insensitive extension.

Subsampling reproduces the reference's Bernoulli scheme
(utilities.hpp:144-163): cap = floor(total * subsample); each point is
kept with probability `subsample`, scanning in file order, until the cap
is hit — but with a seeded PRNG instead of std::random_device, so runs
are deterministic.
"""

from __future__ import annotations

import os

import numpy as np

from . import ply as ply_mod
from ..utils import logging as log


def subsample_cloud(points: np.ndarray, subsample: float, seed: int = 0) -> np.ndarray:
    """Bernoulli subsample capped at floor(N * subsample), seeded."""
    if subsample >= 1.0:
        return points
    total = len(points)
    cap = int(total * subsample)
    rng = np.random.default_rng(seed)
    keep = rng.random(total) <= subsample
    idx = np.flatnonzero(keep)[:cap]
    return points[idx]


def load_cloud_txt(path: str) -> np.ndarray:
    """First line = point count, then `x y z` rows (utilities.hpp:181-235)."""
    with open(path, "r") as f:
        total = int(f.readline().split()[0])
        if total <= 0:
            raise RuntimeError(f"Invalid number of points in the TXT file: {path}")
        data = np.loadtxt(f, dtype=np.float32, max_rows=total)
    if data.ndim == 1:
        data = data.reshape(1, -1)
    if data.shape[0] < total or data.shape[1] < 3:
        raise RuntimeError(f"Error reading point data from TXT file: {path}")
    return np.ascontiguousarray(data[:total, :3], dtype=np.float32)


def load_cloud(path: str, subsample: float = 1.0, seed: int = 0) -> np.ndarray:
    """Load a cloud and subsample it. Returns float32 [N, 3]."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".ply":
        pts = ply_mod.read_ply_vertices(path)
    elif ext == ".txt":
        pts = load_cloud_txt(path)
    else:
        raise RuntimeError(f"Unsupported file extension: {ext or path}")
    out = subsample_cloud(pts, subsample, seed)
    log.debug(f"Loaded {len(out)}/{len(pts)} points from {path}")
    return out

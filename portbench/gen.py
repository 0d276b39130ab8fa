"""Seeded generators of the benchmark's inputs (numpy only).

Frozen copies of the generators the port's smoke run used on the card, so
that a change to the program cannot move the yardstick:
* `curve`: the seeded asymmetric 3D Lissajous curve (chip_smoke.py::curve,
  the JAX package's tests/test_goicp.py::_surface_cloud);
* `random_rotation`: a uniform rotation by QR, after
  chip_smoke.py::random_rotation, with its sign fix repaired: that copy
  scales Q's columns by the signs of Q's own diagonal, which makes the
  diagonal positive and draws rotations near the identity far too often;
  scaling by the signs of R's diagonal gives the Haar measure;
* `moved`: points moved so that R @ moved + t lies on them
  (chip_smoke.py::serving_data's `moved`).
"""

from __future__ import annotations

import numpy as np


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """The generator of one input stream of a run: the same (seed, stream)
    gives the same draws; any whole seed, also past 32 bits."""
    return np.random.default_rng([int(seed) % (1 << 63), stream])


def curve(rng, s, noise):
    """Points of the asymmetric Lissajous curve at parameters s, with
    Gaussian noise of standard deviation `noise`."""
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    pts = pts + rng.normal(scale=noise, size=(len(s), 3))
    return pts.astype(np.float32)


def random_rotation(rng) -> np.ndarray:
    """A uniform random rotation [3, 3] float32: Q of the QR of a Gaussian
    matrix, its columns' signs fixed by the diagonal of R (uniform on O(3)),
    a reflection turned into a rotation by flipping a column."""
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.diag(r))[None, :]).astype(np.float32)
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    return R


def random_pose(rng, span: float, shift: float):
    """(R, t): R uniform on SO(3), t uniform in +-shift x span a coordinate."""
    R = random_rotation(rng)
    t = rng.uniform(-shift, shift, size=3).astype(np.float32) * span
    return R, t


def moved(points: np.ndarray, R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """The source that R @ source + t maps back onto `points`."""
    return ((points - t) @ R).astype(np.float32)


def subsample(rng, points: np.ndarray, n: int) -> np.ndarray:
    """n distinct rows of points, drawn without replacement."""
    return points[rng.choice(len(points), size=n, replace=False)]


def span_of(points: np.ndarray) -> float:
    """The cloud's largest extent along an axis."""
    return float(np.ptp(points, axis=0).max())

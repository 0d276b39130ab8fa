"""The timing tools' workloads: seeded synthetic pairs at the sizes of the
JAX bench's lines, and the real scans where they are on disk.

* `bunny_synth`: bench.py's synthetic bunny stand-in (an 18,000-point
  rippled sphere, a 3,000-point source at a known pose), mse 1e-3;
* `smoke`: the Lissajous-curve pair of chip_smoke.py's main-path phases
  (24,000 points cut into 18,000 / 3,000 at a known pose), mse 1e-3;
* `trimmed`: chip_smoke.py's partial-overlap pair (20,000 / 10,000 points,
  22.5 % of the source outside the target's part), mse 1e-3, trim 0.3;
* `bunny`, `scan_pair`, `dragon`: the JAX script's real scans, read from
  `--data` (the reference's `data/` directory); refused when absent.

The experiment tools' stand-ins for the real scans they read with --data:
* `hard_synth`: `hard_pairs`' turntable pair (the reference's bun000 /
  bun090): two partial views of the curve, about half of each in the
  other, the source turned 90 degrees about -y and shifted;
* `skull_synth`: `serving_experiment`'s cloud (the Artec3D skull's
  98,359 points), chip_smoke.py's serving cloud;
* `serving_data`: chip_smoke.py's serving phase, a 6,000-point target of
  `skull_synth`, 32 moved sources and 8 ragged partial views.
"""

from __future__ import annotations

import os

import numpy as np

SYNTHETIC = ("bunny_synth", "smoke", "trimmed")
REAL = ("bunny", "scan_pair", "dragon")
NAMES = SYNTHETIC + REAL


def bunny_synth(n_target=18000, n_source=3000):
    """bench.py::_synthetic_pair: a rippled unit sphere and a rotated,
    shifted subsample of it."""
    rng = np.random.default_rng(0)
    v = rng.normal(size=(n_target, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    r = 1.0 + 0.3 * np.sin(4 * v[:, :1]) + rng.normal(scale=0.005,
                                                      size=(n_target, 1))
    pct = (v * r).astype(np.float32)
    idx = rng.choice(n_target, size=n_source, replace=False)
    c, s = np.cos(1.5), np.sin(1.5)
    R = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    pcs = pct[idx] @ R.T + np.array([0.2, -0.1, 0.05], np.float32)
    return pct, pcs.astype(np.float32)


def curve(rng, s, noise=0.01):
    """Points of the seeded asymmetric 3D Lissajous curve at parameters s."""
    pts = np.stack([np.cos(s), 0.7 * np.sin(2.0 * s),
                    0.4 * np.sin(3.0 * s + 0.5)], axis=1)
    pts = pts + rng.normal(scale=noise, size=(len(s), 3))
    return pts.astype(np.float32)


def pose(span, angle=1.8):
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return R, np.array([0.11, -0.07, 0.05], np.float32) * span


def smoke_pair(n_cloud=24000, n_target=18000, n_source=3000):
    """(pct, pcs, R, t, span): chip_smoke.py's smoke pair, R @ pcs + t on
    pct; span the cloud's largest extent."""
    rng = np.random.default_rng(0)
    cloud = curve(rng, rng.uniform(0.0, 4.5, size=n_cloud))
    rng = np.random.default_rng(5)
    ti = rng.choice(n_cloud, size=n_target, replace=False)
    si = rng.choice(n_cloud, size=n_source, replace=False)
    span = float(np.ptp(cloud, axis=0).max())
    R, t = pose(span)
    return cloud[ti], ((cloud[si] - t) @ R).astype(np.float32), R, t, span


def trimmed_pair(n_target=20000, n_source=10000, seed=3, noise=0.005):
    """(pct, pcs, R, t, span): chip_smoke.py's partial-overlap pair, the
    target over s in [0, 3.7], the source over [0.95, 4.5] (22.5 % of it
    beyond the target's part)."""
    rng = np.random.default_rng(seed)
    pct = curve(rng, rng.uniform(0.0, 3.7, size=(n_target,)), noise)
    src = curve(rng, rng.uniform(0.95, 4.5, size=(n_source,)), noise)
    span = float(np.ptp(np.concatenate([pct, src]), axis=0).max())
    R, t = pose(span)
    return pct, ((src - t) @ R).astype(np.float32), R, t, span


# hard_synth's cloud noise, chosen on the card (PERF.md, section 6): at 1e-4
# mse the seeding leaves the gap open and the BnB certifies the known
# pose's basin in both outer modes.
HARD_NOISE = 0.0025
SKULL_POINTS = 98359
SKULL_NOISE = 0.0025


# bun090's turntable turn: 90 degrees about -y.
TURNTABLE = np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], np.float32)


def hard_synth(n_target=20000, n_source=10000,
               normals=((0, 0, 1), (-1, -1, 1))):
    """(pct, pcs, R, t, span): the hard pair.  Two clouds of the curve with
    independent noise, three times the wanted sizes; each keeps the points
    on the positive side of a plane through the target cloud's centroid,
    normals[0] for the target (+z) and normals[1] for the source ((-1, -1,
    1)), and is cut to its size; then the source is moved so that R @ pcs
    + t lies on the target, with R `TURNTABLE` and t (0.11, -0.07, 0.05) x
    span (chip_smoke.py's shift), noise HARD_NOISE, seed 12.  Sizes are
    the JAX script's defaults (bun000 at 0.5, bun090 at 0.25).

    About two thirds of the source lies in the target, so the trimmed
    optimum (trim 0.5) keeps overlap points only and lies at the known
    pose.  The planes were chosen on the card (PERF.md, section 6): with
    them both outer loops certify the known pose's basin at mse 1e-4.  The
    curve's arcs over s in [0, 1.36] and [pi, 4.5] are a half turn about y
    apart, and its arc over [1.5, 3] is nearly congruent to itself
    reversed; where the overlap is mostly such arcs (the +z / -y pair), a
    trimmed source fits a wrong pose as well as the right one."""
    rng = np.random.default_rng(12)
    tgt = curve(rng, rng.uniform(0.0, 4.5, size=3 * n_target), HARD_NOISE)
    src = curve(rng, rng.uniform(0.0, 4.5, size=3 * n_source), HARD_NOISE)
    mu = tgt.mean(axis=0)
    tgt = tgt[(tgt - mu) @ np.asarray(normals[0], np.float32) > 0]
    src = src[(src - mu) @ np.asarray(normals[1], np.float32) > 0]
    tgt = tgt[rng.choice(len(tgt), size=min(n_target, len(tgt)),
                         replace=False)]
    src = src[rng.choice(len(src), size=min(n_source, len(src)),
                         replace=False)]
    span = float(np.ptp(np.concatenate([tgt, src]), axis=0).max())
    t = np.array([0.11, -0.07, 0.05], np.float32) * span
    return tgt, ((src - t) @ TURNTABLE).astype(np.float32), TURNTABLE, t, span


def skull_synth():
    """chip_smoke.py's serving cloud: SKULL_POINTS points of the curve at
    noise SKULL_NOISE (seed 9), the skull scan's stand-in."""
    rng = np.random.default_rng(9)
    return curve(rng, rng.uniform(0.0, 4.5, size=(SKULL_POINTS,)),
                 SKULL_NOISE)


def random_rotation(rng):
    """A random rotation by QR, as bench.py's serving lines draw it.  Not
    uniform: it fixes Q's column signs by Q's own diagonal, not R's
    (portbench/gen.py keeps the repaired copy); chip_smoke.py's serving
    thresholds were calibrated on the views it draws."""
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    R = (q * np.sign(np.diag(q))[None, :]).astype(np.float32)
    if np.linalg.det(R) < 0:
        R[:, 0] *= -1
    return R


def serving_data():
    """chip_smoke.py's serving inputs, a stand-in for the JAX bench's
    serving lines (bench.py::bench_serving): `skull_synth`'s cloud, a
    6,000-point target drawn from it, 32 sources of 8,000 points at
    `random_rotation`s and translations up to +-0.25 span, and 8 ragged
    half-space partial views of 3,000 to 6,000 points at random poses.
    A dict: pct, span, sources [32, 8000, 3], truth [(R, t)], views,
    view_truth."""
    cloud = skull_synth()
    rng = np.random.default_rng(11)
    pct = cloud[rng.choice(len(cloud), size=6000, replace=False)]
    span = float(np.ptp(cloud, axis=0).max())

    def moved(points, rng):
        R = random_rotation(rng)
        t = rng.uniform(-0.25, 0.25, size=3).astype(np.float32) * span
        return (points - t) @ R, (R, t)

    batch = [moved(cloud[rng.choice(len(cloud), size=8000, replace=False)],
                   rng) for _ in range(32)]
    rng2 = np.random.default_rng(23)
    mu = cloud.mean(axis=0)
    views = []
    for _ in range(8):
        nrm = rng2.normal(size=3)
        nrm /= np.linalg.norm(nrm)
        part = cloud[(cloud - mu) @ nrm > 0]
        n = min(len(part), int(rng2.integers(3000, 6001)))
        views.append(moved(part[rng2.choice(len(part), size=n,
                                            replace=False)], rng2))
    return dict(pct=pct, span=span,
                sources=np.stack([s for s, _ in batch]),
                truth=[p for _, p in batch], views=[v for v, _ in views],
                view_truth=[p for _, p in views])


def need_data(what: str, data: str) -> None:
    """Refuse a real-scan run without the reference's data directory."""
    if not data or not os.path.isdir(data):
        raise SystemExit(
            f"{what} reads the reference's real scans: pass --data DIR, the "
            f"reference's data/ directory (not found: "
            f"{data or 'no --data given'})")


def load(name: str, data: str = "", scale: float = 1.0):
    """(pct, pcs, mse_threshold, trim_fraction) of a workload; `scale`
    shrinks the synthetic ones' point counts (tests run them tiny)."""
    n = lambda k: max(16, int(k * scale))
    if name == "bunny_synth":
        pct, pcs = bunny_synth(n(18000), n(3000))
        return pct, pcs, 1e-3, 0.0
    if name == "smoke":
        pct, pcs = smoke_pair(n(24000), n(18000), n(3000))[:2]
        return pct, pcs, 1e-3, 0.0
    if name == "trimmed":
        pct, pcs = trimmed_pair(n(20000), n(10000))[:2]
        return pct, pcs, 1e-3, 0.3
    if name not in REAL:
        raise SystemExit(f"unknown workload {name!r} (one of {NAMES})")
    need_data(f"workload {name!r} (the synthetic workloads {SYNTHETIC} "
              f"need no data)", data)
    from ..io import load_cloud
    if name == "bunny":
        return (load_cloud(f"{data}/bunny/model_bunny.txt", 0.5, seed=0),
                load_cloud(f"{data}/bunny/data_bunny.txt", 0.1, seed=1),
                1e-3, 0.0)
    if name == "scan_pair":
        return (load_cloud(f"{data}/bunny/bun000.ply", 0.5, seed=0),
                load_cloud(f"{data}/bunny/bun045.ply", 0.25, seed=1),
                1e-4, 0.3)
    return (load_cloud(f"{data}/dragon/dragonClearSpace2_0.ply", 0.1, seed=0),
            load_cloud(f"{data}/dragon/dragonToes3_0.ply", 0.05, seed=1),
            1e-3, 0.3)
